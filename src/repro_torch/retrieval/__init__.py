from repro_torch.retrieval.embedding import HashEmbedder
from repro_torch.retrieval.vectorstore import (Partition, SearchStats,
                                               VectorStore)
from repro_torch.retrieval.cache import HotPartitionSet, PartitionCache
from repro_torch.retrieval.streamer import PartitionStreamer

__all__ = ["HashEmbedder", "HotPartitionSet", "Partition", "SearchStats",
           "VectorStore", "PartitionCache", "PartitionStreamer"]
