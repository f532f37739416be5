from repro_torch.retrieval.embedding import HashEmbedder
from repro_torch.retrieval.vectorstore import (Partition, SearchStats,
                                               VectorStore)
from repro_torch.retrieval.cache import HotPartitionSet, PartitionCache
from repro_torch.retrieval.streamer import PartitionStreamer

__all__ = ["HashEmbedder", "HotPartitionSet", "Partition", "SearchStats",
           "VectorStore", "PartitionCache", "PartitionStreamer",
           "ShardedIVFStore"]


def __getattr__(name):
    # ShardedIVFStore pulls in torch.distributed; keep the package import
    # light for consumers that only need the host-side store
    if name == "ShardedIVFStore":
        from repro_torch.retrieval.distributed import ShardedIVFStore
        return ShardedIVFStore
    raise AttributeError(name)
