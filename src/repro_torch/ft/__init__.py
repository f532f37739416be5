from repro_torch.ft.faults import (CheckpointedRetrieval, OOMRecovery,
                                   retry_with_backoff)
from repro_torch.ft.elastic import ElasticMesh, StragglerMonitor

__all__ = ["CheckpointedRetrieval", "OOMRecovery", "retry_with_backoff",
           "ElasticMesh", "StragglerMonitor"]
