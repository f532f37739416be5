from repro_torch.ft.faults import (CheckpointedRetrieval, OOMRecovery,
                                   retry_with_backoff)

__all__ = ["CheckpointedRetrieval", "OOMRecovery", "retry_with_backoff"]
