# RAGDoll's scheduling core: backlog-aware batch scheduling, the
# decoupled pipeline workers and the prefetch-queue policy.
from repro_torch.core.prefetch import PrefetchPolicy
from repro_torch.core.scheduler import (BacklogScheduler, batch_avg_latency,
                                        fit_power_law)

__all__ = ["BacklogScheduler", "fit_power_law", "batch_avg_latency",
           "PrefetchPolicy"]
