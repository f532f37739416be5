# RAGDoll's primary contribution: joint memory placement, backlog-aware
# batch scheduling, active profiling, and the prefetch-queue policy.
from repro_torch.core.costmodel import (H100_HOST, PF_HIGH, PF_LOW,
                                        CostModel, HardwareProfile,
                                        ModelProfile)
from repro_torch.core.placement import Placement, PlacementOptimizer
from repro_torch.core.prefetch import PrefetchPolicy
from repro_torch.core.scheduler import (BacklogScheduler, batch_avg_latency,
                                        fit_power_law)

__all__ = [
    "HardwareProfile", "ModelProfile", "CostModel", "PF_HIGH", "PF_LOW",
    "H100_HOST", "Placement", "PlacementOptimizer", "BacklogScheduler",
    "fit_power_law", "batch_avg_latency", "PrefetchPolicy",
]
