"""Elastic scaling + straggler mitigation for the multi-pod deployment.

Copied from ``repro.ft.elastic`` (numpy only).

* ``ElasticMesh``: on host failures, rebuild the largest feasible
  (data, model) grid from surviving devices, report which mesh to use,
  the checkpoint to reload, and how DB partition residency rebalances
  across the surviving data shards.
* ``StragglerMonitor``: per-host EMA step times; hosts slower than
  ``factor`` x median are flagged.  In RAGDoll the *backlog-aware
  scheduler is itself the mitigation* — a slow replica simply pulls
  smaller/fewer batches — so the monitor's output feeds the scheduler's
  max_batch per replica, plus an optional backup-dispatch rule for
  work stuck > p99.
"""
from __future__ import annotations

import math
import statistics
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices_used: int
    restore_step: Optional[int]
    partition_assignment: Dict[int, List[int]]   # data_shard -> partitions


class ElasticMesh:
    """Largest-feasible-grid policy: keep the model axis intact (TP must
    match the checkpointed layout), shrink the data axis; drop to single
    pod if a whole pod dies."""

    def __init__(self, model_parallel: int, num_partitions: int):
        self.tp = model_parallel
        self.num_partitions = num_partitions

    def plan(self, total_devices: int, failed_devices: int,
             restore_step: Optional[int] = None,
             multi_pod: bool = False) -> ElasticPlan:
        alive = total_devices - failed_devices
        if alive < self.tp:
            raise RuntimeError(
                f"cannot keep TP={self.tp} with {alive} devices")
        dp = alive // self.tp
        # power-of-two data axis keeps collectives balanced
        dp = 2 ** int(math.log2(dp)) if dp > 0 else 1
        if multi_pod and dp % 2 == 0 and dp >= 4:
            shape = (2, dp // 2, self.tp)
            names = ("pod", "data", "model")
        else:
            shape = (dp, self.tp)
            names = ("data", "model")
        assignment = self.rebalance_partitions(dp)
        return ElasticPlan(mesh_shape=shape, axis_names=names,
                           devices_used=dp * self.tp,
                           restore_step=restore_step,
                           partition_assignment=assignment)

    def rebalance_partitions(self, data_shards: int
                             ) -> Dict[int, List[int]]:
        """Round-robin partitions across surviving data shards."""
        out: Dict[int, List[int]] = {i: [] for i in range(data_shards)}
        for pid in range(self.num_partitions):
            out[pid % data_shards].append(pid)
        return out


@dataclass
class StragglerMonitor:
    ema_alpha: float = 0.3
    factor: float = 1.5
    times: Dict[str, float] = field(default_factory=dict)

    def observe(self, host: str, seconds: float) -> None:
        prev = self.times.get(host)
        self.times[host] = (seconds if prev is None else
                            self.ema_alpha * seconds
                            + (1 - self.ema_alpha) * prev)

    def median(self) -> float:
        return statistics.median(self.times.values()) if self.times else 0.0

    def stragglers(self) -> List[str]:
        med = self.median()
        if med <= 0:
            return []
        return [h for h, t in self.times.items() if t > self.factor * med]

    def batch_scale(self, host: str) -> float:
        """Scheduler hook: scale a slow replica's max batch down so the
        backlog-aware batching absorbs the straggler."""
        med = self.median()
        t = self.times.get(host, med)
        if med <= 0 or t <= 0:
            return 1.0
        return min(1.0, med / t)

    def should_backup_dispatch(self, host: str, elapsed: float) -> bool:
        """Re-dispatch work stuck beyond 3x its host's EMA."""
        t = self.times.get(host, self.median())
        return t > 0 and elapsed > 3.0 * t
