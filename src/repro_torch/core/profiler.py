"""Active profiling (paper §4.4, offline step).

Iteratively explores the configuration space — generation batch size x
joint placement — to balance the two pipelines: since retrieval cost is
dominated by partition loading and nearly constant in retrieval batch size,
the search is focused on the generation batch (the paper's simplification),
with the placement re-solved per candidate batch under Eq. 2–3.

``measure`` defaults to the cost model but accepts a callable doing *real*
measurements (the mini end-to-end engine uses that path in tests), so the
same profiler drives both the simulator and the live system.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.placement import Placement, PlacementOptimizer


@dataclass
class ProfileResult:
    placements: Dict[int, Placement]              # per batch size
    gen_samples: List[Tuple[float, float]]        # (B, t_gen)
    ret_samples: List[Tuple[float, float]]        # (B, t_ret)
    best_batch: int

    @property
    def best_placement(self) -> Placement:
        return self.placements[self.best_batch]


class ActiveProfiler:
    def __init__(self, opt: PlacementOptimizer,
                 batches: Sequence[int] = (4, 8, 16, 32, 64, 128)):
        self.opt = opt
        self.batches = tuple(batches)

    def profile(self,
                measure: Optional[Callable[[Placement],
                                           Tuple[float, float]]] = None
                ) -> ProfileResult:
        placements: Dict[int, Placement] = {}
        gen_s, ret_s = [], []
        best_b, best_score = self.batches[0], float("inf")
        for b in self.batches:
            p = self.opt.solve(b)
            if p.gen_batch != b:       # infeasible at this batch; projected
                p = self.opt.project(
                    Placement(p.w_gpu, p.w_cpu, p.c_gpu, p.c_cpu,
                              p.resident_partitions, b, nprobe=p.nprobe))
                if not self.opt.feasible(p):
                    continue
            t_ret, t_gen = (measure(p) if measure is not None
                            else self.opt.pipeline_times(p))
            placements[b] = p
            gen_s.append((float(b), t_gen))
            ret_s.append((float(b), t_ret))
            score = max(t_ret, t_gen) / b       # balanced per-request cost
            if score < best_score:
                best_score, best_b = score, b
        if not placements:
            p = self.opt.solve(1)
            placements[1] = p
            best_b = 1
            t_ret, t_gen = self.opt.pipeline_times(p)
            gen_s.append((1.0, t_gen))
            ret_s.append((1.0, t_ret))
        return ProfileResult(placements=placements, gen_samples=gen_s,
                             ret_samples=ret_s, best_batch=best_b)
