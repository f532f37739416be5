"""Backlog-aware batch scheduling (paper §4.4, Eq. 4–8).

Processing time is modeled as T(B) = a * B^c (Eq. 4).  For a backlog of n
requests split into k equal batches, average latency is

    L_k = (k+1)/2 * T(n/k) - mean(arrival offsets)       (Eq. 6)

so one max-size batch is optimal iff 2*k^c <= k+1 (Eq. 7) — e.g. for k=2,
c <= log2(3/2) ~ 0.585 (Eq. 8).  The scheduler fits (a, c) online from
measured (batch, time) samples (seeded by active profiling) and picks the
batch size minimizing predicted average latency for the *current* backlog.
Retrieval and generation pipelines each get their own scheduler instance
because they scale differently (retrieval ~ constant, generation
superlinear under memory pressure).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


def fit_power_law(samples: Sequence[Tuple[float, float]]
                  ) -> Tuple[float, float]:
    """Least-squares fit of T(B) = a * B^c in log space.

    Returns (a, c); c clamped to >= 0 (processing time can't shrink with
    batch size), a > 0.
    """
    pts = [(b, t) for b, t in samples if b > 0 and t > 0]
    if not pts:
        return 1.0, 1.0
    if len(pts) == 1:
        b, t = pts[0]
        return t / b, 1.0
    n = len(pts)
    sx = sum(math.log(b) for b, _ in pts)
    sy = sum(math.log(t) for _, t in pts)
    sxx = sum(math.log(b) ** 2 for b, _ in pts)
    sxy = sum(math.log(b) * math.log(t) for b, t in pts)
    denom = n * sxx - sx * sx
    if abs(denom) < 1e-12:
        b, t = pts[-1]
        return t / b, 1.0
    c = (n * sxy - sx * sy) / denom
    c = max(c, 0.0)
    a = math.exp((sy - c * sx) / n)
    return a, c


def power_time(a: float, c: float, b: int) -> float:
    return a * (b ** c)


def batch_avg_latency(n: int, k: int, a: float, c: float) -> float:
    """Eq. 6 (dropping the shared arrival-offset term): average latency of
    n backlogged requests processed as k equal batches of n/k."""
    return (k + 1) / 2.0 * power_time(a, c, max(n // k, 1))


def max_batch_optimal(c: float, k: int = 2) -> bool:
    """Eq. 7: single max batch beats k-way split iff 2*k^c <= k+1."""
    return 2.0 * (k ** c) <= k + 1


@dataclass
class BacklogScheduler:
    """Online batch-size selection from the fitted cost curve."""

    max_batch: int
    candidates: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128)
    min_samples: int = 2
    samples: List[Tuple[float, float]] = field(default_factory=list)
    a: float = 1.0
    c: float = 1.0
    window: int = 64

    def seed(self, samples: Sequence[Tuple[float, float]]) -> None:
        """Seed with active-profiling measurements (offline step)."""
        self.samples.extend(samples)
        self._refit()

    def observe(self, batch: int, seconds: float) -> None:
        self.samples.append((float(batch), float(seconds)))
        if len(self.samples) > self.window:
            self.samples = self.samples[-self.window:]
        self._refit()

    def _refit(self) -> None:
        if len(self.samples) >= self.min_samples:
            self.a, self.c = fit_power_law(self.samples)

    def predict(self, batch: int) -> float:
        return power_time(self.a, self.c, batch)

    def choose_batch(self, backlog: int) -> int:
        """Pick batch size minimizing predicted average latency (Eq. 5–6)."""
        if backlog <= 0:
            return 0
        n = min(backlog, self.max_batch * 8)
        best_b, best_l = 1, float("inf")
        cands = sorted({min(cand, self.max_batch, backlog)
                        for cand in self.candidates if cand > 0}
                       | {min(backlog, self.max_batch)})
        for b in cands:
            k = math.ceil(n / b)
            l = batch_avg_latency(n, k, self.a, self.c)
            if l < best_l - 1e-12:
                best_l, best_b = l, b
        return best_b
