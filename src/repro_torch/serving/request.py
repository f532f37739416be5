"""Request lifecycle + end-to-end latency accounting (paper key metric).

Latency decomposition follows Table 1: *waiting* is all time a request
spends queued (before retrieval and between retrieval and generation);
*retrieval* and *generation* are the in-batch processing times.

Requests can legitimately carry partial timestamps: a request harvested
by EOS on the continuous path may finish before ``t_gen_start`` is
stamped, and anything still in flight at shutdown has trailing Nones.
The component properties return NaN for missing segments instead of
raising, and :func:`latency_table` averages only fully-timestamped
requests, reporting the rest under an ``incomplete`` count.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence


@dataclass
class Request:
    rid: int
    query: str
    arrival: float
    top_k: int = 5
    max_new_tokens: int = 32
    # scheduling class: higher outranks lower (1 = interactive,
    # 0 = batch).  Consumed by the request scheduler for admission
    # order, swap-victim selection and resume order; an aging rule
    # promotes long-waiting batch requests so they cannot starve.
    priority: int = 0

    retrieved: Optional[List[str]] = None
    prompt: Optional[str] = None
    output: Optional[str] = None

    t_ret_start: Optional[float] = None
    t_ret_end: Optional[float] = None
    t_gen_start: Optional[float] = None
    t_gen_end: Optional[float] = None

    # ------------------------------------------------------------- metrics
    @property
    def done(self) -> bool:
        return self.t_gen_end is not None

    @property
    def complete(self) -> bool:
        """All four pipeline timestamps stamped (latency decomposable)."""
        return None not in (self.t_ret_start, self.t_ret_end,
                            self.t_gen_start, self.t_gen_end)

    @property
    def latency(self) -> float:
        return _sub(self.t_gen_end, self.arrival)

    @property
    def waiting(self) -> float:
        return (_sub(self.t_ret_start, self.arrival)
                + _sub(self.t_gen_start, self.t_ret_end))

    @property
    def retrieval(self) -> float:
        return _sub(self.t_ret_end, self.t_ret_start)

    @property
    def generation(self) -> float:
        return _sub(self.t_gen_end, self.t_gen_start)


def _sub(a: Optional[float], b: Optional[float]) -> float:
    """None-safe difference: NaN when either endpoint is unstamped."""
    if a is None or b is None:
        return float("nan")
    return a - b


def percentile(xs: Sequence[float], p: float) -> float:
    if not xs:
        return float("nan")
    s = sorted(xs)
    k = (len(s) - 1) * p / 100.0
    lo, hi = math.floor(k), math.ceil(k)
    if lo == hi:
        return s[lo]
    return s[lo] + (s[hi] - s[lo]) * (k - lo)


def latency_table(reqs: Sequence[Request]) -> Dict[str, float]:
    done = [r for r in reqs if r.done and r.complete]
    incomplete = sum(1 for r in reqs if not (r.done and r.complete))
    if not done:
        return {"n": 0, "incomplete": incomplete}
    lat = [r.latency for r in done]
    return {
        "n": len(done),
        "incomplete": incomplete,
        "avg_latency": sum(lat) / len(lat),
        "avg_waiting": sum(r.waiting for r in done) / len(done),
        "avg_retrieval": sum(r.retrieval for r in done) / len(done),
        "avg_generation": sum(r.generation for r in done) / len(done),
        "p50": percentile(lat, 50), "p90": percentile(lat, 90),
        "p99": percentile(lat, 99), "max": max(lat),
    }
