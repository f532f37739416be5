"""Fault tolerance (paper §5): checkpointed retrieval + OOM recovery ladder.

Ported from ``repro.ft.faults``.  The port's ladder recognises an
out-of-memory error by its type: ``torch.OutOfMemoryError`` (what a CUDA
allocation that the card cannot hold raises) or ``MemoryError``; every
other ``RuntimeError`` propagates.

* Retrieval checkpoints intermediate per-partition results; a failure
  resumes from the last completed partition instead of restarting the
  whole sweep.
* Generation OOM triggers the recovery ladder (demote KV -> demote
  weights -> release partitions -> shrink batch) via
  ``PlacementOptimizer.project`` — never a full restart.  The demoted
  ``c_gpu``→``c_cpu`` KV shift is consumed by the paged generator's
  page pools (``OOMRecovery.apply_placement``): the device budget
  shrinks and the host swap pool grows, so degraded placements preempt
  (swap-to-host) instead of starving joins.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.placement import Placement, PlacementOptimizer


def retry_with_backoff(retries: int = 3, base_delay: float = 0.01,
                       exceptions=(RuntimeError, MemoryError)):
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            delay = base_delay
            for attempt in range(retries + 1):
                try:
                    return fn(*a, **kw)
                except exceptions:
                    if attempt == retries:
                        raise
                    time.sleep(delay)
                    delay *= 2
        return wrapped
    return deco


class CheckpointedRetrieval:
    """Per-partition checkpointing around VectorStore.search.

    ``fault_hook(pid)`` (tests) may raise to simulate a mid-sweep failure;
    completed partitions are never recomputed on resume.
    """

    def __init__(self, store, fault_hook: Optional[Callable] = None):
        self.store = store
        self.fault_hook = fault_hook
        self._ckpt: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self.partitions_resumed = 0

    def search(self, queries: np.ndarray, top_k: int,
               max_attempts: int = 8) -> Tuple[np.ndarray, np.ndarray]:
        pids = sorted(self.store.partitions)
        attempt = 0
        while True:
            attempt += 1
            try:
                for pid in pids:
                    if pid in self._ckpt:
                        continue            # restored from checkpoint
                    if self.fault_hook is not None:
                        self.fault_hook(pid)
                    s, i = self.store.search(queries, top_k,
                                             partitions=[pid])
                    self._ckpt[pid] = (s, i)
                break
            except (RuntimeError, MemoryError):
                if attempt >= max_attempts:
                    raise
                self.partitions_resumed = len(self._ckpt)
                continue
        all_s = np.concatenate([self._ckpt[p][0] for p in pids], axis=1)
        all_i = np.concatenate([self._ckpt[p][1] for p in pids], axis=1)
        self._ckpt.clear()
        order = np.argsort(-all_s, axis=1)[:, :top_k]
        return (np.take_along_axis(all_s, order, axis=1),
                np.take_along_axis(all_i, order, axis=1))


@dataclass
class OOMRecovery:
    """Generation-side OOM ladder (paper §5).

    ``run(fn, placement)`` executes fn(placement); on OOM it demotes the
    placement one rung (more KV to host, then weights, then fewer resident
    partitions, then half the batch) and retries.  When a live paged
    generator is attached (``run(..., generator=...)`` or an explicit
    :meth:`apply_placement`), each demoted placement is pushed into its
    KV page pools, so the ladder's first rung — shifting KV from
    ``c_gpu`` to ``c_cpu`` — immediately funds swap-to-host headroom:
    page-starved joins preempt (swap out the lowest-priority slot)
    instead of starving.
    """

    opt: PlacementOptimizer
    max_attempts: int = 6
    history: List[Placement] = field(default_factory=list)

    def apply_placement(self, generator, placement: Placement
                        ) -> Dict[str, int]:
        """Push a (demoted) placement into a live paged generator.

        The device page budget retargets to the placement's ``c_gpu``
        KV share and the host swap pool to the ``c_cpu`` share — the
        consumer of the ladder's ``c_cpu += 0.25`` shift.  No-op for
        dense or non-paged generators.
        """
        if not getattr(generator, "paged", False):
            return {}
        ps = generator.page_size
        return generator.retarget(
            page_budget=self.opt.kv_page_budget(placement, ps),
            host_page_budget=self.opt.kv_host_page_budget(placement, ps))

    def demote(self, p: Placement) -> Placement:
        if p.c_gpu > 0:
            q = dataclasses.replace(p, c_gpu=max(p.c_gpu - 0.25, 0.0),
                                    c_cpu=min(p.c_cpu + 0.25, 1.0))
        elif p.w_gpu > 0:
            q = dataclasses.replace(p, w_gpu=max(p.w_gpu - 0.15, 0.0),
                                    w_cpu=min(p.w_cpu + 0.15, 1.0))
        elif p.resident_partitions > 0:
            q = dataclasses.replace(
                p, resident_partitions=p.resident_partitions // 2)
        elif p.gen_batch > 1:
            q = dataclasses.replace(p, gen_batch=p.gen_batch // 2)
        else:
            q = p
        return self.opt.project(q)

    def run(self, fn: Callable[[Placement], object], placement: Placement,
            generator=None):
        p = placement
        for attempt in range(self.max_attempts):
            try:
                return fn(p), p
            except (torch.OutOfMemoryError, MemoryError):
                self.history.append(p)
                q = self.demote(p)
                if q == p:
                    raise
                p = q
                if generator is not None:
                    # the demoted KV split takes effect immediately:
                    # less device pool, more swap headroom
                    self.apply_placement(generator, p)
        raise MemoryError("OOM recovery ladder exhausted")
