"""Asynchronous double-buffered partition streaming (paper §4.4 attack).

Partition loading dominates retrieval cost, yet a pruned IVF sweep spends
most of its wall clock *waiting* on ``np.load`` while the top-k kernel on
the previously loaded partition has the CPU/accelerator idle.  The
streamer overlaps the two: a background I/O thread reads the next
non-resident partition(s) from disk while the caller searches the current
one — the classic double buffer, generalized to a lookahead queue whose
depth is governed by the same :class:`~repro_torch.core.prefetch.PrefetchPolicy`
budget accounting the LLM layer-prefetch queue uses (bounded by free host
bytes / partition bytes, never less than one buffer ahead).

Thread discipline: the worker only performs ``np.load`` and returns the
array; all ``VectorStore`` mutation (installing embeddings, releasing
after search) happens on the caller's thread, so results are bit-identical
to the synchronous path.
"""
from __future__ import annotations

import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core.prefetch import PrefetchPolicy
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.retrieval.vectorstore import SearchStats, VectorStore


class PartitionStreamer:
    """Background loader that feeds ``VectorStore.search`` sweeps."""

    def __init__(self, store: VectorStore,
                 policy: Optional[PrefetchPolicy] = None,
                 free_bytes: float = float("inf"),
                 tracer=None):
        self.store = store
        self.tracer = tracer or NULL_TRACER
        # double buffer by default: one partition in flight while one is
        # being searched; a looser memory budget deepens the queue
        self.policy = policy or PrefetchPolicy(max_depth=2, prefill_depth=1)
        self.free_bytes = free_bytes
        self.last_depth: Optional[int] = None   # depth used most recently
        # lazy partition-size estimate, keyed on the store's layout
        # version: a rebuild/recluster changes partition sizes, so the
        # cached value must not survive it (stale sizes mis-derive the
        # lookahead depth)
        self._part_bytes: Optional[float] = None
        self._part_bytes_version: Optional[int] = None
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="partition-streamer")

    def set_budget(self, free_bytes: float) -> None:
        """Retarget the lookahead budget from the live placement's host
        headroom (called at policy boundaries; takes effect immediately,
        including for sweeps already in flight — ``stream`` re-derives the
        depth every iteration)."""
        self.free_bytes = free_bytes

    # ------------------------------------------------------------- budget
    def depth(self) -> int:
        """Lookahead bound from the prefetch budget (>= 1 buffer ahead)."""
        if self.free_bytes == float("inf"):
            # unbounded budget: partition size is irrelevant, and
            # store.partition_bytes() would stat every spilled .npy
            return max(1, self.policy.depth("decode", self.free_bytes, 1.0))
        version = getattr(self.store, "layout_version", None)
        if self._part_bytes is None or version != self._part_bytes_version:
            try:
                self._part_bytes = max(float(self.store.partition_bytes()),
                                       1.0)
            except ValueError:        # empty store
                self._part_bytes = 1.0
            self._part_bytes_version = version
        return max(1, self.policy.depth("decode", self.free_bytes,
                                        self._part_bytes))

    # ------------------------------------------------------------- stream
    def stream(self, pids: List[int],
               stats: Optional[SearchStats] = None
               ) -> Iterator[Tuple[int, bool]]:
        """Yield ``(pid, loaded_here)`` in the given order.

        By yield time the partition is resident; loads of later pids are
        already in flight on the I/O thread.  ``loaded_here`` tells the
        caller it owns the release (same contract as the sync path).

        Stats honesty (hot-tier promotion consumes these numbers): a
        load is charged to ``partitions_loaded``/``load_seconds`` only
        when its array is actually installed — a load that raced a
        concurrent loader is discarded *and* uncounted, because the
        racing loader already paid for it.  ``prefetched`` counts only
        loads submitted as *lookahead* (ahead of the sweep cursor when
        submitted): a load the caller immediately blocks on overlapped
        nothing, so it is a plain load, not a prefetch.
        """
        inflight: Dict[int, Optional[Tuple[Future, bool]]] = {}
        tracer = self.tracer
        # Trace-id scope is thread-local; capture the sweep's ids here so
        # load spans emitted on the I/O thread still tag the requests
        # whose sweep triggered them.
        trace_ids = list(tracer.current_scope()) if tracer.enabled else []

        def fetch(pid: int, path: str, lookahead: bool):
            with tracer.span("partition.load", pid=pid,
                             prefetch=lookahead, trace_ids=trace_ids):
                t0 = time.perf_counter()
                arr = np.load(path)
                return arr, time.perf_counter() - t0

        def ensure(idx: int, lookahead: bool) -> None:
            if idx >= len(pids) or idx in inflight:
                return
            p = self.store.partitions[pids[idx]]
            if p.resident:
                inflight[idx] = None
            else:
                try:
                    inflight[idx] = (self._pool.submit(fetch, pids[idx],
                                                       p.path, lookahead),
                                     lookahead)
                except RuntimeError:    # closed streamer: degrade to sync
                    inflight[idx] = None

        for j in range(len(pids)):
            # keep the queue full: current + `depth` lookahead; the depth
            # is re-derived every iteration so a placement change (via
            # ``set_budget``) resizes the lookahead mid-sweep
            depth = self.last_depth = self.depth()
            for ahead in range(j, min(j + depth + 1, len(pids))):
                ensure(ahead, lookahead=ahead > j)
            entry = inflight.pop(j)
            pid = pids[j]
            p = self.store.partitions[pid]
            if entry is None:
                yield pid, False
                continue
            fut, was_lookahead = entry
            arr, dt = fut.result()
            overlapped = p.resident       # raced with a concurrent load
            if not overlapped:
                p.embeddings = arr
                p.nbytes_cached = int(arr.nbytes)
                if stats:
                    stats.add(partitions_loaded=1, load_seconds=dt,
                              prefetched=int(was_lookahead))
                    stats.record_load(pid, dt)
            yield pid, not overlapped

    def close(self) -> None:
        self._pool.shutdown(wait=False)
