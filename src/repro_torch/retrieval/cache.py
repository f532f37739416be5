"""Partition residency tiers: the host LRU cache and the device hot set.

``PartitionCache`` keeps at most ``target`` partitions in RAM with LRU
eviction; the target is adjusted by the placement optimizer between
retrieval batches ("lazy" transfer: loads/releases happen at batch
boundaries, §5).

``HotPartitionSet`` is the tier above: the hottest partitions (by the
decayed probe counts in ``SearchStats``) are promoted to device-resident
tensors and scored on-device by ``VectorStore.sweep_boards`` —
skipping the disk load *and* the host matmul.  Its byte budget is not a
knob of its own: the placement optimizer's device-byte market
(``PlacementOptimizer.market``) carves it out of the same pool that
funds live KV pages and the prefix cache, so promoting a partition
literally costs generation pages.
"""
from __future__ import annotations

import collections
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.obs.metrics import NULL_REGISTRY
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.retrieval.vectorstore import SearchStats, VectorStore


class PartitionCache:
    def __init__(self, store: VectorStore, target: int):
        self.store = store
        self.target = max(0, target)
        self.lru: Deque[int] = collections.deque()
        for pid in store.resident_set():
            self.lru.append(pid)
        self._trim()

    def set_target(self, target: int) -> None:
        """Adjust resident count (called between batches — lazy transfer)."""
        self.target = max(0, target)
        self._trim()

    def _trim(self) -> None:
        while len(self.lru) > self.target:
            pid = self.lru.popleft()
            self.store.release(pid)

    def touch(self, pid: int, stats: Optional[SearchStats] = None) -> float:
        """Ensure pid is loadable by the caller; returns load seconds
        (0 on a residency hit).

        ``target == 0`` means *no host-cache bytes*: the partition is
        loaded for the caller's immediate use but released right away,
        never retained above budget (the device-byte market relies on a
        zeroed tier actually holding nothing).  Hits and misses are
        recorded into ``stats`` so ``hit_rate_plan`` can be checked
        against observed behaviour instead of dead reckoning.
        """
        dt = 0.0
        if pid in self.lru:
            self.lru.remove(pid)
            if stats:
                stats.add(cache_hits=1)
        else:
            dt = self.store.load(pid)
            if stats:
                stats.add(cache_misses=1)
            self._make_room()
        if self.target <= 0:
            self.store.release(pid)
            return dt
        self.lru.append(pid)
        return dt

    def _make_room(self) -> None:
        # leave room for the incoming partition; the target==0 case is
        # handled by ``touch`` itself (transient load, immediate release)
        while self.lru and len(self.lru) > self.target - 1:
            pid = self.lru.popleft()
            self.store.release(pid)

    def resident(self) -> List[int]:
        return list(self.lru)

    def hit_rate_plan(self, pids: List[int]) -> float:
        hits = sum(1 for p in pids if p in self.lru)
        return hits / max(len(pids), 1)


class HotPartitionSet:
    """Device-resident tier over the hottest IVF partitions.

    Partition state machine (see docs/architecture.md)::

        spilled (.npy)  ──load──▶  host-resident  ──promote──▶  device-hot
               ◀──release──                  ◀──demote──

    Promotion uploads the partition's float32 embedding matrix and its
    ``doc_ids`` as tensors on ``device`` (CUDA unless the caller asks for
    the CPU); the host copy is released right after the upload when the
    promotion itself loaded it (try/finally, as in ``sweep_boards``: a
    promotion can never leak host residency).
    ``sweep_boards`` scores promoted partitions with the same
    ``ops.retrieval_topk`` the host path uses on the same float32 bits,
    so results are bit-identical to a cold sweep.

    ``retarget`` re-arbitrates membership under the byte grant handed
    down by the device-memory market: hottest-first greedy fit, demote
    everything not kept.  A store ``layout_version`` bump (recluster /
    rebuild) invalidates every promoted array — the pids no longer name
    the same rows.
    """

    def __init__(self, store: VectorStore, byte_budget: int = 0,
                 eligible: Optional[Sequence[int]] = None,
                 device: DeviceLike = None, tracer=None, registry=None):
        self.store = store
        self.device = resolve_device(device)
        self.byte_budget = int(byte_budget)
        # a sharded store hands each shard's hot set its own pid range so
        # one shard can never spend another shard's byte grant
        self.eligible = None if eligible is None else frozenset(eligible)
        self.tracer = tracer or NULL_TRACER
        self.registry = registry or NULL_REGISTRY
        self._dev: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.layout_version = store.layout_version
        self.promotions = 0
        self.demotions = 0

    def _count_demotions(self, n: int) -> None:
        self.demotions += n
        if n:
            self.registry.counter("hot.demotions").inc(n)

    def _sync_layout(self) -> None:
        if self.store.layout_version != self.layout_version:
            self._count_demotions(len(self._dev))
            self._dev.clear()
            self.layout_version = self.store.layout_version

    def __len__(self) -> int:
        self._sync_layout()
        return len(self._dev)

    def __contains__(self, pid: int) -> bool:
        return self.lookup(pid) is not None

    def pids(self) -> List[int]:
        self._sync_layout()
        return sorted(self._dev)

    def device_bytes(self) -> int:
        self._sync_layout()
        return sum(emb.numel() * emb.element_size()
                   for emb, _ in self._dev.values())

    def lookup(self, pid: int
               ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """Device ``(embeddings, doc_ids)`` for a promoted pid, else
        None.  Never touches disk."""
        self._sync_layout()
        return self._dev.get(pid)

    def retarget(self, byte_budget: int, ranking: Sequence[int]) -> None:
        """Re-arbitrate membership under ``byte_budget`` (the market's
        grant), promoting down ``ranking`` (hottest first) greedy
        first-fit and demoting everything that no longer makes the cut.
        """
        self._sync_layout()
        self.byte_budget = int(byte_budget)
        keep: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        spent = 0
        for pid in ranking:
            if self.eligible is not None and pid not in self.eligible:
                continue
            p = self.store.partitions.get(pid)
            if p is None or pid in keep:
                continue
            nbytes = p.nbytes
            if spent + nbytes > self.byte_budget:
                continue          # first-fit: a cooler, smaller pid may fit
            entry = self._dev.get(pid)
            if entry is None:
                entry = self._promote(pid)
            keep[pid] = entry
            spent += nbytes
        self._count_demotions(
            sum(1 for pid in self._dev if pid not in keep))
        self._dev = keep
        self.registry.gauge("hot.partitions").set(len(keep))
        self.registry.gauge("hot.bytes").set(spent)

    def _promote(self, pid: int) -> Tuple[torch.Tensor, torch.Tensor]:
        with self.tracer.span("hot.promote", pid=pid):
            p = self.store.partitions[pid]
            # read the array once: a policy boundary on another thread can
            # release the partition between a check and a second read
            emb, loaded_here = p.embeddings, False
            try:
                while emb is None:       # spilled, or released after a load
                    self.store.load(pid)
                    loaded_here = True
                    emb = p.embeddings
                dev = torch.from_numpy(emb).to(self.device)
                ids = torch.from_numpy(p.doc_ids).to(self.device)
            finally:
                if loaded_here:   # promotion never leaks host residency
                    self.store.release(pid)
        self.promotions += 1
        self.registry.counter("hot.promotions").inc()
        return dev, ids

    def clear(self) -> None:
        self._count_demotions(len(self._dev))
        self._dev.clear()
