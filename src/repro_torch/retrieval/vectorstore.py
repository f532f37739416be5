"""Partitioned vector store with a real disk tier and IVF pruning.

Ported from ``repro.retrieval.vectorstore``.  The database is split into
P k-means partitions (the numpy k-means is copied as is, so partitions
match the JAX package's exactly; ``recluster`` runs it again in place) or
P hash partitions (chunk i in partition i mod P); partitions stay host-resident in RAM or
spilled to disk as ``.npy`` files -- that is the offloading design.  A
search copies each swept partition to the store's device (from pinned
memory, ``non_blocking``) and scores it with ``ops.retrieval_topk``; the
``(Q, P, k)`` scoreboards and the probe mask stay on the device for
``ops.retrieval_topk_merge``, so a search synchronizes once, when its
``(Q, k)`` answer comes back.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.kernels import ops


@dataclass
class Partition:
    pid: int
    embeddings: Optional[np.ndarray]      # None when on disk
    doc_ids: np.ndarray                   # (N,) global chunk ids
    path: Optional[str] = None            # disk location when spilled
    nbytes_cached: Optional[int] = None   # byte size, pinned at spill/load

    @property
    def resident(self) -> bool:
        return self.embeddings is not None

    @property
    def nbytes(self) -> int:
        """Byte size of the embedding matrix.

        Cached: a spilled partition must not re-open its ``.npy`` with a
        fresh mmap handle on every call (the handle is only dropped at
        GC, so per-query size checks used to accumulate open maps).  A
        recluster/rebuild replaces ``Partition`` objects wholesale, so a
        ``layout_version`` bump can never serve a stale size.
        """
        if self.nbytes_cached is None:
            if self.embeddings is not None:
                self.nbytes_cached = int(self.embeddings.nbytes)
            else:
                self.nbytes_cached = int(
                    np.load(self.path, mmap_mode="r").nbytes)
        return self.nbytes_cached


@dataclass
class SearchStats:
    partitions_searched: int = 0
    partitions_loaded: int = 0
    partitions_pruned: int = 0            # skipped by IVF probe
    prefetched: int = 0                   # loads overlapped by the streamer
    load_seconds: float = 0.0
    search_seconds: float = 0.0
    hot_hits: int = 0                     # probes answered by the device tier
    cache_hits: int = 0                   # PartitionCache.touch residency hits
    cache_misses: int = 0
    # per-partition observations feeding hot/cold tiering: decayed probe
    # counts (recency-weighted popularity) and an EWMA of observed load
    # seconds.  Mutated from the retrieval worker thread while the policy
    # boundary reads rankings, hence the lock.
    hit_counts: Dict[int, float] = field(default_factory=dict,
                                         repr=False, compare=False)
    load_ewma: Dict[int, float] = field(default_factory=dict,
                                        repr=False, compare=False)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    # Scalar-counter fields, used by add()/merge()/snapshot()/reset().
    # One tuple so the aggregation API cannot drift from the field list.
    _SCALARS = ("partitions_searched", "partitions_loaded",
                "partitions_pruned", "prefetched", "load_seconds",
                "search_seconds", "hot_hits", "cache_hits", "cache_misses")

    def add(self, **deltas: float) -> None:
        """Locked increment of one or more scalar counters — the single
        write path for sweep/streamer/cache accounting (previously bare
        ``stats.x += n`` sprinkled across three modules, which races and
        drifts once multiple shard sweeps share a stats object)."""
        with self._lock:
            for name, dv in deltas.items():
                if name not in self._SCALARS:
                    raise AttributeError(f"unknown SearchStats counter "
                                         f"{name!r}")
                setattr(self, name, getattr(self, name) + dv)

    def merge(self, other: "SearchStats") -> None:
        """Fold another stats object into this one, conserving totals:
        scalar counters sum, per-partition probe counts sum, and load
        EWMAs take the other side's sample where both observed a
        partition (most-recent-wins matches record_load's 0.5/0.5 lean
        toward fresh observations)."""
        with other._lock:
            scalars = {n: getattr(other, n) for n in self._SCALARS}
            hits = dict(other.hit_counts)
            ewma = dict(other.load_ewma)
        with self._lock:
            for name, v in scalars.items():
                setattr(self, name, getattr(self, name) + v)
            for pid, c in hits.items():
                self.hit_counts[pid] = self.hit_counts.get(pid, 0.0) + c
            for pid, dt in ewma.items():
                prev = self.load_ewma.get(pid)
                self.load_ewma[pid] = dt if prev is None \
                    else 0.5 * prev + 0.5 * dt

    def snapshot(self) -> Dict[str, float]:
        """Locked point-in-time copy of the scalar counters plus the
        derived rates (JSON-safe; feeds MetricsRegistry sync)."""
        with self._lock:
            snap = {n: getattr(self, n) for n in self._SCALARS}
            searched = snap["partitions_searched"]
            c_hits, c_miss = snap["cache_hits"], snap["cache_misses"]
        snap["hot_hit_rate"] = snap["hot_hits"] / max(searched, 1)
        snap["cache_hit_rate"] = c_hits / max(c_hits + c_miss, 1)
        return snap

    def reset(self) -> None:
        """Zero the scalar counters; per-partition heat/EWMA state is
        kept (it is policy state aged by decay(), not accounting)."""
        with self._lock:
            for name in self._SCALARS:
                setattr(self, name, type(getattr(self, name))(0))

    def record_search(self, pid: int, weight: float = 1.0) -> None:
        """Bump the partition's probe count.  ``weight`` is the number of
        queries in the batch that probed it — per-query votes, not
        per-sweep visits, or a skewed workload whose every batch touches
        the whole union would look uniform to the hot ranking."""
        with self._lock:
            self.hit_counts[pid] = (self.hit_counts.get(pid, 0.0)
                                    + float(weight))

    def record_load(self, pid: int, dt: float) -> None:
        with self._lock:
            prev = self.load_ewma.get(pid)
            self.load_ewma[pid] = dt if prev is None else 0.5 * prev + 0.5 * dt

    def decay(self, factor: float = 0.5, floor: float = 1e-3) -> None:
        """Age the per-partition probe counts (called at policy
        boundaries) so the hot ranking tracks the *current* query skew;
        counts that decay below ``floor`` are dropped."""
        with self._lock:
            self.hit_counts = {pid: c * factor
                               for pid, c in self.hit_counts.items()
                               if c * factor >= floor}

    def _ranked(self) -> List[Tuple[int, float]]:
        with self._lock:
            items = list(self.hit_counts.items())
        items.sort(key=lambda kv: (-kv[1], kv[0]))
        return items

    def hot_ranking(self) -> List[int]:
        """Partition ids, hottest (most recently probed) first."""
        return [pid for pid, _ in self._ranked()]

    def heat(self) -> List[float]:
        """Decayed probe counts in ``hot_ranking`` order (the market's
        expected-hit-mass input)."""
        return [c for _, c in self._ranked()]

    @property
    def hot_hit_rate(self) -> float:
        return self.hot_hits / max(self.partitions_searched, 1)

    @property
    def cache_hit_rate(self) -> float:
        return self.cache_hits / max(self.cache_hits + self.cache_misses, 1)


def kmeans_centroids(embs: np.ndarray, k: int, iters: int = 10,
                     seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Plain Lloyd k-means (cosine-friendly: inputs are L2-normalized).

    Returns (centroids (k, D), assignment (N,)).  Empty clusters are
    reseeded from the points farthest from their current centroid so every
    partition stays non-empty (spill/load and the cache manager assume P
    live partitions).
    """
    n = embs.shape[0]
    k = min(k, n)
    rng = np.random.default_rng(seed)
    cent = embs[rng.choice(n, size=k, replace=False)].copy()
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        # nearest centroid by inner product (vectors are normalized)
        sim = embs @ cent.T                                   # (N, k)
        assign = sim.argmax(axis=1)
        dist = 1.0 - sim[np.arange(n), assign]
        for c in range(k):
            sel = assign == c
            if sel.any():
                cent[c] = embs[sel].mean(axis=0)
            else:
                assign[np.argmax(dist)] = c
                cent[c] = embs[np.argmax(dist)]
                dist[np.argmax(dist)] = -1.0
        norms = np.linalg.norm(cent, axis=1, keepdims=True)
        cent = cent / np.maximum(norms, 1e-12)
    return cent.astype(np.float32), assign




class VectorStore:
    """IVF-clustered (or hash-partitioned) store over host-resident
    corpus partitions.

    ``device`` is where partitions are scored (CUDA unless the caller
    asks for the CPU); the partitions themselves stay on the host.
    """

    def __init__(self, dim: int, num_partitions: int,
                 root: Optional[str] = None, device: DeviceLike = None):
        self.dim = dim
        self.num_partitions = num_partitions
        self.root = root
        self.device = resolve_device(device)
        self.partitions: Dict[int, Partition] = {}
        self.chunks: List[str] = []           # chunk texts by global id
        self.centroids: Optional[np.ndarray] = None   # (P, dim)
        # bumped whenever the partition layout changes; consumers caching
        # per-partition facts re-derive when it moves
        self.layout_version = 0

    # ------------------------------------------------------------- building
    @classmethod
    def build(cls, texts: Sequence[str], embedder, num_partitions: int,
              root: Optional[str] = None, partitioner: str = "kmeans",
              kmeans_iters: int = 10, seed: int = 0,
              device: DeviceLike = None) -> "VectorStore":
        if partitioner not in ("kmeans", "hash"):
            raise ValueError(f"unknown partitioner {partitioner!r}")
        store = cls(embedder.dim, num_partitions, root, device=device)
        store.chunks = list(texts)
        embs = embedder.embed(texts)
        ids = np.arange(len(texts))
        if partitioner == "kmeans":
            cent, assign = kmeans_centroids(embs, num_partitions,
                                            iters=kmeans_iters, seed=seed)
            store.num_partitions = cent.shape[0]
            store.centroids = cent
        else:                    # chunk i goes to partition i mod P
            assign = ids % num_partitions
        for pid in range(store.num_partitions):
            sel = assign == pid
            store.partitions[pid] = Partition(
                pid=pid, embeddings=embs[sel], doc_ids=ids[sel])
        if partitioner == "hash":
            store._centroids_from_partitions(embs)
        store.layout_version += 1
        return store

    def recluster(self, num_partitions: Optional[int] = None,
                  kmeans_iters: int = 10, seed: int = 0) -> None:
        """Run k-means over the whole corpus again, in place (the paper
        re-indexes the store as the corpus drifts).

        Spilled partitions are loaded for the pass and their spill files
        removed; every new partition comes out resident with no disk path
        (a later spill writes under the new ``layout_version``, so no
        file of the old layout is ever read again).  ``layout_version``
        is bumped, so the streamer, the partition cache and the hot set
        drop what they keyed by the old layout.
        """
        embs = np.zeros((len(self.chunks), self.dim), np.float32)
        for pid, p in self.partitions.items():
            if not p.resident:
                self.load(pid)
            embs[p.doc_ids] = p.embeddings
            if p.path is not None:        # superseded layout: no orphans
                with contextlib.suppress(FileNotFoundError):
                    os.remove(p.path)
        ids = np.arange(len(self.chunks))
        cent, assign = kmeans_centroids(
            embs, num_partitions or self.num_partitions,
            iters=kmeans_iters, seed=seed)
        self.num_partitions = cent.shape[0]
        self.centroids = cent
        self.partitions = {
            pid: Partition(pid=pid, embeddings=embs[assign == pid],
                           doc_ids=ids[assign == pid])
            for pid in range(self.num_partitions)}
        self.layout_version += 1

    def _centroids_from_partitions(self, embs: np.ndarray) -> None:
        """Unit-norm mean of each partition's rows (hash partitions)."""
        cent = np.zeros((self.num_partitions, self.dim), np.float32)
        for pid, p in self.partitions.items():
            if len(p.doc_ids):
                c = embs[p.doc_ids].mean(axis=0)
                cent[pid] = c / max(np.linalg.norm(c), 1e-12)
        self.centroids = cent

    # ------------------------------------------------------------ disk tier
    def spill(self, pid: int) -> None:
        """Move a partition to disk (frees RAM)."""
        p = self.partitions[pid]
        if not p.resident:
            return
        if self.root is None:
            raise ValueError("need a root dir to spill")
        os.makedirs(self.root, exist_ok=True)
        if p.path is None:
            path = os.path.join(
                self.root, f"part{pid}_v{self.layout_version}.npy")
            np.save(path, p.embeddings)
            p.path = path
        p.nbytes_cached = int(p.embeddings.nbytes)
        p.embeddings = None

    def load(self, pid: int) -> float:
        """Load a partition into RAM; returns wall seconds spent."""
        p = self.partitions[pid]
        if p.resident:
            return 0.0
        t0 = time.perf_counter()
        p.embeddings = np.load(p.path)
        p.nbytes_cached = int(p.embeddings.nbytes)
        return time.perf_counter() - t0

    def release(self, pid: int) -> None:
        p = self.partitions[pid]
        if p.resident and p.path is not None:
            p.embeddings = None
        elif p.resident:
            self.spill(pid)

    def resident_set(self) -> List[int]:
        return [pid for pid, p in self.partitions.items() if p.resident]

    def resident_bytes(self) -> int:
        """Host bytes of the partitions held in RAM."""
        return sum(p.embeddings.nbytes for p in self.partitions.values()
                   if p.resident)

    # ---------------------------------------------------------------- probe
    def probe(self, queries: np.ndarray, nprobe: int
              ) -> Tuple[List[int], np.ndarray]:
        """IVF pruning step (no disk I/O): each query keeps its ``nprobe``
        closest centroids; the sweep visits the union of probed partitions,
        most-probed first with resident ones ahead.  Returns (ordered union
        pids, (Q, P) bool probe mask)."""
        nq = queries.shape[0]
        if self.centroids is None or nprobe >= self.num_partitions:
            pids = list(self.partitions)
            qmask = np.ones((nq, self.num_partitions), bool)
        else:
            score = queries.astype(np.float32) @ self.centroids.T  # (Q, P)
            nprobe = max(nprobe, 1)
            top = np.argpartition(-score, nprobe - 1, axis=1)[:, :nprobe]
            qmask = np.zeros((nq, self.num_partitions), bool)
            qmask[np.arange(nq)[:, None], top] = True
            votes = qmask.sum(axis=0)
            rank = np.argsort(-(votes.astype(np.float64)
                                + 1e-3 * score.max(axis=0)), kind="stable")
            pids = [int(pid) for pid in rank if votes[pid] > 0]
        res = [pid for pid in pids if self.partitions[pid].resident]
        return (res + [pid for pid in pids if pid not in res]), qmask

    # --------------------------------------------------------------- search
    def search(self, queries: np.ndarray, top_k: int,
               partitions: Optional[Sequence[int]] = None,
               impl: Optional[str] = None,
               nprobe: Optional[int] = None,
               streamer=None,
               stats: Optional[SearchStats] = None,
               hot=None) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k across the probed partitions (default: all => exact).
        Returns (scores (Q, k), global chunk ids (Q, k)) as numpy."""
        nq = queries.shape[0]
        if nprobe is not None:
            pids, qmask = self.probe(queries, nprobe)
            if partitions is not None:
                keep = set(partitions)
                pids = [p for p in pids if p in keep]
                drop = [p for p in range(self.num_partitions)
                        if p not in keep]
                qmask[:, drop] = False
        else:
            pids = (list(partitions) if partitions is not None
                    else list(self.partitions))
            qmask = np.zeros((nq, self.num_partitions), bool)
            qmask[:, pids] = True
        if stats:
            stats.add(partitions_pruned=self.num_partitions - len(pids))

        board_s, board_i, searched = self.sweep_boards(
            queries, pids, top_k, impl=impl, streamer=streamer, stats=stats,
            hot=hot, qmask=qmask)
        mask = torch.from_numpy(qmask & searched[None, :]).to(self.device)
        scores, gids = ops.retrieval_topk_merge(board_s, board_i, mask, top_k,
                                                impl=impl)
        return scores.cpu().numpy(), gids.cpu().numpy()

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            # pinned staging lets the copy run async; the caching host
            # allocator keeps the pinned block until the copy lands
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def sweep_boards(self, queries: np.ndarray, pids: Sequence[int],
                     top_k: int, impl: Optional[str] = None,
                     streamer=None, stats: Optional[SearchStats] = None,
                     hot=None, qmask: Optional[np.ndarray] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
        """Per-partition top-k sweep over ``pids`` without the merge.

        Returns fixed-shape ``(Q, P, k)`` score/id scoreboards on the
        device plus the ``(P,)`` host searched mask.  Unfilled scoreboard
        entries carry the ``-1`` sentinel id at -1e30.  Partitions
        promoted into ``hot`` are scored from their device copies; every
        other partition is copied to the device for its sweep, and any
        partition this sweep loads from disk is released again, even if a
        kernel raises (try/finally).
        """
        nq = queries.shape[0]
        dev = self.device
        q = torch.from_numpy(
            np.ascontiguousarray(queries, dtype=np.float32)).to(dev)
        board_s = torch.full((nq, self.num_partitions, top_k), ops.NEG_INF,
                             dtype=torch.float32, device=dev)
        board_i = torch.full((nq, self.num_partitions, top_k), -1,
                             dtype=torch.int32, device=dev)
        searched = np.zeros(self.num_partitions, bool)

        def heat_w(pid: int) -> float:
            return (float(qmask[:, pid].sum()) if qmask is not None
                    else 1.0)

        def score(pid: int, emb: torch.Tensor, ids: torch.Tensor) -> None:
            k_eff = min(top_k, int(emb.shape[0]))
            if k_eff > 0:
                s, i = ops.retrieval_topk(q, emb, k_eff, impl=impl)
                board_s[:, pid, :k_eff] = s
                board_i[:, pid, :k_eff] = ids[i.long()].to(torch.int32)
            searched[pid] = True

        hot_entries = {}
        if hot is not None:
            for pid in pids:
                entry = hot.lookup(pid)
                if entry is not None:
                    hot_entries[pid] = entry
        for pid, (dev_emb, dev_ids) in hot_entries.items():
            t0 = time.perf_counter()
            score(pid, dev_emb, dev_ids)
            if stats:
                stats.add(search_seconds=time.perf_counter() - t0,
                          partitions_searched=1, hot_hits=1)
                stats.record_search(pid, heat_w(pid))
        cold_pids = [pid for pid in pids if pid not in hot_entries]

        def sweep():
            if streamer is not None:
                yield from streamer.stream(cold_pids, stats=stats)
            else:
                for pid in cold_pids:
                    p = self.partitions[pid]
                    loaded_here = False
                    if not p.resident:
                        dt = self.load(pid)
                        loaded_here = True
                        if stats:
                            stats.add(partitions_loaded=1,
                                      load_seconds=dt)
                            stats.record_load(pid, dt)
                    yield pid, loaded_here

        loaded_pending: set = set()
        try:
            for pid, loaded_here in sweep():
                p = self.partitions[pid]
                # read the array once: a policy boundary on another thread
                # can release the partition between a check and a second
                # read, and again right after a reload
                emb = p.embeddings
                while emb is None:            # raced with a cache release
                    dt = self.load(pid)
                    loaded_here = True
                    if stats:
                        stats.add(partitions_loaded=1, load_seconds=dt)
                        stats.record_load(pid, dt)
                    emb = p.embeddings
                if loaded_here:
                    loaded_pending.add(pid)
                t0 = time.perf_counter()
                score(pid, self._to_device(emb), self._to_device(p.doc_ids))
                if stats:
                    stats.add(search_seconds=time.perf_counter() - t0,
                              partitions_searched=1)
                    stats.record_search(pid, heat_w(pid))
                if loaded_here:
                    self.release(pid)
                    loaded_pending.discard(pid)
        finally:
            for pid in loaded_pending:        # aborted sweep: no leaks
                self.release(pid)
        return board_s, board_i, searched

    def get_chunks(self, ids: np.ndarray) -> List[List[str]]:
        """Chunk texts for a (Q, k) id matrix; ``-1`` sentinel entries are
        skipped rather than aliased to chunk 0."""
        return [[self.chunks[j] for j in row if j >= 0] for row in ids]

    def partition_bytes(self) -> int:
        """Nominal per-partition size (max over partitions)."""
        return max(p.nbytes for p in self.partitions.values())
