"""Sharded IVF retrieval across the mesh's batch axes.

Ported from ``repro.retrieval.distributed``.

The shard/probe/merge contract
------------------------------

``ShardedIVFStore`` partitions a k-means-clustered :class:`VectorStore`
across ``num_shards`` retrieval shards.  Stage by stage:

* **Shard** -- each shard owns a *disjoint* subset of the IVF partitions,
  assigned centroid-aware (k-means over the partition centroids, then a
  balanced greedy fill), so that clusters close in embedding space land
  on the same shard.  Every shard is non-empty and the union covers all
  partitions exactly once.
* **Probe** -- the IVF probe runs once, globally, against the replicated
  centroids (``VectorStore.probe``); each shard then sweeps only *its
  own* probed partitions with its own
  :class:`~repro_torch.retrieval.streamer.PartitionStreamer` (a per-shard
  disk tier with a per-shard residency budget) and its own device-hot
  tier.
* **Merge** -- each shard fuses its ``(Q, P, k)`` scoreboards with
  ``ops.retrieval_topk_merge`` into a local ``(Q, k)`` board; the
  ``(Q, S, k)`` stack of those boards goes through the same merge under
  an all-true mask.  With a ``MeshContext`` whose batch axes span
  ``num_shards`` processes, process ``r`` sweeps shard ``r`` alone and
  one all-gather of the ``(Q, k)`` boards over the batch group precedes
  the merge (``sharded_topk_merge``): the multi-process counterpart of
  the reference's single-controller ``shard_map``.

The sweep calls the same per-partition kernels the single-host path
calls, and both merge stages only *select*, so ``ShardedIVFStore.search``
equals single-host ``VectorStore.search`` bit for bit at equal
``nprobe`` (but at exact score ties between distinct chunks, which the
two merge orders may rank differently).  Every board stays on the store's
device; the answer comes to the host once.

``distributed_topk`` is the exact (non-IVF) path: raw rows sharded over
the batch axes, each process holding and scoring only its own row shard
(``row_shard``).  Uneven
corpora are padded with rows that score ``NEG_INF`` through a validity
column (a padded row must never evict a real candidate, even when every
real score is negative).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels import ops
from repro_torch.obs.metrics import NULL_REGISTRY
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.retrieval.cache import HotPartitionSet
from repro_torch.retrieval.streamer import PartitionStreamer
from repro_torch.retrieval.vectorstore import (SearchStats, VectorStore,
                                               kmeans_centroids)
from repro_torch.sharding.specs import MeshContext

NEG_INF = -1e30


def _all_gather(out: torch.Tensor, inp: torch.Tensor,
                group: dist.ProcessGroup) -> None:
    """One all-gather into a stacked tensor: ``all_gather_single`` where
    this torch has it (it deprecates ``all_gather_into_tensor``)."""
    if hasattr(dist, "all_gather_single"):
        dist.all_gather_single(out, inp, group=group)
    else:
        dist.all_gather_into_tensor(out, inp, group=group)


def _gather_merge(local_s: torch.Tensor, local_i: torch.Tensor, k: int,
                  ctx: MeshContext, impl: Optional[str] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-gather every process's ``(S_local, Q, k)`` boards over the
    batch group (one collective: the scores' bits and the ids stacked as
    int32), then merge the ``(Q, S, k)`` result shard-major under an
    all-true mask."""
    s_loc, q, _ = local_s.shape
    pair = torch.stack([local_s.float().contiguous().view(torch.int32),
                        local_i.to(torch.int32)], dim=1)
    out = torch.empty((ctx.dp_size * s_loc,) + tuple(pair.shape[1:]),
                      dtype=torch.int32, device=pair.device)
    _all_gather(out, pair, ctx.batch_group)
    s_all = out[:, 0].contiguous().view(torch.float32).transpose(0, 1)
    i_all = out[:, 1].transpose(0, 1)                     # (Q, S, k)
    mask = torch.ones((q, s_all.shape[1]), dtype=torch.bool,
                      device=out.device)
    return ops.retrieval_topk_merge(s_all, i_all, mask, k, impl=impl)


# ===========================================================================
# Exact row-sharded search (kernel path)
# ===========================================================================

def _with_validity(rows: torch.Tensor, lo: int, n: int,
                   width: int) -> torch.Tensor:
    """``rows`` (global rows ``lo`` on) zero-padded to ``width`` rows, plus
    the validity column: 0 for a real row, ``NEG_INF`` past row ``n``."""
    pad = width - rows.shape[0]
    if pad:
        rows = torch.nn.functional.pad(rows, (0, 0, 0, pad))
    flag = (torch.arange(lo, lo + width, device=rows.device)
            >= n).to(rows.dtype)
    return torch.cat([rows, flag[:, None] * NEG_INF], dim=1)


def _with_queries_flag(queries: torch.Tensor) -> torch.Tensor:
    """The queries with the validity column's 1.0."""
    return torch.cat([queries, queries.new_ones((queries.shape[0], 1))],
                     dim=1)


def pad_for_row_shards(
    queries: torch.Tensor,    # (Q, D)
    database: torch.Tensor,   # (N, D)
    shards: int,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Pad the database to a multiple of ``shards`` rows so uneven corpora
    row-shard cleanly, with padded rows *guaranteed* to lose.

    Zero-padding alone is wrong: a padded row scores ``q @ 0 = 0``, which
    beats every real candidate with a negative score inside its shard's
    local top-k.  Instead both operands gain a validity column -- 1.0 per
    query, ``NEG_INF`` per padded row (0 per real row) -- so a padded
    row's score is ~NEG_INF while real rows' scores gain 0.0.  Returns
    ``(q_aug, db_aug, local_n)``.
    """
    n = database.shape[0]
    local_n = -(-n // shards)                     # ceil: uneven corpora ok
    return (_with_queries_flag(queries),
            _with_validity(database, 0, n, shards * local_n), local_n)


def row_shard(total_rows: int, ctx: MeshContext) -> Tuple[int, int]:
    """The rows ``[lo, hi)`` of a ``total_rows`` corpus that this process
    holds for ``distributed_topk``: ``ceil(N / S)`` a process, the last
    ones short (or empty) on an uneven corpus."""
    local_n = -(-total_rows // ctx.dp_size)
    lo = min(ctx.batch_rank * local_n, total_rows)
    return lo, min(lo + local_n, total_rows)


def distributed_topk(
    queries: torch.Tensor,    # (Q, D), the same on every process
    rows: torch.Tensor,       # (hi - lo, D): this process's row shard
    k: int,
    ctx: MeshContext,
    total_rows: int,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact search with the rows sharded over the batch axes.  Each
    process holds only its own rows, ``row_shard(total_rows, ctx)`` of
    the corpus (the reference's database sharded ``P(axes, None)``),
    pads them to ``ceil(N / S)`` with the validity column and scores them
    with ``ops.retrieval_topk``; one all-gather and the merge follow.
    Returns (scores (Q, k), global row indices (Q, k)) on every process;
    rows beyond the corpus (k > N) come back as ``(NEG_INF, -1)``
    sentinels, never as a padded row's index."""
    n = total_rows
    lo, hi = row_shard(n, ctx)
    if rows.shape[0] != hi - lo:
        raise ValueError(f"process {ctx.batch_rank} holds rows [{lo}, {hi})"
                         f" of {n}, got {rows.shape[0]}")
    local_n = -(-n // ctx.dp_size)
    db_aug = _with_validity(rows, ctx.batch_rank * local_n, n, local_n)
    s, i = ops.retrieval_topk(_with_queries_flag(queries), db_aug, k,
                              impl=impl)
    gi = i.to(torch.int32) + ctx.batch_rank * local_n
    # normalize sentinels exactly: pad rows (gi >= n) AND the local
    # kernel's own -1 tail (k > local rows) -- the latter would otherwise
    # alias to a real-looking global id on shards > 0
    valid = (i >= 0) & (gi < n)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    gi = torch.where(valid, gi, torch.full_like(gi, -1))
    return _gather_merge(s[None], gi[None], k, ctx, impl=impl)


# ===========================================================================
# Centroid-aware partition -> shard assignment
# ===========================================================================

def assign_partitions(centroids: Optional[np.ndarray], num_shards: int,
                      num_partitions: Optional[int] = None,
                      seed: int = 0) -> List[List[int]]:
    """Assign IVF partitions to shards: disjoint, covering, non-empty,
    balanced to within one partition, and centroid-aware.

    Shard anchors come from k-means over the partition centroids; each
    partition then greedily joins its highest-affinity anchor that still
    has capacity (``ceil(P / S)``), most-decisive partitions first, so
    nearby clusters co-locate.  A final pass steals one partition from
    the fullest shard for any shard left empty.  A store without
    centroids (only hand-built ones) gets a contiguous split.
    """
    if centroids is None:
        p_total = int(num_partitions or 0)
        num_shards = max(1, min(num_shards, p_total))
        bounds = np.linspace(0, p_total, num_shards + 1).astype(int)
        return [list(range(bounds[s], bounds[s + 1]))
                for s in range(num_shards)]
    p_total = centroids.shape[0]
    num_shards = max(1, min(num_shards, p_total))
    if num_shards == 1:
        return [list(range(p_total))]
    anchors, _ = kmeans_centroids(centroids, num_shards, iters=8, seed=seed)
    affinity = centroids.astype(np.float32) @ anchors.T       # (P, S)
    cap = -(-p_total // num_shards)
    # place the partitions with the largest best-vs-runner-up margin
    # first: they have the most to lose from spilling to a second choice
    ranked = np.sort(affinity, axis=1)
    margin = ranked[:, -1] - ranked[:, -2]
    shards: List[List[int]] = [[] for _ in range(num_shards)]
    for pid in np.argsort(-margin, kind="stable"):
        for sid in np.argsort(-affinity[pid], kind="stable"):
            if len(shards[sid]) < cap:
                shards[sid].append(int(pid))
                break
    for sid, members in enumerate(shards):    # non-empty guarantee
        if members:
            continue
        donor = max(range(num_shards), key=lambda s: len(shards[s]))
        steal = min(shards[donor], key=lambda p: affinity[p, donor])
        shards[donor].remove(steal)
        members.append(steal)
    return [sorted(s) for s in shards]


# ===========================================================================
# Cross-shard scoreboard fusion
# ===========================================================================

def sharded_topk_merge(
    shard_scores: torch.Tensor,   # (Q, S, k) per-shard local top-k boards
    shard_ids: torch.Tensor,      # (Q, S, k) matching global chunk ids
    k: int,
    ctx: MeshContext,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse per-shard boards over the batch group: process ``r`` holds
    shards ``[r * S/dp, (r + 1) * S/dp)``, one all-gather of those
    ``(S/dp, Q, k)`` boards and the merge give every process the global
    board.  Flattening is shard-major, as in the local merge."""
    per = shard_scores.shape[1] // ctx.dp_size
    if per * ctx.dp_size != shard_scores.shape[1]:
        raise ValueError(f"{shard_scores.shape[1]} shards over "
                         f"{ctx.dp_size} processes")
    lo = ctx.batch_rank * per
    return _gather_merge(shard_scores[:, lo:lo + per].transpose(0, 1),
                         shard_ids[:, lo:lo + per].transpose(0, 1), k, ctx)


class IVFShard:
    """One retrieval shard: a disjoint set of IVF partitions plus its own
    partition streamer (per-shard disk tier + residency budget) and its
    own device-hot tier (per-shard byte grant from the market)."""

    def __init__(self, sid: int, pids: Sequence[int],
                 streamer: Optional[PartitionStreamer],
                 hot: Optional[HotPartitionSet] = None):
        self.sid = sid
        self.pids = list(pids)
        self.pid_set = frozenset(pids)
        self.streamer = streamer
        self.hot = hot

    def __repr__(self) -> str:
        return f"IVFShard({self.sid}, pids={self.pids})"


class ShardedIVFStore:
    """IVF-pruned search over a ``VectorStore`` sharded across retrieval
    shards.

    See the module docstring for the shard/probe/merge contract.  In one
    process the shards are swept serially, for determinism (the cost
    model prices the parallel deployment, including the per-shard load
    bandwidth and the cross-shard all-gather); with ``ctx`` spanning
    ``num_shards`` processes each process sweeps its own shard and the
    boards are all-gathered.
    """

    def __init__(self, store: VectorStore, num_shards: int,
                 policy=None, free_bytes: float = float("inf"),
                 ctx: Optional[MeshContext] = None,
                 use_streamers: bool = True, seed: int = 0,
                 tracer=None, registry=None):
        self.store = store
        self.ctx = ctx
        self.tracer = tracer or NULL_TRACER
        self.registry = registry or NULL_REGISTRY
        self.assignment = assign_partitions(
            store.centroids, num_shards,
            num_partitions=store.num_partitions, seed=seed)
        self.num_shards = len(self.assignment)
        self.shards = [
            IVFShard(sid, pids,
                     PartitionStreamer(store, policy,
                                       free_bytes=free_bytes,
                                       tracer=self.tracer)
                     if use_streamers else None,
                     # inert (budget 0) until the market grants bytes;
                     # eligibility scoped to the shard's own partitions
                     hot=HotPartitionSet(store, eligible=pids,
                                         device=store.device,
                                         tracer=self.tracer,
                                         registry=self.registry))
            for sid, pids in enumerate(self.assignment)]

    @property
    def gathers(self) -> bool:
        """Whether each process sweeps its own shard and the boards are
        all-gathered (``ctx`` spans ``num_shards`` processes)."""
        return self.ctx is not None and self.ctx.dp_size == self.num_shards

    # ------------------------------------------------------------- budget
    def set_budget(self, host_free_bytes: float) -> None:
        """Split the placement's host headroom evenly across the shards'
        streamers (each shard owns its residency budget)."""
        self.set_budgets([host_free_bytes / self.num_shards]
                         * self.num_shards)

    def set_budgets(self, per_shard_bytes: Sequence[float]) -> None:
        if len(per_shard_bytes) != self.num_shards:
            raise ValueError(f"{len(per_shard_bytes)} budgets for "
                             f"{self.num_shards} shards")
        for shard, budget in zip(self.shards, per_shard_bytes):
            if shard.streamer is not None:
                shard.streamer.set_budget(max(float(budget), 0.0))

    def set_hot_budgets(self, per_shard_bytes: Sequence[float],
                        ranking: Sequence[int]) -> None:
        """Retarget every shard's device-hot tier from the market's byte
        grant (``PlacementOptimizer.shard_hot_budgets``) and the global
        heat ranking; each shard's eligibility filter keeps it to its
        own disjoint partitions."""
        if len(per_shard_bytes) != self.num_shards:
            raise ValueError(f"{len(per_shard_bytes)} budgets for "
                             f"{self.num_shards} shards")
        for shard, budget in zip(self.shards, per_shard_bytes):
            if shard.hot is not None:
                shard.hot.retarget(int(budget), ranking)

    def hot_partitions(self) -> List[int]:
        return sorted(pid for shard in self.shards
                      if shard.hot is not None for pid in shard.hot.pids())

    def hot_device_bytes(self) -> int:
        return sum(shard.hot.device_bytes() for shard in self.shards
                   if shard.hot is not None)

    def close(self) -> None:
        for shard in self.shards:
            if shard.streamer is not None:
                shard.streamer.close()

    # ------------------------------------------------------------- search
    def search(self, queries: np.ndarray, top_k: int,
               impl: Optional[str] = None,
               nprobe: Optional[int] = None,
               stats: Optional[SearchStats] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Global top-k: one global probe, shard-local probe-masked
        sweeps, per-shard scoreboard fuse, cross-shard merge.  Returns
        (scores (Q, k), global chunk ids (Q, k)) as numpy, equal to
        ``VectorStore.search`` at equal ``nprobe`` (modulo exact score
        ties between distinct chunks)."""
        store = self.store
        nq = queries.shape[0]
        if nprobe is not None:
            pids, qmask = store.probe(queries, nprobe)
        else:
            pids = list(store.partitions)
            qmask = np.zeros((nq, store.num_partitions), bool)
            qmask[:, pids] = True
        if stats:
            stats.add(partitions_pruned=store.num_partitions - len(pids))

        mine = ([self.shards[self.ctx.batch_rank]] if self.gathers
                else self.shards)
        local_s: List[torch.Tensor] = []
        local_i: List[torch.Tensor] = []
        # each shard sweeps into a full-width (Q, P, k) board although it
        # owns ~P/S partitions: one shape for every shard and probe set,
        # as the single-host sweep has, at an S-fold transient board
        for shard in mine:
            # keep the global probe order (most-probed first, residents
            # ahead) within the shard's own partitions
            own = [pid for pid in pids if pid in shard.pid_set]
            # each shard sweeps into its own stats object, folded into
            # the caller's through the locked merge(): totals are
            # conserved and a parallel sweep could not drift them
            shard_stats = SearchStats() if stats else None
            with self.tracer.span("shard.sweep", sid=shard.sid,
                                  partitions=len(own)):
                board_s, board_i, searched = store.sweep_boards(
                    queries, own, top_k, impl=impl,
                    streamer=shard.streamer, stats=shard_stats,
                    hot=shard.hot, qmask=qmask)
            if stats:
                stats.merge(shard_stats)
            mask = torch.from_numpy(qmask & searched[None, :]).to(
                board_s.device)
            s, i = ops.retrieval_topk_merge(board_s, board_i, mask, top_k,
                                            impl=impl)
            local_s.append(s)
            local_i.append(i)

        if self.gathers:
            scores, gids = _gather_merge(torch.stack(local_s),
                                         torch.stack(local_i), top_k,
                                         self.ctx, impl=impl)
        else:
            fused_s = torch.stack(local_s, dim=1)         # (Q, S, k)
            fused_i = torch.stack(local_i, dim=1)
            scores, gids = ops.retrieval_topk_merge(
                fused_s, fused_i,
                torch.ones((nq, self.num_shards), dtype=torch.bool,
                           device=fused_s.device), top_k, impl=impl)
        return scores.cpu().numpy(), gids.cpu().numpy()

    def get_chunks(self, ids: np.ndarray) -> List[List[str]]:
        return self.store.get_chunks(ids)
