"""Joint hierarchical memory placement (paper §4.2, Eq. 2–3).

One optimizer places DB partitions and LLM tensors (weights, KV cache,
workspace) across the accelerator / host / disk tiers:

    w_gpu*W + c_gpu*C(B) + H(B)     <= M_gpu          (Eq. 2)
    w_cpu*W + c_cpu*C(B) + P*M_p    <= M_cpu          (Eq. 3)

The solver mirrors the paper: instead of a closed-form model it sweeps a
small grid of strategic configurations (resident partitions x placement
fractions), scores each with the cost model's pipeline-balance objective
max(t_retrieval, t_generation), and returns the argmin.  ``project`` is
the OOM-recovery ladder (§5 fault tolerance): demote KV first, then
weights, then release partitions — never a full restart.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.costmodel import CostModel, HardwareProfile, ModelProfile
from repro_torch.obs.metrics import NULL_REGISTRY
from repro_torch.obs.trace import NULL_TRACER


@dataclass(frozen=True)
class Placement:
    w_gpu: float                 # fraction of weights on accelerator
    w_cpu: float                 # fraction on host (rest on disk)
    c_gpu: float                 # fraction of KV cache on accelerator
    c_cpu: float                 # fraction on host
    resident_partitions: int     # P
    gen_batch: int               # B
    nprobe: Optional[int] = None  # IVF probe width (None = exact sweep)

    def __post_init__(self):
        assert -1e-9 <= self.w_gpu and self.w_gpu + self.w_cpu <= 1 + 1e-9
        assert -1e-9 <= self.c_gpu and self.c_gpu + self.c_cpu <= 1 + 1e-9

    @property
    def w_disk(self) -> float:
        return max(0.0, 1.0 - self.w_gpu - self.w_cpu)


@dataclass
class MemoryUse:
    gpu: float
    cpu: float

    def fits(self, hw: HardwareProfile) -> bool:
        return (self.gpu <= hw.gpu_mem * hw.mem_headroom
                and self.cpu <= hw.cpu_mem * hw.mem_headroom)


@dataclass(frozen=True)
class MarketSplit:
    """One device-byte market clearing (the Eq. 2 pool, arbitrated).

    Every elastic consumer of accelerator memory — live KV pages, the
    radix prefix cache's share, and device-hot IVF partitions — is
    funded in bytes out of ONE pool (the placement's accelerator KV
    share), so the budgets can never over-commit in aggregate.

    Invariant (property-tested and CI-asserted)::

        kv_page_budget * page_bytes + hot_bytes <= total_bytes
        prefix_page_budget <= kv_page_budget      (a cap INSIDE the pool)

    ``host_page_budget`` is the ``c_cpu`` swap headroom — a host-tier
    budget reported alongside so the policy boundary makes one market
    call instead of three per-subsystem ones.

    ``kv_format``/``bits_per_token`` record the pool format the pages
    were priced at: the byte pool is fixed by the placement, so a
    lower-bit format clears MORE pages out of the same grant (int8
    roughly 4x the fp32 page count, minus the per-page scale overhead).
    """
    total_bytes: float
    page_bytes: float
    kv_page_budget: int
    prefix_page_budget: int
    host_page_budget: int
    hot_bytes: int
    hot_partitions: int
    hot_hit_rate: float    # expected probe fraction the hot tier answers
    kv_format: str = "bf16"
    bits_per_token: float = 0.0   # stored KV bits per token, all layers

    def device_bytes(self) -> float:
        return self.kv_page_budget * self.page_bytes + self.hot_bytes


class PlacementOptimizer:
    def __init__(self, cost: CostModel, avg_ctx_len: int = 512,
                 avg_out_len: int = 128, min_nprobe_frac: float = 0.25,
                 kv_page_size: int = 16,
                 prefix_cache_frac: float = 0.25,
                 hot_fracs: Sequence[float] = (0.0, 0.125, 0.25, 0.5),
                 tracer=None, registry=None):
        self.cost = cost
        self.tracer = tracer or NULL_TRACER
        self.registry = registry or NULL_REGISTRY
        self.avg_ctx = avg_ctx_len
        self.avg_out = avg_out_len
        # recall floor: never probe fewer than this fraction of the
        # clusters (the fig11 sweep validates >=0.9 recall@k down here)
        self.min_nprobe_frac = min_nprobe_frac
        # KV paging granularity: the unit the placement trades between
        # accelerator KV pages and host partition cache
        self.kv_page_size = kv_page_size
        # device-KV share the radix prefix cache may hold (cached prompt
        # prefixes compete with live KV pages for the same pool)
        if not 0.0 <= prefix_cache_frac <= 1.0:
            raise ValueError("prefix_cache_frac must be in [0, 1]")
        self.prefix_cache_frac = prefix_cache_frac
        # candidate shares of the device pool the hot partition tier may
        # bid for; 0.0 must stay in the grid (the no-hot-tier clearing)
        if any(not 0.0 <= f <= 1.0 for f in hot_fracs) or 0.0 not in hot_fracs:
            raise ValueError("hot_fracs must lie in [0, 1] and include 0.0")
        self.hot_fracs = tuple(sorted(hot_fracs))

    def _nprobe_grid(self) -> List[int]:
        p_max = self.cost.num_partitions
        floor = max(1, int(math.ceil(self.min_nprobe_frac * p_max)))
        return sorted({max(floor, p_max // 4), max(floor, p_max // 2),
                       p_max})

    # ------------------------------------------------------------ memory
    def memory_use(self, p: Placement) -> MemoryUse:
        mp, hw = self.cost.mp, self.cost.hw
        c_total = mp.kv_bytes(p.gen_batch, self.avg_ctx + self.avg_out)
        h = mp.workspace_bytes(p.gen_batch, self.avg_ctx)
        gpu = p.w_gpu * mp.weight_bytes + p.c_gpu * c_total + h
        cpu = (p.w_cpu * mp.weight_bytes + p.c_cpu * c_total
               + p.resident_partitions * self.cost.partition_mem_bytes)
        return MemoryUse(gpu=gpu, cpu=cpu)

    def feasible(self, p: Placement) -> bool:
        return self.memory_use(p).fits(self.cost.hw)

    # ----------------------------------------------------- KV paging view
    def kv_gpu_bytes(self, p: Placement) -> float:
        """Attention-KV bytes this placement funds on the accelerator.

        Deliberately excludes ``ssm_state_bytes``: SSM state is constant
        per sequence and cannot live in token pages, so counting it here
        would mint phantom pages for hybrid models (paging itself only
        supports attention-family mixers).
        """
        return (p.c_gpu * p.gen_batch * (self.avg_ctx + self.avg_out)
                * self.cost.mp.kv_bytes_per_token)

    def kv_page_budget(self, p: Placement,
                       page_size: Optional[int] = None,
                       kv_format: Optional[str] = None) -> int:
        """The placement's KV allocation expressed in whole pages — the
        budget the engine hands to ``PagePool.resize`` at every policy
        boundary (page-budget <-> placement coupling).  ``kv_format``
        reprices the page out of the same byte grant (the market's
        bits-per-token dimension): int8 pages are ~4x cheaper, so the
        same grant clears ~4x the pages."""
        mp = (self.cost.mp if kv_format is None
              else self.cost.mp.with_kv_format(kv_format))
        page_bytes = mp.kv_page_bytes(page_size or self.kv_page_size)
        return int(self.kv_gpu_bytes(p) // max(page_bytes, 1.0))

    def kv_host_bytes(self, p: Placement) -> float:
        """Attention-KV bytes the placement parks on the host — the
        ``c_cpu * C(B)`` term of Eq. 3, with the same attention-only
        accounting as :meth:`kv_gpu_bytes`."""
        return (p.c_cpu * p.gen_batch * (self.avg_ctx + self.avg_out)
                * self.cost.mp.kv_bytes_per_token)

    def kv_host_page_budget(self, p: Placement,
                            page_size: Optional[int] = None,
                            kv_format: Optional[str] = None) -> int:
        """The ``c_cpu`` KV share expressed in whole pages — the budget
        the engine hands to ``HostPagePool.resize`` at every policy
        boundary, exactly like :meth:`kv_page_budget` does for the
        device pool (including its ``kv_format`` repricing).  Zero when
        the placement keeps no KV on the host (swap-to-host is then
        legitimately unavailable)."""
        mp = (self.cost.mp if kv_format is None
              else self.cost.mp.with_kv_format(kv_format))
        page_bytes = mp.kv_page_bytes(page_size or self.kv_page_size)
        return int(self.kv_host_bytes(p) // max(page_bytes, 1.0))

    def prefix_cache_page_budget(self, p: Placement,
                                 page_size: Optional[int] = None) -> int:
        """Device pages the radix prefix cache may hold under this
        placement — ``prefix_cache_frac`` of the accelerator KV page
        budget.  Cached prefixes and live KV pages share one physical
        pool, so this is an *arbitration cap inside*
        :meth:`kv_page_budget`, not additional memory: the engine hands
        it to ``ContinuousGenerator.retarget(prefix_page_budget=...)``
        at every policy boundary and the cache demotes LRU pages to the
        host tier until it fits."""
        return int(self.prefix_cache_frac
                   * self.kv_page_budget(p, page_size))

    # ------------------------------------------------- device-byte market
    def device_byte_budget(self, p: Placement) -> float:
        """The single device-byte pool the market arbitrates: the
        placement's accelerator KV share (Eq. 2's ``c_gpu * C(B)``
        term).  Hot partitions are carved *out of* this pool, not added
        on top — pinning a partition device-side costs live KV pages."""
        return self.kv_gpu_bytes(p)

    def market(self, p: Placement, page_size: Optional[int] = None,
               partition_heat: Optional[Sequence[float]] = None,
               kv_format: Optional[str] = None,
               priority_pressure: float = 0.0) -> MarketSplit:
        """Clear the device-byte market: arbitrate the pool between live
        KV pages, the prefix-cache cap, and device-hot partitions.

        ``partition_heat`` is the observed per-partition popularity,
        hottest first (the decayed probe counts from
        ``SearchStats.heat()``); with no observed skew the hot tier is
        never funded.  Each candidate hot fraction is priced with the
        cost model — hot probes skip the disk load and the host matmul,
        while the pages they displace shrink the concurrent batch the
        paged pool can admit (capacity below the placement's batch
        serializes generation into rounds) — and the cheapest clearing
        wins.  Ties keep the smaller hot fraction, so with no heat (or
        paper-scale partitions that dwarf the pool) the split reproduces
        the legacy per-subsystem budgets exactly.

        ``kv_format`` adds the bits-per-token dimension: the byte pool
        the placement grants is FIXED, but a quantized pool format
        shrinks the real bytes of one page (int8 payload + fp32 scales,
        via :meth:`ModelProfile.with_kv_format`), so the same grant
        clears proportionally more pages — and a larger effective batch
        — without moving Eq. 2.  ``None`` prices at the profile's own
        format.  The quality floor stays in the kernels: prefill and
        all attention accumulation remain fp32 regardless of the
        storage format, so the market never trades accuracy it cannot
        see.

        ``priority_pressure`` (0..1, the request scheduler's fraction of
        waiting + in-flight work that is interactive) weights the
        clearing toward decode throughput: generation time is inflated
        by ``1 + pressure`` when scoring, so under interactive load the
        market keeps more KV pages (smaller hot tier) — interactive
        latency is dominated by decode capacity, not retrieval
        residency.  At 0 the clearing is unchanged.
        """
        ps = page_size or self.kv_page_size
        mp = (self.cost.mp if kv_format is None
              else self.cost.mp.with_kv_format(kv_format))
        page_bytes = max(mp.kv_page_bytes(ps), 1.0)
        total = self.device_byte_budget(p)
        part_dev = max(self.cost.hot_partition_dev_bytes, 1.0)
        heat = sorted((h for h in (partition_heat or ()) if h > 0),
                      reverse=True)
        mass = float(sum(heat))
        # a clearing must keep enough pages to admit one request, or the
        # generator starves no matter how fast retrieval gets
        need = max(-(-(self.avg_ctx + self.avg_out) // ps), 1)

        def gen_time(pages: int) -> float:
            cap = max(pages // need, 1)
            eff = max(min(p.gen_batch, cap), 1)
            return (self.cost.batch_generation_time(
                eff, self.avg_ctx, self.avg_out, p.w_gpu, p.c_gpu,
                w_cpu=p.w_cpu) * (p.gen_batch / eff))

        best: Optional[Tuple[float, int, int, int, float]] = None
        with self.tracer.span("placement.market", gen_batch=p.gen_batch,
                              candidates=len(self.hot_fracs)):
            for frac in self.hot_fracs:
                n_hot = min(int(frac * total // part_dev), len(heat),
                            self.cost.num_partitions)
                hot_bytes = int(n_hot * part_dev)
                pages = int((total - hot_bytes) // page_bytes)
                if n_hot > 0 and pages < need:
                    continue
                hit = (sum(heat[:n_hot]) / mass) if n_hot else 0.0
                t_ret = self.cost.retrieval_time(
                    p.gen_batch, p.resident_partitions, nprobe=p.nprobe,
                    hot_partitions=n_hot, hot_hit_rate=hit)
                score = max(t_ret, gen_time(pages)
                            * (1.0 + max(priority_pressure, 0.0)))
                if best is None or score < best[0] - 1e-12:
                    best = (score, n_hot, pages, hot_bytes, hit)
        _, n_hot, pages, hot_bytes, hit = best
        split = MarketSplit(
            total_bytes=total, page_bytes=page_bytes,
            kv_page_budget=pages,
            prefix_page_budget=int(self.prefix_cache_frac * pages),
            # host swap headroom is a byte grant too: express it in
            # pages of the SAME live format the device pool uses
            host_page_budget=int(self.kv_host_bytes(p) // page_bytes),
            hot_bytes=hot_bytes, hot_partitions=n_hot, hot_hit_rate=hit,
            kv_format=mp.kv_format,
            bits_per_token=8.0 * mp.kv_bytes_per_token)
        self.registry.event("market", **dataclasses.asdict(split))
        return split

    def paged_batch_capacity(self, p: Placement,
                             page_size: Optional[int] = None,
                             req_len: Optional[int] = None) -> int:
        """Concurrent requests the paged pool admits: each reserves only
        ``ceil(actual_len / page)`` pages."""
        ps = page_size or self.kv_page_size
        need = -(-int(req_len or (self.avg_ctx + self.avg_out)) // ps)
        return self.kv_page_budget(p, ps) // max(need, 1)

    def dense_batch_capacity(self, p: Placement, worst_case_len: int) -> int:
        """Concurrent requests under dense rows: every slot is provisioned
        for the worst-case ``ctx_len + max_new_tokens`` row (same byte
        pool as the paged view, so the comparison isolates paging)."""
        row = worst_case_len * self.cost.mp.kv_bytes_per_token
        return int(self.kv_gpu_bytes(p) // max(row, 1.0))

    # ------------------------------------------------- retrieval sharding
    def shard_resident_budgets(self, p: Placement,
                               shards: Optional[int] = None) -> List[int]:
        """Split the placement's resident-partition budget ``P`` across
        the retrieval shards (even split, remainder to the leading
        shards — mirroring ``ShardedIVFStore``'s balanced partition
        assignment, which differs across shards by at most one)."""
        s = max(1, shards if shards is not None
                else self.cost.retrieval_shards)
        base, rem = divmod(max(p.resident_partitions, 0), s)
        return [base + (1 if i < rem else 0) for i in range(s)]

    def shard_streamer_budgets(self, host_free_bytes: float,
                               shards: Optional[int] = None) -> List[float]:
        """Per-shard streamer lookahead budgets from the live placement's
        host headroom: each shard's disk tier prefetches independently,
        so the headroom splits evenly (a shard never spends another
        shard's bytes)."""
        s = max(1, shards if shards is not None
                else self.cost.retrieval_shards)
        per = max(host_free_bytes, 0.0) / s
        return [per] * s

    def shard_hot_budgets(self, hot_bytes: float,
                          shards: Optional[int] = None) -> List[int]:
        """Split the market's hot-partition byte grant across the
        retrieval shards (even split, like
        :meth:`shard_resident_budgets` / :meth:`shard_streamer_budgets`:
        each shard promotes only its own partitions, so one shard can
        never spend another shard's bytes)."""
        s = max(1, shards if shards is not None
                else self.cost.retrieval_shards)
        base, rem = divmod(int(max(hot_bytes, 0.0)), s)
        return [base + (1 if i < rem else 0) for i in range(s)]

    # ----------------------------------------------------------- project
    def project(self, p: Placement) -> Placement:
        """OOM-recovery ladder: demote KV -> demote weights -> release
        partitions -> shrink batch. Always returns a feasible placement."""
        q = p
        steps = 0
        while not self.feasible(q) and steps < 1000:
            steps += 1
            use = self.memory_use(q)
            hw = self.cost.hw
            if use.gpu > hw.gpu_mem * hw.mem_headroom:
                if q.c_gpu > 0.0:
                    shift = min(q.c_gpu, 0.1)
                    q = dataclasses.replace(
                        q, c_gpu=q.c_gpu - shift,
                        c_cpu=min(q.c_cpu + shift, 1.0 - (q.c_gpu - shift)))
                elif q.w_gpu > 0.0:
                    shift = min(q.w_gpu, 0.05)
                    q = dataclasses.replace(
                        q, w_gpu=q.w_gpu - shift,
                        w_cpu=min(q.w_cpu + shift, 1.0 - (q.w_gpu - shift)))
                elif q.gen_batch > 1:
                    q = dataclasses.replace(q, gen_batch=q.gen_batch // 2)
                else:
                    break
            else:  # CPU over budget
                if q.resident_partitions > 0:
                    q = dataclasses.replace(
                        q, resident_partitions=q.resident_partitions - 1)
                elif q.c_cpu > 0.0:
                    q = dataclasses.replace(q,
                                            c_cpu=max(q.c_cpu - 0.1, 0.0))
                elif q.w_cpu > 0.0:
                    q = dataclasses.replace(q,
                                            w_cpu=max(q.w_cpu - 0.05, 0.0))
                elif q.gen_batch > 1:
                    q = dataclasses.replace(q, gen_batch=q.gen_batch // 2)
                else:
                    break
        return q

    # ------------------------------------------------------------- score
    def pipeline_times(self, p: Placement, ret_batch: Optional[int] = None
                       ) -> Tuple[float, float]:
        t_ret = self.cost.retrieval_time(ret_batch or p.gen_batch,
                                         p.resident_partitions,
                                         nprobe=p.nprobe)
        t_gen = self.cost.batch_generation_time(
            p.gen_batch, self.avg_ctx, self.avg_out, p.w_gpu, p.c_gpu,
            w_cpu=p.w_cpu)
        return t_ret, t_gen

    def score(self, p: Placement) -> float:
        """Pipeline-balance objective: minimize max(t_ret, t_gen) per req.

        Tie-break toward strictly-better resource placements (more resident
        partitions, more weights/KV on faster tiers): when one pipeline
        dominates, extra capacity on the other side is free.
        """
        t_ret, t_gen = self.pipeline_times(p)
        nprobe = p.nprobe if p.nprobe is not None \
            else self.cost.num_partitions
        tie = (p.resident_partitions / max(self.cost.num_partitions, 1)
               + p.w_gpu + 0.5 * p.c_gpu + 0.25 * p.w_cpu
               + 0.5 * nprobe / max(self.cost.num_partitions, 1))
        return max(t_ret, t_gen) / max(p.gen_batch, 1) * (1 - 1e-4 * tie)

    # -------------------------------------------------------------- solve
    def candidates(self, gen_batch: int) -> List[Placement]:
        """Strategic grid (paper: 'sample configurations at strategic
        intervals' rather than exhaustive search)."""
        mp, hw = self.cost.mp, self.cost.hw
        out = []
        p_max = self.cost.num_partitions
        nprobes = self._nprobe_grid()
        for pres in {0, p_max // 8, p_max // 4, p_max // 2,
                     3 * p_max // 4, p_max}:
            for wg in (0.0, 0.25, 0.5, 0.75, 1.0):
                for wc_frac in (1.0, 0.5, 0.0):     # host share of the rest
                    for cg in (0.0, 0.5, 1.0):
                        wc = (1.0 - wg) * wc_frac
                        cand = Placement(
                            w_gpu=wg, w_cpu=wc, c_gpu=cg,
                            c_cpu=min(1.0 - cg, 1.0),
                            resident_partitions=pres, gen_batch=gen_batch)
                        cand = self.project(cand)
                        if not self.feasible(cand):
                            continue
                        # nprobe is memory-neutral: feasibility is shared
                        # across the whole probe-width column
                        for nprobe in nprobes:
                            out.append(dataclasses.replace(cand,
                                                           nprobe=nprobe))
        return out

    def solve(self, gen_batch: int) -> Placement:
        cands = self.candidates(gen_batch)
        if not cands:
            # fall back to fully-offloaded minimal placement
            return self.project(Placement(0.0, 0.0, 0.0, 0.0, 0,
                                          max(gen_batch, 1)))
        return min(cands, key=self.score)
