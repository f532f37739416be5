"""Discrete-event simulator for paper-scale serving experiments.

Copied from ``repro.serving.simulator`` with its imports moved to the
port's own cost model, placement, scheduler and request modules; the
arithmetic is the same Python, so both give equal results.

Fig. 7–11 / Tables 1–2 are reproduced at paper scale (8B–70B models)
without running the models, by simulating the *timing* with the
calibrated CostModel while running the *real* decision code: the same BacklogScheduler,
PlacementOptimizer and pipeline-formation logic the live engine uses.
Only operation durations are synthetic; every scheduling/placement decision
is produced by the production code paths.

Modes
  ragdoll            full system (pipelined, dynamic batch, joint placement;
                     continuous decode-step batching by default — requests
                     join free KV slots at any decode step and leave the
                     step they finish, mirroring the real engine's slot
                     table; set ``continuous=False`` for the whole-batch
                     variant used by the Fig. 9 sweep)
  no_pipeline        ablation: one worker, retrieval+generation share batches
  static_batch       ablation: fixed generation batch size
  flexgen_prefetch   ablation: next-layer-only prefetch (depth=1)
  vllm_infer         ablation: vLLM backend (fixed weight split, linear batch
                     scaling) behind RAGDoll's pipeline
  serial_vllm        baseline vLLMRAG: serial stages, batch = 4*rate
  serial_acc         baseline AccRAG: serial, no prefetch overlap (depth=0)
"""
from __future__ import annotations

import heapq
import math
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.costmodel import CostModel
from repro_torch.core.placement import (MarketSplit, Placement,
                                  PlacementOptimizer)
from repro_torch.core.scheduler import BacklogScheduler
from repro_torch.serving.request import Request


def poisson_workload(rates_per_min: Tuple[float, ...] = (4, 8, 12, 16),
                     interval_s: float = 1200.0, seed: int = 0
                     ) -> List[float]:
    """Arrival times: piecewise-constant Poisson process (paper §6.1)."""
    rng = random.Random(seed)
    t, out = 0.0, []
    for i, r in enumerate(rates_per_min):
        end = (i + 1) * interval_s
        lam = r / 60.0
        while True:
            t += rng.expovariate(lam)
            if t >= end:
                t = end
                break
            out.append(t)
    return out


def rate_at(t: float, rates_per_min: Tuple[float, ...],
            interval_s: float) -> float:
    idx = min(int(t // interval_s), len(rates_per_min) - 1)
    return rates_per_min[idx]


@dataclass
class SimConfig:
    mode: str = "ragdoll"
    in_len: int = 512              # top-5 chunks + question (~512 tokens)
    out_len: int = 32              # TriviaQA answers are short factoids
    max_batch: int = 64
    static_batch: Optional[int] = None
    rates_per_min: Tuple[float, ...] = (4, 8, 12, 16)
    interval_s: float = 1200.0
    depth_prefill: int = 1
    depth_decode: int = 8
    retrieval_max_batch: int = 128
    # continuous decode-step batching (None: on for "ragdoll", off
    # elsewhere — serial baselines keep whole-batch semantics so the
    # benchmark comparisons stay like-for-like)
    continuous: Optional[bool] = None
    policy_every: int = 4          # decode steps between policy consults
    # paged KV modelling (continuous mode only): joiners must reserve
    # ceil((in_len + out_len) / page_size) pages from the placement's
    # page budget; exhaustion defers the join (backpressure) instead of
    # over-committing KV memory
    paged: bool = False
    page_size: int = 16
    # live KV pool format (paged modelling): prices the page budget and
    # the swap DMA at the real leaf bytes — "int8" clears ~4x the pages
    # out of the same placement byte grant and shrinks preemption PCIe
    # cost by the same factor (None: the cost model's own format)
    kv_format: Optional[str] = None
    # swap-to-host preemption (paged only): a page-starved join may park
    # the longest-remaining live slot host-side (budget = the placement's
    # c_cpu KV share in pages) at a whole-page PCIe latency cost, instead
    # of waiting for a natural leave; parked slots resume FIFO once the
    # join backlog clears
    swap: bool = False
    # priority classes (continuous mode): fraction of arrivals tagged
    # interactive (priority 1).  Interactive requests join first, are
    # never preempted for a batch joiner, and resume first — the request
    # scheduler's policy, mirrored at simulation scale.  0 = single class
    # (identical to the pre-priority behaviour).
    priority_mix: float = 0.0
    # partial-slot swap (swap mode): a preemption sheds only the pages
    # the blocked join is short of (the victim's coldest prefix,
    # FlexGen-style) instead of its whole allocation — both DMA
    # directions move only the shortfall
    partial_swap: bool = False
    # swap/decode overlap: the swap DMA rides an async transfer worker,
    # so only the copy time not hidden behind the step's decode+prefill
    # compute stalls the pipeline (CostModel.kv_swap_time(overlap=True))
    overlap_swap: bool = False
    # sharded IVF retrieval: probed partitions split across S hosts
    # (per-shard disk/CPU in parallel + one (Q, k) all-gather — see
    # CostModel.retrieval_time); None defers to the cost model's own
    # retrieval_shards
    retrieval_shards: Optional[int] = None
    # radix prefix cache (paged continuous mode): every request shares
    # its leading ``shared_prefix_len`` prompt tokens (the RAG system
    # prompt + recurring retrieved chunks).  The first prefill seeds the
    # cache; later joiners reserve only the non-shared pages and pay
    # ``prefill_time(cached_len=...)`` — the TTFT collapse of fig8's
    # shared-prefix row.  The cache's own page holds count against the
    # placement's device page budget (live KV vs cache arbitration).
    prefix_cache: bool = False
    shared_prefix_len: int = 0
    # device-hot partition tier: the hottest partitions are pinned
    # device-resident out of the SAME byte pool as KV/prefix pages (the
    # PlacementOptimizer.market clearing); ``zipf_alpha`` is the query
    # skew the tier exploits — heat ~ 1/rank^alpha over the partitions
    hot_tier: bool = False
    zipf_alpha: float = 1.2


@dataclass
class SimResult:
    requests: List[Request]
    policy_trace: List[Dict[str, float]]
    gpu_busy: float = 0.0
    cpu_busy: float = 0.0
    horizon: float = 0.0

    @property
    def gpu_idle_frac(self) -> float:
        return 1.0 - self.gpu_busy / max(self.horizon, 1e-9)

    @property
    def cpu_idle_frac(self) -> float:
        return 1.0 - self.cpu_busy / max(self.horizon, 1e-9)


class ServingSimulator:
    def __init__(self, cost: CostModel, opt: PlacementOptimizer,
                 sim: SimConfig):
        self.cost = cost
        self.opt = opt
        self.sim = sim
        self.continuous = (sim.mode == "ragdoll" if sim.continuous is None
                           else sim.continuous)
        self._placement_cache: Dict[int, Placement] = {}
        self._market_cache: Dict[Placement, "MarketSplit"] = {}
        # seed schedulers from "active profiling" over the cost model
        self.gen_sched = BacklogScheduler(max_batch=sim.max_batch)
        self.ret_sched = BacklogScheduler(max_batch=sim.retrieval_max_batch)
        cands = [b for b in (1, 2, 4, 8, 16, 32, 64, 128)
                 if b <= sim.max_batch]
        self.gen_sched.seed([(b, self._gen_time(b)) for b in cands])
        self.ret_sched.seed(
            [(b, self._ret_time(b, self._placement(8).resident_partitions,
                                p=self._placement(8)))
             for b in (8, 32, 128)])

    # ----------------------------------------------------------- costing
    def _placement(self, b: int) -> Placement:
        if b not in self._placement_cache:
            if self.sim.mode == "vllm_infer":
                # fixed weight split: solve once at a reference batch
                ref = self._placement_cache.get(-1) or self.opt.solve(8)
                self._placement_cache[-1] = ref
                self._placement_cache[b] = Placement(
                    ref.w_gpu, ref.w_cpu, ref.c_gpu, ref.c_cpu,
                    ref.resident_partitions, b, nprobe=ref.nprobe)
            else:
                self._placement_cache[b] = self.opt.solve(b)
        return self._placement_cache[b]

    def _gen_time(self, b: int) -> float:
        if b <= 0:
            return 0.0
        p = self._placement(b)
        s = self.sim
        w_gpu, c_gpu = p.w_gpu, p.c_gpu
        overhead = 1.0
        if s.mode == "serial_acc":
            # Accelerate: no prefetch overlap (serial transfer+compute) and
            # conservative weight residency to protect workspace memory
            dp, dd = 0, 0
            w_gpu = min(w_gpu, 0.4)
            overhead = 2.2
        elif s.mode in ("flexgen_prefetch", "serial_vllm"):
            dp, dd = 1, 1
        else:
            dp, dd = s.depth_prefill, s.depth_decode
        t = overhead * self.cost.batch_generation_time(
            b, s.in_len, s.out_len, w_gpu, c_gpu,
            depth_prefill=dp, depth_decode=dd,
            w_cpu=min(p.w_cpu, 1.0 - w_gpu))
        if s.mode == "vllm_infer":
            # internal batch capping: latency grows ~linearly beyond the
            # memory-derived effective batch (paper §6.4)
            eff = max(self._placement(-1).gen_batch, 8)
            if b > eff:
                t *= b / eff
        return t

    def _market(self, p: Placement) -> Optional[MarketSplit]:
        """Clear the device-byte market for a placement (hot-tier mode):
        the synthetic heat follows the configured Zipf skew over the
        partitions.  Cached per placement — `Placement` is frozen, and
        the skew is workload-level, so the clearing is deterministic."""
        if not self.sim.hot_tier:
            return None
        if p not in self._market_cache:
            heat = [(1.0 / r) ** self.sim.zipf_alpha
                    for r in range(1, self.cost.num_partitions + 1)]
            self._market_cache[p] = self.opt.market(
                p, page_size=self.sim.page_size, partition_heat=heat,
                kv_format=self.sim.kv_format)
        return self._market_cache[p]

    def _ret_time(self, b: int, resident: int,
                  nprobe: Optional[int] = None,
                  p: Optional[Placement] = None) -> float:
        split = self._market(p) if p is not None else None
        return self.cost.retrieval_time(
            b, resident, nprobe=nprobe, shards=self.sim.retrieval_shards,
            hot_partitions=split.hot_partitions if split else 0,
            hot_hit_rate=split.hot_hit_rate if split else None)

    def _nprobe(self, p: Placement) -> Optional[int]:
        """Serial baselines (vLLMRAG/AccRAG) run the exact all-partition
        sweep; only RAGDoll-family modes exercise the IVF probe knob."""
        if self.sim.mode.startswith("serial"):
            return None
        return p.nprobe

    # --------------------------------------------------------------- run
    def run(self, arrivals: List[float]) -> SimResult:
        s = self.sim
        reqs = [Request(rid=i, query=f"q{i}", arrival=t)
                for i, t in enumerate(arrivals)]
        if s.priority_mix > 0:
            # deterministic interleave at the configured mix: every
            # ``round(1/mix)``-th arrival is interactive
            stride = max(1, round(1.0 / s.priority_mix))
            for i, r in enumerate(reqs):
                r.priority = 1 if i % stride == 0 else 0
        if s.mode.startswith("serial") or s.mode == "no_pipeline":
            return self._run_serial(reqs)
        if self.continuous:
            return self._run_continuous(reqs)
        return self._run_pipeline(reqs)

    # serial baselines: one worker does retrieve-then-generate per batch
    def _run_serial(self, reqs: List[Request]) -> SimResult:
        s = self.sim
        now, i, n = 0.0, 0, len(reqs)
        queue: List[Request] = []
        done: List[Request] = []
        gpu_busy = cpu_busy = 0.0
        trace = []
        while len(done) < n:
            # admit arrivals
            while i < n and reqs[i].arrival <= now:
                queue.append(reqs[i])
                i += 1
            if not queue:
                now = reqs[i].arrival
                continue
            if s.mode == "no_pipeline":
                b = self.gen_sched.choose_batch(len(queue))
            else:
                b = max(int(4 * rate_at(now, s.rates_per_min, s.interval_s)),
                        1)
                b = min(b, s.max_batch)
            batch, queue = queue[:b], queue[b:]
            p = self._placement(len(batch))
            t_ret = self._ret_time(len(batch), p.resident_partitions,
                                   self._nprobe(p), p=p)
            t_gen = self._gen_time(len(batch))
            for r in batch:
                r.t_ret_start = now
                r.t_ret_end = now + t_ret
                r.t_gen_start = now + t_ret
                r.t_gen_end = now + t_ret + t_gen
            cpu_busy += t_ret
            gpu_busy += t_gen
            now += t_ret + t_gen
            if s.mode == "no_pipeline":
                self.gen_sched.observe(len(batch), t_ret + t_gen)
            done.extend(batch)
            trace.append({"t": now, "batch": len(batch),
                          "P": p.resident_partitions, "c_gpu": p.c_gpu,
                          "w_gpu": p.w_gpu,
                          "nprobe": self._nprobe(p)
                          or self.cost.num_partitions})
        return SimResult(requests=done, policy_trace=trace,
                         gpu_busy=gpu_busy, cpu_busy=cpu_busy, horizon=now)

    # continuous pipeline: retrieval worker + iteration-level decode pump
    def _run_continuous(self, reqs: List[Request]) -> SimResult:
        """Step-level join/leave: each event on the generation side is one
        decode step of the live slot table, not one whole batch.  Arrivals
        with retrieved context join free slots at the next step boundary
        (paying a prefill for the joining group); finished requests leave
        the step they emit their last token, freeing the slot immediately.
        The placement/batch policy is consulted every ``policy_every``
        steps, so capacity tracks the backlog *within* a generation.

        With ``paged=True`` the slot admission additionally models the
        paged KV pool: a joiner reserves its worst-case page count from
        the placement's page budget and stays queued when the pool is
        exhausted (join backpressure) — the budget itself is retargeted
        from the live placement at every policy consult.

        With ``swap=True`` on top, a page-starved join preempts the
        longest-remaining live slot instead: its pages move to the host
        pool (budget = the placement's ``c_cpu`` KV share via
        ``kv_host_page_budget``) and the join takes the freed device
        pages, each direction costing ``CostModel.kv_swap_time`` of
        PCIe transfer on that step.  Parked slots resume FIFO once the
        join backlog clears — the fig8/fig9 swap-vs-backpressure
        trade-off rows come from this model.

        With ``prefix_cache=True`` every request shares its leading
        ``shared_prefix_len`` prompt tokens: the first prefill seeds the
        radix cache (its shared pages stay booked against the device
        budget), and every later joiner reserves only the non-shared
        pages and pays a suffix-only prefill
        (``CostModel.prefill_time(cached_len=...)``)."""
        s = self.sim
        n = len(reqs)
        ret_q: List[Request] = []
        ctx_q: List[Request] = []
        done: List[Request] = []
        trace: List[Dict[str, float]] = []
        gpu_busy = cpu_busy = 0.0
        ev: List = []
        seq = 0
        for r in reqs:
            heapq.heappush(ev, (r.arrival, seq, "arrive", r))
            seq += 1
        ret_busy = gen_running = False
        # [request, tokens_remaining, pages_held, cached_len]
        active: List[List] = []
        swapped: List[List] = []         # parked host-side, FIFO resume
        req_pages = -(-(s.in_len + s.out_len) // s.page_size)
        # prefix sharing: full pages of the common prompt head live once
        # (held by the radix cache); a hit joiner reserves only the rest
        cached = (max(0, min(s.shared_prefix_len, s.in_len - 1))
                  if s.prefix_cache else 0)
        shared_pages = cached // s.page_size
        hit_pages = req_pages - shared_pages

        def page_budget(p: Placement) -> int:
            # floor of one request so a tiny placement can still progress
            # (plus the cache's holds, which are not reclaimable here)
            floor = req_pages + (shared_pages if s.prefix_cache else 0)
            return max(self.opt.kv_page_budget(p, s.page_size,
                                               kv_format=s.kv_format),
                       floor)

        def host_budget(p: Placement) -> int:
            return (self.opt.kv_host_page_budget(p, s.page_size,
                                                 kv_format=s.kv_format)
                    if s.swap else 0)

        cap = {"b": 1, "p": self._placement(1), "steps": 0,
               "pages": page_budget(self._placement(1)), "reserved": 0,
               "host": host_budget(self._placement(1)), "seeded": False}
        now = 0.0

        def start_ret(t):
            nonlocal seq, ret_busy, cpu_busy
            if ret_busy or not ret_q:
                return
            b = self.ret_sched.choose_batch(len(ret_q))
            if b <= 0:
                return
            batch = [ret_q.pop(0) for _ in range(min(b, len(ret_q)))]
            p = cap["p"]
            dur = self._ret_time(len(batch), p.resident_partitions,
                                 self._nprobe(p), p=p)
            for r in batch:
                r.t_ret_start = t
                r.t_ret_end = t + dur
            self.ret_sched.observe(len(batch), dur)
            cpu_busy += dur
            ret_busy = True
            heapq.heappush(ev, (t + dur, seq, "ret_done", batch))
            seq += 1

        def gen_step(t):
            nonlocal seq, gen_running, gpu_busy
            # admit arrivals into free slots (join at this step boundary);
            # paged mode also reserves KV pages — exhaustion preempts the
            # longest-remaining slot (swap) or defers the join
            joiners, swap_pages = [], 0
            while ctx_q and len(active) < cap["b"]:
                # a warm cache turns every arrival into a prefix hit:
                # only the non-shared pages need reserving
                c = cached if cap["seeded"] else 0
                need = hit_pages if c else req_pages
                # priority admission: the best waiting request joins
                # first (highest class, FIFO within a class); with a
                # single class this is plain FIFO
                ji = (min(range(len(ctx_q)),
                          key=lambda j: (-ctx_q[j].priority, j))
                      if s.priority_mix > 0 else 0)
                jpr = ctx_q[ji].priority
                if s.paged and cap["reserved"] + need > cap["pages"]:
                    if s.swap and active:
                        # victim: lowest priority class (never above the
                        # joiner's own), then longest remaining budget
                        cands = [sl for sl in active
                                 if sl[0].priority <= jpr]
                        victim = max(
                            cands,
                            key=lambda sl: (-sl[0].priority, sl[1])
                        ) if cands else None
                        if victim is not None:
                            # partial swap sheds only the shortfall (the
                            # victim's coldest prefix); the hot tail
                            # stays booked device-side
                            short = cap["reserved"] + need - cap["pages"]
                            shed = (max(1, min(victim[2], short))
                                    if s.partial_swap else victim[2])
                            host_used = sum(sh for _, sh in swapped)
                            if host_used + shed <= cap["host"]:
                                active.remove(victim)  # pages host-side
                                swapped.append((victim, shed))
                                cap["reserved"] -= shed
                                swap_pages += shed
                                continue
                    break                 # page exhaustion: backpressure
                r = ctx_q.pop(ji)
                r.t_gen_start = t
                joiners.append((r, c))
                active.append([r, s.out_len, need if s.paged else 0, c])
                if s.paged:
                    cap["reserved"] += need
            # parked slots swap back in once the join backlog clears —
            # highest priority class first, FIFO within a class (one
            # class = plain FIFO over preemption order)
            while swapped and not ctx_q and len(active) < cap["b"]:
                ri = (min(range(len(swapped)),
                          key=lambda j: (-swapped[j][0][0].priority, j))
                      if s.priority_mix > 0 else 0)
                if cap["reserved"] + swapped[ri][1] > cap["pages"]:
                    break
                slot, shed = swapped.pop(ri)
                active.append(slot)
                cap["reserved"] += shed
                swap_pages += shed
            if not active:
                gen_running = False
                return
            if cap["steps"] % s.policy_every == 0:
                b = self.gen_sched.choose_batch(
                    max(len(ctx_q) + len(active), 1))
                cap["b"] = max(min(b, s.max_batch), 1)
                cap["p"] = self._placement(cap["b"])
                p = cap["p"]
                if s.paged:
                    cap["pages"] = page_budget(p)
                    cap["host"] = host_budget(p)
                trace.append({"t": t, "batch": len(active),
                              "P": p.resident_partitions, "c_gpu": p.c_gpu,
                              "w_gpu": p.w_gpu, "backlog": len(ctx_q),
                              "pages_free": (cap["pages"] - cap["reserved"]
                                             if s.paged else None),
                              "swapped": len(swapped) if s.paged else None,
                              "in_flight": len(active) + len(swapped),
                              "hot": (self._market(p).hot_partitions
                                      if s.hot_tier else None),
                              "nprobe": self._nprobe(p)
                              or self.cost.num_partitions})
            cap["steps"] += 1
            p = cap["p"]
            w_cpu = min(p.w_cpu, 1.0 - p.w_gpu)
            dur = self.cost.decode_time_per_token(
                len(active), s.in_len + s.out_len // 2, p.w_gpu, p.c_gpu,
                s.depth_decode, w_cpu=w_cpu)
            if joiners:     # the joining group's prefill rides this step
                miss = sum(1 for _, c in joiners if c == 0)
                hits = len(joiners) - miss
                if miss:
                    dur += self.cost.prefill_time(
                        miss, s.in_len, p.w_gpu, p.c_gpu,
                        s.depth_prefill, w_cpu=w_cpu)
                if hits:    # suffix-only prefill for prefix-cache hits
                    dur += self.cost.prefill_time(
                        hits, s.in_len, p.w_gpu, p.c_gpu,
                        s.depth_prefill, w_cpu=w_cpu, cached_len=cached)
                if s.prefix_cache and not cap["seeded"]:
                    # the first completed prefill donates the shared
                    # head to the cache (its holds book real pages)
                    cap["seeded"] = True
                    if s.paged:
                        cap["reserved"] += shared_pages
            if swap_pages:  # whole-page DMA over PCIe rides it too:
                # inline it stalls the whole copy; with overlap only the
                # tail not hidden behind this step's compute stalls
                dur += self.cost.kv_swap_time(swap_pages, s.page_size,
                                              kv_format=s.kv_format,
                                              overlap=s.overlap_swap,
                                              hidden_s=dur)
            gpu_busy += dur
            for slot in active:          # one token per live slot
                slot[1] -= 1
            for slot in [sl for sl in active if sl[1] <= 0]:
                active.remove(slot)      # leave the step the row finishes
                slot[0].t_gen_end = t + dur
                done.append(slot[0])
                if s.paged:              # pages freed the step it leaves
                    cap["reserved"] -= slot[2]
            gen_running = True
            heapq.heappush(ev, (t + dur, seq, "gen_step", None))
            seq += 1

        while ev and len(done) < n:
            now, _, kind, payload = heapq.heappop(ev)
            if kind == "arrive":
                ret_q.append(payload)
            elif kind == "ret_done":
                ctx_q.extend(payload)
                ret_busy = False
            elif kind == "gen_step":
                gen_step(now)
            start_ret(now)
            if not gen_running:
                gen_step(now)
        return SimResult(requests=done, policy_trace=trace,
                         gpu_busy=gpu_busy, cpu_busy=cpu_busy, horizon=now)

    # full pipeline: retrieval and generation workers in parallel
    def _run_pipeline(self, reqs: List[Request]) -> SimResult:
        s = self.sim
        n = len(reqs)
        ret_q: List[Request] = []
        ctx_q: List[Request] = []
        done: List[Request] = []
        trace: List[Dict[str, float]] = []
        gpu_busy = cpu_busy = 0.0
        # event heap: (time, seq, kind, payload)
        ev: List = []
        seq = 0
        for r in reqs:
            heapq.heappush(ev, (r.arrival, seq, "arrive", r))
            seq += 1
        ret_busy = gen_busy_flag = False
        now = 0.0

        def start_ret(t):
            nonlocal seq, ret_busy, cpu_busy
            if ret_busy or not ret_q:
                return
            b = self.ret_sched.choose_batch(len(ret_q))
            if b <= 0:
                return
            take = min(b, len(ret_q))
            batch = [ret_q.pop(0) for _ in range(take)]
            p = self._placement(self.gen_sched.choose_batch(
                max(len(ctx_q), 1)) or 1)
            dur = self._ret_time(len(batch), p.resident_partitions,
                                 self._nprobe(p), p=p)
            for r in batch:
                r.t_ret_start = t
                r.t_ret_end = t + dur
            self.ret_sched.observe(len(batch), dur)
            cpu_busy += dur
            ret_busy = True
            heapq.heappush(ev, (t + dur, seq, "ret_done", batch))
            seq += 1

        def start_gen(t):
            nonlocal seq, gen_busy_flag, gpu_busy
            if gen_busy_flag or not ctx_q:
                return
            backlog = len(ctx_q)
            if s.mode == "static_batch":
                b = min(s.static_batch or s.max_batch, backlog)
            else:
                b = self.gen_sched.choose_batch(backlog)
            if b <= 0:
                return
            batch = [ctx_q.pop(0) for _ in range(min(b, backlog))]
            p = self._placement(len(batch))
            dur = self._gen_time(len(batch))
            for r in batch:
                r.t_gen_start = t
                r.t_gen_end = t + dur
            self.gen_sched.observe(len(batch), dur)
            gpu_busy += dur
            gen_busy_flag = True
            trace.append({"t": t, "batch": len(batch),
                          "P": p.resident_partitions, "c_gpu": p.c_gpu,
                          "w_gpu": p.w_gpu, "backlog": backlog,
                          "nprobe": self._nprobe(p)
                          or self.cost.num_partitions})
            heapq.heappush(ev, (t + dur, seq, "gen_done", batch))
            seq += 1

        while ev and len(done) < n:
            now, _, kind, payload = heapq.heappop(ev)
            if kind == "arrive":
                ret_q.append(payload)
            elif kind == "ret_done":
                ctx_q.extend(payload)
                ret_busy = False
            elif kind == "gen_done":
                done.extend(payload)
                gen_busy_flag = False
            start_ret(now)
            start_gen(now)
        return SimResult(requests=done, policy_trace=trace,
                         gpu_busy=gpu_busy, cpu_busy=cpu_busy, horizon=now)
