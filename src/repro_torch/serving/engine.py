"""RAGDoll serving engines (real, thread-driven).

``RagdollEngine`` runs decoupled retrieval and generation pipelines: a
retrieval ``PipelineWorker`` embeds each batch of queries and searches
the IVF store (partitions streamed from disk, scored on the device).
The generation stage has two disciplines, chosen by the generator type:

* a whole-batch :class:`~repro_torch.serving.generator.Generator` runs
  behind a classic ``PipelineWorker`` (pop a batch, generate, forward);
* a :class:`~repro_torch.serving.generator.ContinuousGenerator` runs
  behind a ``StepPumpWorker``: requests are admitted into free KV slots
  at any decode step and leave the moment they finish.  Admission,
  preemption and resume are owned by a
  :class:`~repro_torch.serving.reqsched.RequestScheduler`: when a join
  would wait on pages or slots while a slot of no higher priority is live,
  the pump swaps that slot to the host (``partial_swap=True``: only the
  pages the join needs) and brings parked requests back once the backlog
  of their class clears.

The placement optimizer (``optimizer``) is the paper's policy: at every
policy boundary (``policy_every`` decode steps on the continuous path,
every batch on the whole-batch path) the engine picks the generation
batch from the backlog, solves the joint placement for it, retargets the
partition cache, the IVF probe width and the streamer's host budget, and
clears the device-byte market: live KV pages, the prefix-cache cap, the
host swap pool and the device-hot partitions, funded out of one pool and
applied to the generator by the request scheduler.  Each decision is
journalled as a :class:`PolicyEvent` (``policy_trace``).  Without an
optimizer the boundary returns at once.  Retrieval runs on one shard;
sharded retrieval comes with a later slice of the port.

``SerialRAGEngine`` is the baseline shape (vLLMRAG/AccRAG-style) that the
paper measures against: one worker retrieves, then generates, each batch
in arrival order.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.pipeline import (Pipeline, PipelineWorker, StageQueue,
                                       StepPumpWorker, build_pipeline)
from repro_torch.core.placement import PlacementOptimizer
from repro_torch.core.prefetch import PrefetchPolicy
from repro_torch.core.scheduler import BacklogScheduler
from repro_torch.obs.metrics import NULL_REGISTRY, MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.retrieval.cache import HotPartitionSet, PartitionCache
from repro_torch.retrieval.streamer import PartitionStreamer
from repro_torch.retrieval.vectorstore import SearchStats, VectorStore
from repro_torch.serving.generator import ContinuousGenerator, Generator
from repro_torch.serving.reqsched import RequestScheduler
from repro_torch.serving.request import Request


@dataclass
class PolicyEvent:
    t: float
    gen_batch: int
    resident_partitions: int
    c_gpu: float
    w_gpu: float
    nprobe: Optional[int] = None
    gen_slots: Optional[int] = None    # live slot-table capacity
    kv_pages: Optional[int] = None     # paged pool budget (paged only)
    kv_host_pages: Optional[int] = None  # host swap-pool budget (c_cpu)
    parked: Optional[int] = None       # requests swapped out right now
    prefix_pages: Optional[int] = None   # prefix-cache device-page cap
    prefix_hit_tokens: Optional[int] = None  # cumulative cached tokens
    hot_partitions: Optional[int] = None  # device-hot IVF partitions
    hot_bytes: Optional[int] = None       # device bytes they occupy
    hot_hit_rate: Optional[float] = None  # observed hot-answered probe frac


class RagdollEngine:
    def __init__(self, store: VectorStore, embedder,
                 generator: Generator,
                 ret_scheduler: BacklogScheduler,
                 gen_scheduler: BacklogScheduler,
                 optimizer: Optional[PlacementOptimizer] = None,
                 initial_partitions: Optional[int] = None,
                 streamer: Optional[PartitionStreamer] = None,
                 retrieval_shards: int = 1,
                 aging_s: float = 30.0,
                 partial_swap: bool = False,
                 policy_every: int = 8,
                 device: DeviceLike = None,
                 tracer=None, registry=None):
        if retrieval_shards != 1:
            raise NotImplementedError("sharded retrieval: a later slice")
        self.device = resolve_device(device)
        self.store = store
        self.embedder = embedder
        self.generator = generator
        # decode steps between policy boundaries on the continuous path
        self.policy_every = policy_every
        self.continuous = isinstance(generator, ContinuousGenerator)
        self.opt = optimizer
        self.tracer = tracer or NULL_TRACER
        # the engine's registry defaults to a REAL per-engine registry
        # (not the global no-op): policy-boundary decisions journal
        # through it, and ``policy_trace`` reads them back
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        if self.opt is not None:
            # hand the engine's obs plumbing down unless the caller
            # wired the optimizer to its own
            if self.opt.tracer is NULL_TRACER:
                self.opt.tracer = self.tracer
            if self.opt.registry is NULL_REGISTRY:
                self.opt.registry = self.registry
        if self.continuous:
            generator.bind_obs(self.tracer, self.registry)
        p0 = (initial_partitions if initial_partitions is not None
              else len(store.partitions))
        self.pcache = PartitionCache(store, target=p0)
        self._owns_streamer = streamer is None
        self.streamer = streamer if streamer is not None else \
            PartitionStreamer(store, PrefetchPolicy(max_depth=2),
                              tracer=self.tracer)
        if not self._owns_streamer and self.streamer.tracer is NULL_TRACER:
            self.streamer.tracer = self.tracer
        # device-hot partition tier: inert (budget 0) until a placement
        # grants it bytes
        self.hot = HotPartitionSet(store, device=self.device,
                                   tracer=self.tracer,
                                   registry=self.registry)
        self.nprobe: Optional[int] = None   # set by the placement policy
        self.retrieval_stats = SearchStats()   # cumulative, for reporting
        self.completed: List[Request] = []
        self._done_lock = threading.Lock()
        # completion wakeup: ``drain`` waits on this instead of polling
        self._done_cv = threading.Condition(self._done_lock)
        # open async "request" spans (submit -> harvest), keyed by rid
        self._req_spans: Dict[int, object] = {}
        if self.continuous:
            rq, cq, dq = (StageQueue("retrieval"), StageQueue("context"),
                          StageQueue("done"))
            rw = PipelineWorker("retrieval", rq, cq, self._retrieve_batch,
                                ret_scheduler,
                                on_batch_boundary=self._ret_boundary)
            self.scheduler: Optional[RequestScheduler] = RequestScheduler(
                generator, cq, aging_s=aging_s, partial_swap=partial_swap,
                tracer=self.tracer, registry=self.registry)
            gw = StepPumpWorker(
                "generation", cq, dq,
                capacity_fn=self.scheduler.capacity,
                admit_fn=self.scheduler.admit,
                step_fn=self._generate_step,
                on_policy_boundary=self._gen_boundary,
                policy_every=policy_every)
            self.pipeline = Pipeline(retrieval_queue=rq, context_queue=cq,
                                     done_queue=dq, workers=[rw, gw])
        else:
            self.scheduler = None
            self.pipeline = build_pipeline(
                self._retrieve_batch, self._generate_batch,
                ret_scheduler, gen_scheduler,
                on_ret_boundary=self._ret_boundary,
                on_gen_boundary=self._gen_boundary)
        self.gen_scheduler = gen_scheduler

    # ------------------------------------------------------------- stages
    def _retrieve_batch(self, reqs: List[Request]) -> List[Request]:
        with self.tracer.scope(*(r.rid for r in reqs)), \
                self.tracer.span("retrieve.batch", batch=len(reqs)):
            t0 = time.perf_counter()
            with self.tracer.span("embed", batch=len(reqs)):
                queries = self.embedder.embed([r.query for r in reqs])
            with self.tracer.span("search", top_k=reqs[0].top_k):
                scores, ids = self.store.search(
                    queries, reqs[0].top_k, nprobe=self.nprobe,
                    streamer=self.streamer, stats=self.retrieval_stats,
                    hot=self.hot)
            chunks = self.store.get_chunks(ids)
            t1 = time.perf_counter()
        if self.registry.enabled:
            self.registry.counter("engine.retrieve_batches").inc()
            self.registry.histogram("retrieve.seconds").observe(t1 - t0)
        for r, ch in zip(reqs, chunks):
            r.retrieved = ch
            r.prompt = " ".join(ch) + " " + r.query
            r.t_ret_start, r.t_ret_end = t0, t1
        return reqs

    def _harvest_obs(self, done: List[Request]) -> None:
        """Close each finished request's async span, record latencies."""
        for r in done:
            self.tracer.end(self._req_spans.pop(r.rid, None))
        if not self.registry.enabled:
            return
        self.registry.counter("engine.completed").inc(len(done))
        lat = self.registry.histogram("request.latency_seconds")
        wait = self.registry.histogram("request.waiting_seconds")
        for r in done:
            if not r.complete:
                continue
            lat.observe(r.latency)
            wait.observe(r.waiting)

    def _generate_batch(self, reqs: List[Request]) -> List[Request]:
        t0 = time.perf_counter()
        with self.tracer.span("generate.batch", batch=len(reqs),
                              trace_ids=[r.rid for r in reqs]):
            outs = self.generator.generate([r.prompt for r in reqs])
        t1 = time.perf_counter()
        for r, o in zip(reqs, outs):
            r.output = o
            r.t_gen_start, r.t_gen_end = t0, t1
        self._harvest_obs(reqs)
        with self._done_cv:
            self.completed.extend(reqs)
            self._done_cv.notify_all()
        return reqs

    # --------------------------------------- continuous generation stage
    def _generate_step(self) -> Optional[List[Request]]:
        """One decode step over the slot table; returns rows that left."""
        t0 = time.perf_counter()
        self.scheduler.tick()
        stepped = self.generator.step()
        finished = self.generator.harvest()
        if not stepped and not finished:
            return None            # idle: no live slots
        t = time.perf_counter()
        if stepped:
            self.gen_scheduler.observe(stepped, t - t0)
            if self.registry.enabled:
                self.registry.histogram("decode.step_seconds").observe(
                    t - t0)
        done: List[Request] = []
        for req, text, _tokens in finished:
            req.output = text
            req.t_gen_end = t
            done.append(req)
        if done:
            self.scheduler.note_done(done)
            self._harvest_obs(done)
            with self._done_cv:
                self.completed.extend(done)
                self._done_cv.notify_all()
        return done

    # ---------------------------------------------- lazy reconfiguration
    def _ret_boundary(self) -> None:
        pass  # partition target applied by _gen_boundary's placement

    def _gen_boundary(self) -> None:
        if self.opt is None:
            return
        backlog = len(self.pipeline.context_queue)
        if self.continuous:
            # requests already decoding in slots are part of the live
            # batch the placement must provision for
            backlog += self.generator.active_slots
        b = max(self.gen_scheduler.choose_batch(max(backlog, 1)), 1)
        placement = self.opt.solve(b)
        self.pcache.set_target(placement.resident_partitions)
        self.nprobe = placement.nprobe
        # ONE device-byte market clears every elastic device-memory
        # consumer (live KV pages, the prefix-cache cap, swap headroom and
        # device-hot partitions) from the observed per-partition heat, so
        # the budgets can never over-commit in aggregate
        stats = self.retrieval_stats
        ranking = stats.hot_ranking()
        paged = getattr(self.generator, "paged", False)
        # the live pool format is the market's bits-per-token dimension
        split = self.opt.market(
            placement,
            page_size=self.generator.page_size if paged else None,
            partition_heat=stats.heat(),
            kv_format=self.generator.kv_format if paged else None,
            priority_pressure=(self.scheduler.priority_pressure()
                               if self.scheduler is not None else 0.0))
        # the scheduler applies the clearing: it fences queued swap
        # copies, then retargets the slot table and, for a paged
        # generator, both KV tiers and the prefix cap
        applied = (self.scheduler.apply_split(b, split)
                   if self.scheduler is not None else {})
        # hot tier under the market's byte grant: promote down the
        # observed heat ranking, demote what no longer fits
        self.hot.retarget(split.hot_bytes, ranking)
        stats.decay()     # age the heat so the ranking tracks live skew
        # the streamer's lookahead follows the host memory the live
        # placement leaves free
        hw = self.opt.cost.hw
        host_free = (hw.cpu_mem * hw.mem_headroom
                     - self.opt.memory_use(placement).cpu)
        self.streamer.set_budget(max(host_free, 0.0))
        ev = PolicyEvent(
            t=time.perf_counter(), gen_batch=b,
            resident_partitions=placement.resident_partitions,
            c_gpu=placement.c_gpu, w_gpu=placement.w_gpu,
            nprobe=placement.nprobe,
            gen_slots=applied.get("slots"),
            kv_pages=applied.get("pages"),
            kv_host_pages=applied.get("host_pages"),
            parked=getattr(self.generator, "parked_slots", None),
            prefix_pages=applied.get("prefix_pages"),
            prefix_hit_tokens=getattr(self.generator, "prefix_hit_tokens",
                                      None),
            hot_partitions=len(self.hot), hot_bytes=self.hot.device_bytes(),
            hot_hit_rate=stats.hot_hit_rate)
        # policy decisions journal through the metrics registry as
        # structured events; ``policy_trace`` reads them back
        self.registry.event("policy", **dataclasses.asdict(ev))
        self.tracer.instant("policy.boundary", gen_batch=b,
                            nprobe=placement.nprobe)

    @property
    def policy_trace(self) -> List[PolicyEvent]:
        """Policy-boundary decisions, oldest first (from the registry's
        event journal, bounded, so very long runs keep the tail)."""
        return [PolicyEvent(**{k: v for k, v in e.items()
                               if k not in ("seq", "kind")})
                for e in self.registry.events("policy")]

    def metrics_snapshot(self) -> Dict[str, object]:
        """One coherent dict of every subsystem's counters: sync the
        pull-style sources (search stats, prefix cache, pools, slots) into
        registry gauges, then snapshot."""
        reg = self.registry
        if reg.enabled:
            for name, val in self.retrieval_stats.snapshot().items():
                reg.gauge(f"search.{name}").set(float(val))
            gen = self.generator
            for name in ("active_slots", "parked_slots", "peak_in_flight",
                         "prefix_hit_tokens"):
                val = getattr(gen, name, None)
                if val is not None:
                    reg.gauge(f"gen.{name}").set(float(val))
            kv = getattr(gen, "kv", None)
            if kv is not None:
                reg.gauge("kv.pages_used").set(float(kv.pool.used_pages))
                reg.gauge("kv.pages_capacity").set(float(kv.pool.capacity))
                host = kv.host
                if host is not None:
                    reg.gauge("kv.host_pages_used").set(
                        float(host.used_pages))
                    reg.gauge("kv.host_pages_capacity").set(
                        float(host.capacity))
            prefix = getattr(gen, "prefix", None)
            if prefix is not None:
                for name, val in dataclasses.asdict(prefix.stats).items():
                    reg.gauge(f"prefix.{name}").set(float(val))
            reg.gauge("hot.partitions").set(float(len(self.hot)))
            reg.gauge("engine.completed_total").set(
                float(len(self.completed)))
        return reg.snapshot()

    # ------------------------------------------------------------- public
    def pump_once(self) -> int:
        """One synchronous generation-pump iteration: capacity probe ->
        admit from the context queue -> decode step: the
        ``StepPumpWorker`` loop body minus the thread and minus the
        ``policy_every`` boundary (mini-traces rely on their constructed
        slot and page budgets staying put; a caller that wants a boundary
        calls ``_gen_boundary``).  The deterministic seam for tests.
        Returns the number of requests completed so far."""
        if not self.continuous:
            raise ValueError("pump_once requires a continuous generator")
        free = self.scheduler.capacity()
        items = self.pipeline.context_queue.pop_batch(free) if free > 0 \
            else []
        if items:
            self.scheduler.admit(items)
        self._generate_step()
        with self._done_lock:
            return len(self.completed)

    def start(self) -> None:
        self.pipeline.start()

    def stop(self) -> None:
        self.pipeline.stop()
        if self._owns_streamer:     # an injected streamer outlives us
            self.streamer.close()

    def submit(self, req: Request) -> None:
        req.arrival = time.perf_counter() if req.arrival is None \
            else req.arrival
        if self.tracer.enabled:
            self._req_spans[req.rid] = self.tracer.begin(
                "request", rid=req.rid, trace_ids=[req.rid])
        if self.scheduler is not None:
            self.scheduler.note_queued(req)
        self.pipeline.retrieval_queue.put(req)

    def drain(self, n: int, timeout: float = 120.0) -> List[Request]:
        """Block until ``n`` requests have completed.  Raises
        :class:`TimeoutError` naming the in-flight rids instead of
        returning fewer than ``n``."""
        deadline = time.monotonic() + timeout
        with self._done_cv:
            while len(self.completed) < n:
                left = deadline - time.monotonic()
                if left <= 0 or not self._done_cv.wait(timeout=left):
                    if len(self.completed) >= n:
                        break
                    stuck = (self.scheduler.in_flight_rids()
                             if self.scheduler is not None else [])
                    snap = (self.scheduler.snapshot()
                            if self.scheduler is not None else {})
                    raise TimeoutError(
                        f"drain({n}) timed out after {timeout:.1f}s with "
                        f"{len(self.completed)}/{n} completed; in-flight "
                        f"rids={stuck}; scheduler={snap}")
            return list(self.completed)


class SerialRAGEngine:
    """Baseline: serial retrieve-then-generate, arrival order, one thread.

    It searches without a partition streamer, as the reference does: each
    spilled partition is read from disk when its sweep reaches it.
    ``device`` (CUDA unless the caller asks for the CPU) must be the one
    the store and the generator run on."""

    def __init__(self, store: VectorStore, embedder, generator: Generator,
                 batch_size: int = 4, device: DeviceLike = None):
        self.device = resolve_device(device)
        if store.device != self.device or generator.device != self.device:
            raise ValueError(f"store on {store.device} and generator on "
                             f"{generator.device}, engine on {self.device}")
        self.store = store
        self.embedder = embedder
        self.generator = generator
        self.batch_size = batch_size
        self.queue: List[Request] = []
        self.completed: List[Request] = []
        self._lock = threading.Lock()
        # one condition doubles as the submit wakeup (worker waits for
        # arrivals) and the completion wakeup (drain waits for results)
        self._cv = threading.Condition(self._lock)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()       # wake the worker so it can exit
        self._thread.join(timeout=5.0)

    def submit(self, req: Request) -> None:
        with self._cv:
            self.queue.append(req)
            self._cv.notify_all()

    def _run(self) -> None:
        while not self._stop.is_set():
            with self._cv:
                while not self.queue and not self._stop.is_set():
                    self._cv.wait()     # stop() notifies under the cv
                batch = self.queue[:self.batch_size]
                self.queue = self.queue[len(batch):]
            if not batch:
                continue
            t0 = time.perf_counter()
            queries = self.embedder.embed([r.query for r in batch])
            scores, ids = self.store.search(queries, batch[0].top_k)
            chunks = self.store.get_chunks(ids)
            t1 = time.perf_counter()
            for r, ch in zip(batch, chunks):
                r.retrieved = ch
                r.prompt = " ".join(ch) + " " + r.query
                r.t_ret_start, r.t_ret_end = t0, t1
            outs = self.generator.generate([r.prompt for r in batch])
            t2 = time.perf_counter()
            for r, o in zip(batch, outs):
                r.output = o
                r.t_gen_start, r.t_gen_end = t1, t2
            with self._cv:
                self.completed.extend(batch)
                self._cv.notify_all()

    def drain(self, n: int, timeout: float = 120.0) -> List[Request]:
        """Block until ``n`` requests have completed.  Raises
        :class:`TimeoutError` naming the still-queued rids instead of
        silently returning fewer than ``n``."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while len(self.completed) < n:
                left = deadline - time.monotonic()
                if left <= 0 or not self._cv.wait(timeout=left):
                    if len(self.completed) >= n:
                        break
                    queued = [r.rid for r in self.queue]
                    raise TimeoutError(
                        f"drain({n}) timed out after {timeout:.1f}s with "
                        f"{len(self.completed)}/{n} completed; queued "
                        f"rids={queued}")
            return list(self.completed)
