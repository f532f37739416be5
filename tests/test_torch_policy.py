"""The port's policy boundary against the JAX engine's, on the CPU.

* Side-by-side mini-traces: the JAX ``RagdollEngine`` and the port's, each
  with the same placement optimizer (tiny cost model), the same IVF store
  (1024 x 32 blob corpus, 8 partitions, 2 spilled; a host of 60 kB, so
  one partition stays resident) and the same converted
  weights, driven single-threaded (``pump_once`` with ``_gen_boundary``
  every 2 pumps on the continuous path; ``_generate_batch`` then
  ``_gen_boundary`` on the whole-batch path; one boundary first, so every
  retrieval probes), with the queries in one partition so the market funds
  the hot tier.  Every boundary's
  ``PolicyEvent`` (all fields but ``t``), probe width, hot set, resident
  set and slot, page and host-page capacity must be equal, and so must
  every request's retrieved chunks and tokens.  The generation scheduler
  is seeded and does not learn from wall-clock step times, so both
  engines choose the same batch.
* IVF probe parity: ``VectorStore.search`` at ``nprobe`` 1, P/4 and P/2,
  with and without the streamer and with a funded hot tier, returns the
  JAX store's ids exactly and its scores within 1e-4.
* The engine contracts of ``tests/test_hot_tier.py`` (the boundary funds
  the hot tier), ``tests/test_paged.py`` (it retargets capacity) and
  ``tests/test_obs.py`` (``metrics_snapshot``; ``policy_trace == []``
  under ``pump_once``).
* The release/promotion races: a release that lands between a sweep's or
  a promotion's check of a partition and its read of the array.
"""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.core.costmodel import CostModel as JaxCostModel
from repro.core.costmodel import ModelProfile as JaxModelProfile
from repro.core.costmodel import PF_HIGH as JAX_PF_HIGH
from repro.core.placement import PlacementOptimizer as JaxOptimizer
from repro.core.prefetch import PrefetchPolicy as JaxPrefetchPolicy
from repro.core.scheduler import BacklogScheduler as JaxBacklogScheduler
from repro.models.model import Model as JaxModel
from repro.retrieval.cache import HotPartitionSet as JaxHotPartitionSet
from repro.retrieval.streamer import PartitionStreamer as JaxStreamer
from repro.retrieval.synthetic import ArrayEmbedder as JaxArrayEmbedder
from repro.retrieval.synthetic import blob_corpus as jax_blob_corpus
from repro.retrieval.vectorstore import SearchStats as JaxSearchStats
from repro.retrieval.vectorstore import VectorStore as JaxVectorStore
from repro.serving.engine import RagdollEngine as JaxEngine
from repro.serving.generator import ContinuousGenerator as JaxContinuous
from repro.serving.generator import Generator as JaxGenerator
from repro.serving.generator import GeneratorConfig as JaxGeneratorConfig
from repro.serving.request import Request as JaxRequest

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.costmodel import GB, PF_HIGH, CostModel, ModelProfile
from repro_torch.core.placement import Placement, PlacementOptimizer
from repro_torch.core.prefetch import PrefetchPolicy
from repro_torch.core.scheduler import BacklogScheduler
from repro_torch.retrieval import HashEmbedder
from repro_torch.retrieval.cache import HotPartitionSet
from repro_torch.retrieval.streamer import PartitionStreamer
from repro_torch.retrieval.synthetic import ArrayEmbedder, blob_corpus
from repro_torch.retrieval.vectorstore import SearchStats, VectorStore
from repro_torch.serving import (ContinuousGenerator, Generator,
                                 GeneratorConfig, RagdollEngine, Request)
from repro_torch.serving.engine import PolicyEvent

N_DOCS, DIM, PARTS, SPILLED = 1024, 32, 8, (6, 7)
CTX, MAX_NEW, PAGE, CHUNK, SLOTS = 32, 4, 8, 16, 3
EVERY = 2                     # pumps between policy boundaries
SEED_SAMPLES = [(1.0, 1.0), (4.0, 1.5)]   # T(B) ~ B^0.29: max batch wins


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_config("llama3-8b").reduced(num_layers=2)
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(0),
                                               jnp.float32)
    cfg = get_config("llama3-8b").reduced(num_layers=2)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu", dtype=torch.float32)
    return cfg, params, jcfg, jparams


def _stores(root, spill=SPILLED):
    vecs = blob_corpus(N_DOCS, DIM, clusters=PARTS, seed=9)
    jvecs = jax_blob_corpus(N_DOCS, DIM, clusters=PARTS, seed=9)
    assert np.array_equal(vecs, jvecs)
    texts = [str(i) for i in range(N_DOCS)]
    store = VectorStore.build(texts, ArrayEmbedder(vecs),
                              num_partitions=PARTS, root=str(root / "torch"),
                              seed=9, device="cpu")
    jstore = JaxVectorStore.build(texts, JaxArrayEmbedder(jvecs),
                                  num_partitions=PARTS,
                                  root=str(root / "jax"), seed=9)
    for pid in range(PARTS):
        assert np.array_equal(store.partitions[pid].doc_ids,
                              jstore.partitions[pid].doc_ids)
    for pid in spill:
        store.spill(pid)
        jstore.spill(pid)
    return store, jstore, vecs


def _optimizers(store, rows=N_DOCS / PARTS, **hw):
    """``tests/test_hot_tier.py``'s tiny optimizer in both packages: a
    reduced llama3-8b on PF-High with a slow disk, priced on this store's
    largest partition and ``rows`` rows a partition; ``hw`` overrides more
    profile fields."""
    kw = dict(partition_bytes=float(store.partition_bytes()),
              num_partitions=store.num_partitions, db_dim=DIM,
              chunks_per_partition=rows,
              partition_mem_overhead=1.0)
    mp = ModelProfile.from_config(get_config("llama3-8b").reduced(num_layers=8))
    jmp = JaxModelProfile.from_config(
        jax_get_config("llama3-8b").reduced(num_layers=8))
    opt = PlacementOptimizer(
        CostModel(dataclasses.replace(PF_HIGH, disk_read_bw=1e6, **hw), mp,
                  **kw),
        avg_ctx_len=16, avg_out_len=16)
    jopt = JaxOptimizer(
        JaxCostModel(dataclasses.replace(JAX_PF_HIGH, disk_read_bw=1e6, **hw),
                     jmp, **kw), avg_ctx_len=16, avg_out_len=16)
    return opt, jopt


class _Seeded(BacklogScheduler):
    """Seeded once; ignores wall-clock samples so both engines agree."""

    def observe(self, batch, seconds):
        pass


class _JaxSeeded(JaxBacklogScheduler):
    def observe(self, batch, seconds):
        pass


def _schedulers(cls):
    gen = cls(max_batch=SLOTS)
    gen.seed(SEED_SAMPLES)
    return cls(max_batch=8), gen


def _hot_queries(store, n):
    """Doc ids of partition 0, so its heat dominates."""
    return [str(int(d)) for d in store.partitions[0].doc_ids[:n]]


def _waves(cls, queries, size=4):
    reqs = [cls(rid=i, query=q, arrival=0.0, top_k=5,
                max_new_tokens=MAX_NEW, priority=int(i % 3 == 2))
            for i, q in enumerate(queries)]
    return [reqs[i:i + size] for i in range(0, len(reqs), size)]


def _observe(eng, store, rows):
    ev = dataclasses.asdict(eng.policy_trace[-1])
    ev.pop("t")
    gen = eng.generator
    caps = ((gen.num_slots, gen.kv.pool.capacity, gen.kv.host.capacity)
            if getattr(gen, "paged", False) else None)
    rows.append(dict(event=ev, nprobe=eng.nprobe, hot=eng.hot.pids(),
                     resident=sorted(store.resident_set()), caps=caps,
                     target=eng.pcache.target))


def _drive_continuous(eng, store, waves):
    rows, pumps = [], 0
    eng._gen_boundary()          # the probe width for the first retrieval
    _observe(eng, store, rows)

    def pump():
        nonlocal pumps
        done = eng.pump_once()
        pumps += 1
        if pumps % EVERY == 0:
            eng._gen_boundary()
            _observe(eng, store, rows)
        return done

    total = 0
    for wave in waves:
        eng._retrieve_batch(wave)
        eng.pipeline.context_queue.put_many(wave)
        total += len(wave)
        for _ in range(3):
            pump()
    guard = 0
    while pump() < total:
        guard += 1
        assert guard < 400, "mini-trace stalled"
    return sorted(eng.completed, key=lambda r: r.rid), rows


def _drive_batches(eng, store, waves):
    rows, batch = [], 2
    eng._gen_boundary()          # the probe width for the first retrieval
    _observe(eng, store, rows)
    for wave in waves:
        eng._retrieve_batch(wave)
        eng.pipeline.context_queue.put_many(wave)
        eng._generate_batch(eng.pipeline.context_queue.pop_batch(batch))
        eng._gen_boundary()
        _observe(eng, store, rows)
        batch = rows[-1]["event"]["gen_batch"]
    while len(eng.pipeline.context_queue):
        eng._generate_batch(eng.pipeline.context_queue.pop_batch(batch))
        eng._gen_boundary()
        _observe(eng, store, rows)
        batch = rows[-1]["event"]["gen_batch"]
    return sorted(eng.completed, key=lambda r: r.rid), rows


def _side_by_side(tmp_path, weights, continuous):
    cfg, params, jcfg, jparams = weights
    store, jstore, vecs = _stores(tmp_path)
    # 60 kB of host memory: one partition stays resident, so disk loads
    # dominate retrieval and the solver prunes to the least probe width;
    # a hot partition priced at the largest one's rows, so a grant of one
    # holds any partition
    opt, jopt = _optimizers(store, rows=store.partition_bytes() / (4 * DIM),
                            cpu_mem=6e4)
    queries = _hot_queries(store, 12)
    g = GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW)
    jg = JaxGeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW)
    if continuous:
        gen = ContinuousGenerator(cfg, params, g, num_slots=SLOTS, paged=True,
                                  page_size=PAGE, prefill_chunk=CHUNK,
                                  device="cpu")
        jgen = JaxContinuous(jcfg, jparams, jg, num_slots=SLOTS, paged=True,
                             page_size=PAGE, prefill_chunk=CHUNK)
        drive = _drive_continuous
    else:
        gen = Generator(cfg, params, g, device="cpu")
        jgen = JaxGenerator(jcfg, jparams, jg)
        drive = _drive_batches
    eng = RagdollEngine(store, ArrayEmbedder(vecs), gen,
                        *_schedulers(_Seeded), optimizer=opt,
                        initial_partitions=PARTS - len(SPILLED),
                        policy_every=EVERY, device="cpu")
    jeng = JaxEngine(jstore, JaxArrayEmbedder(vecs), jgen,
                     *_schedulers(_JaxSeeded), optimizer=jopt,
                     initial_partitions=PARTS - len(SPILLED),
                     policy_every=EVERY)
    try:
        jreqs, jrows = drive(jeng, jstore, _waves(JaxRequest, queries))
        reqs, rows = drive(eng, store, _waves(Request, queries))
    finally:
        eng.streamer.close()
        jeng.streamer.close()
    return reqs, rows, jreqs, jrows


@pytest.mark.parametrize("continuous", [True, False],
                         ids=["continuous", "whole-batch"])
def test_policy_minitrace_matches_jax_engine(tmp_path, weights, continuous):
    reqs, rows, jreqs, jrows = _side_by_side(tmp_path, weights, continuous)
    assert len(rows) == len(jrows) >= 4
    for i, (got, want) in enumerate(zip(rows, jrows)):
        assert got == want, f"boundary {i}"
    assert [r.rid for r in reqs] == [r.rid for r in jreqs] == list(range(12))
    for r, j in zip(reqs, jreqs):
        assert r.retrieved == j.retrieved, r.rid
        assert len(r.output.split()) == MAX_NEW
        assert r.output == j.output, r.rid
    # the trace exercised the policy: the market funded the hot tier, the
    # probe width pruned partitions, and (continuous) capacity moved
    assert any(row["event"]["hot_partitions"] for row in rows)
    assert any(row["nprobe"] is not None and row["nprobe"] < PARTS
               for row in rows)
    if continuous:
        assert len({row["caps"] for row in rows}) > 1


# ------------------------------------------------------ IVF probe parity
@pytest.mark.parametrize("nprobe", [1, PARTS // 4, PARTS // 2])
@pytest.mark.parametrize("streamed", [False, True],
                         ids=["no-streamer", "streamer"])
@pytest.mark.parametrize("hot", [0, 2], ids=["cold", "hot2"])
def test_ivf_probe_matches_jax_store(tmp_path, nprobe, streamed, hot):
    store, jstore, vecs = _stores(tmp_path)
    rng = np.random.default_rng(nprobe)
    q = vecs[rng.choice(N_DOCS, 6, replace=False)] \
        + 0.05 * rng.standard_normal((6, DIM)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    kw, jkw = {}, {}
    if hot:
        part = store.partitions[0].nbytes + store.partitions[6].nbytes
        kw["hot"] = HotPartitionSet(store, device="cpu")
        kw["hot"].retarget(part, [6, 0])
        jkw["hot"] = JaxHotPartitionSet(jstore)
        jkw["hot"].retarget(part, [6, 0])
        assert kw["hot"].pids() == jkw["hot"].pids() == [0, 6]
    if streamed:
        kw["streamer"] = PartitionStreamer(store, PrefetchPolicy(max_depth=2))
        jkw["streamer"] = JaxStreamer(jstore, JaxPrefetchPolicy(max_depth=2))
    stats, jstats = SearchStats(), JaxSearchStats()
    try:
        s, i = store.search(q, 5, nprobe=nprobe, stats=stats, **kw)
        js, ji = jstore.search(q, 5, nprobe=nprobe, stats=jstats, **jkw)
    finally:
        for k in (kw, jkw):
            if "streamer" in k:
                k["streamer"].close()
    assert np.array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(s, np.asarray(js), atol=1e-4, rtol=0)
    assert stats.snapshot().keys() == jstats.snapshot().keys()
    for name in ("partitions_searched", "partitions_pruned", "hot_hits"):
        assert getattr(stats, name) == getattr(jstats, name), name
    # a real probe mask: each query keeps nprobe of the partitions
    assert (store.probe(q, nprobe)[1].sum(axis=1) == nprobe).all()
    assert stats.heat() == jstats.heat()


# -------------------------------------------------- engine contracts
def test_engine_policy_boundary_funds_hot_tier(tmp_path):
    """``tests/test_hot_tier.py::test_engine_policy_boundary_funds_hot_tier``:
    skewed retrieval traffic ends with a funded hot tier in the
    PolicyEvent, and later sweeps answer probes from the device tier."""
    store, _, vecs = _stores(tmp_path, spill=range(PARTS))
    opt, _ = _optimizers(store)
    eng = RagdollEngine(store, ArrayEmbedder(vecs), generator=None,
                        ret_scheduler=BacklogScheduler(max_batch=8),
                        gen_scheduler=BacklogScheduler(max_batch=8),
                        optimizer=opt, device="cpu")
    fixed = opt.project(Placement(1.0, 0.0, 1.0, 0.0, 0, 8, nprobe=2))
    eng.opt.solve = lambda b: fixed
    hot_rows = store.partitions[0].doc_ids
    try:
        for b in range(3):
            eng._retrieve_batch([Request(rid=b * 8 + i,
                                         query=str(int(hot_rows[i])),
                                         arrival=0.0) for i in range(8)])
            eng._gen_boundary()
        ev = eng.policy_trace[-1]
        assert isinstance(ev, PolicyEvent)
        assert ev.hot_partitions and ev.hot_partitions > 0
        assert ev.hot_bytes == eng.hot.device_bytes() > 0
        assert 0 in eng.hot
        before = eng.retrieval_stats.hot_hits
        eng._retrieve_batch([Request(rid=99, query=str(int(hot_rows[0])),
                                     arrival=0.0)])
        assert eng.retrieval_stats.hot_hits > before
        assert ev.hot_hit_rate is not None and ev.hot_hit_rate >= 0.0
        # the optimizer journals through the engine's registry
        assert eng.opt.registry is eng.registry
        assert len(eng.registry.events("market")) == 3
    finally:
        eng.streamer.close()


def test_engine_policy_boundary_retargets_capacity(tmp_path, weights):
    """``tests/test_paged.py::test_engine_policy_boundary_retargets_capacity``:
    the boundary resizes the slot table and the paged pool's page budget
    from the live placement, and the generator still decodes after it."""
    cfg, params, _, _ = weights
    ctx = 16
    gen = ContinuousGenerator(cfg, params, GeneratorConfig(
        ctx_len=ctx, max_new_tokens=4), num_slots=2, paged=True, page_size=4,
        device="cpu")
    mp = ModelProfile.from_config(get_config("llama3-8b"))
    opt = PlacementOptimizer(CostModel(PF_HIGH, mp, partition_bytes=8 * GB,
                                       num_partitions=8), 512, 32,
                             kv_page_size=4)
    emb = HashEmbedder(dim=16)
    store = VectorStore.build([f"doc {i}" for i in range(40)], emb,
                              num_partitions=4, root=str(tmp_path),
                              device="cpu")
    eng = RagdollEngine(store, emb, gen, BacklogScheduler(max_batch=8),
                        BacklogScheduler(max_batch=8), optimizer=opt,
                        device="cpu")
    try:
        eng._gen_boundary()
        ev = eng.policy_trace[-1]
        assert ev.gen_slots == gen.num_slots           # table retargeted
        assert ev.kv_pages == gen.kv.pool.capacity     # budget retargeted
        assert gen.kv.pool.capacity >= -(-(ctx + 4) // 4)   # never starved
        assert gen.join("a", "alpha beta") is not None
        while gen.active_slots:
            gen.step()
        assert {k for k, _, _ in gen.harvest()} == {"a"}
    finally:
        eng.streamer.close()


def _mini_engine(weights, root, package):
    """``tests/test_obs.py``'s mini engine in either package."""
    if package == "jax":
        from repro.retrieval import HashEmbedder as Emb
        from repro.retrieval import VectorStore as Store
        _, _, cfg, params = weights
        gen = JaxContinuous(cfg, params, JaxGeneratorConfig(
            ctx_len=16, max_new_tokens=4), num_slots=2, paged=True,
            page_size=4)
        make = JaxEngine
        sched, req, kw, skw = JaxBacklogScheduler, JaxRequest, {}, {}
    else:
        Emb, Store = HashEmbedder, VectorStore
        cfg, params, _, _ = weights
        gen = ContinuousGenerator(cfg, params, GeneratorConfig(
            ctx_len=16, max_new_tokens=4), num_slots=2, paged=True,
            page_size=4, device="cpu")
        make = RagdollEngine
        sched, req = BacklogScheduler, Request
        kw, skw = dict(device="cpu"), dict(device="cpu")
    emb = Emb(dim=16)
    store = Store.build([f"doc {i} topic{i % 3}" for i in range(40)], emb,
                        num_partitions=4, root=root, **skw)
    store.spill(3)
    eng = make(store, emb, gen, sched(max_batch=8), sched(max_batch=2),
               initial_partitions=2, **kw)
    reqs = [req(rid=i, query=f"query {i}", arrival=time.perf_counter())
            for i in range(4)]
    try:
        for r in reqs:
            eng.submit(r)
        batch = eng.pipeline.retrieval_queue.pop_batch(len(reqs))
        eng._retrieve_batch(batch)
        eng.pipeline.context_queue.put_many(batch)
        guard = 0
        while eng.pump_once() < len(reqs):
            guard += 1
            assert guard < 400, "mini engine stalled"
    finally:
        eng.streamer.close()
    return eng


def test_metrics_snapshot_matches_jax_engine(tmp_path, weights):
    """The engine half of ``tests/test_obs.py``'s tracing test: the same
    counters, gauges and histograms as the JAX engine, the reference's
    values, and no policy event under ``pump_once``."""
    eng = _mini_engine(weights, str(tmp_path / "torch"), "torch")
    jeng = _mini_engine(weights, str(tmp_path / "jax"), "jax")
    snap, jsnap = eng.metrics_snapshot(), jeng.metrics_snapshot()
    for kind in ("counters", "gauges", "histograms"):
        assert sorted(snap[kind]) == sorted(jsnap[kind]), kind
    for name, val in jsnap["gauges"].items():
        if not name.startswith(("search.load_seconds",
                                "search.search_seconds")):
            assert snap["gauges"][name] == val, name
    assert snap["counters"]["engine.retrieve_batches"] >= 1.0
    assert snap["counters"]["engine.completed"] == 4.0
    assert "kv.pages_capacity" in snap["gauges"]
    assert snap["gauges"]["search.partitions_searched"] >= 1.0
    assert snap["histograms"]["request.latency_seconds"]["count"] == 4
    assert eng.policy_trace == [] == jeng.policy_trace


# ------------------------------------------ release/promotion races
def _release_after_loads(monkeypatch, store, times):
    """The first ``times`` loads are each followed at once by a release,
    as a policy boundary on another thread (``PartitionCache.set_target``)
    can release a partition between a check and a read."""
    real_load, left = store.load, {"n": times}

    def load(pid):
        dt = real_load(pid)
        if left["n"] > 0:
            left["n"] -= 1
            store.release(pid)
        return dt

    monkeypatch.setattr(store, "load", load)
    return left


def test_sweep_survives_a_release_between_check_and_read(tmp_path,
                                                         monkeypatch):
    store, _, vecs = _stores(tmp_path, spill=range(PARTS))
    q = vecs[:3]
    want_s, want_i = store.search(q, 5)
    left = _release_after_loads(monkeypatch, store, 2)
    got_s, got_i = store.search(q, 5)
    assert left["n"] == 0
    assert np.array_equal(got_i, want_i)
    assert np.array_equal(got_s, want_s)
    assert store.resident_set() == []          # no residency leaked


def test_promotion_survives_a_release_between_check_and_read(tmp_path,
                                                             monkeypatch):
    store, _, _ = _stores(tmp_path, spill=range(PARTS))
    want = np.load(store.partitions[3].path)
    hot = HotPartitionSet(store, device="cpu")
    left = _release_after_loads(monkeypatch, store, 1)
    hot.retarget(store.partitions[3].nbytes, [3])
    assert left["n"] == 0 and hot.pids() == [3]
    emb, ids = hot.lookup(3)
    assert np.array_equal(emb.numpy(), want)
    assert np.array_equal(ids.numpy(), store.partitions[3].doc_ids)
    assert store.resident_set() == []          # no residency leaked
