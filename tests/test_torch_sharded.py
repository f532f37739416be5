"""The port's sharded IVF retrieval against the JAX package's, on the CPU.

* ``assign_partitions``: the reference's lists for S in {1, 2, 3, 4, 8},
  with and without centroids, and the assignment laws of
  ``tests/test_sharded.py``.
* ``ShardedIVFStore.search`` for S in {1, 2, 4}, nprobe in {None, 3}, with
  and without disk spills: ids equal to the port's single-host search and
  scores bit for bit; ids equal to the JAX ``ShardedIVFStore``'s and
  scores within 1e-4; the ``SearchStats`` totals equal to JAX's.
* Per-shard streamer budgets, each shard streaming only its own
  partitions, the tiny-corpus sentinels, the sharded hot sweep bit-equal
  to the cold one with each shard promoting only its own partitions.
* ``pad_for_row_shards``: the padded arrays equal to JAX's bit for bit;
  padded rows never win against negative scores; real scores through the
  padded path held to 1e-4, not bitwise (the reference's bitwise test
  fails in JAX, whose padded product shifts a score by an ulp).
* The engine with ``retrieval_shards=2`` and an optimizer beside the JAX
  engine on mini-traces (continuous and whole-batch): the same retrieved
  chunks, ``PolicyEvent``s, and per-shard streamer and hot budgets.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st
import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.core.costmodel import CostModel as JaxCostModel
from repro.core.costmodel import ModelProfile as JaxModelProfile
from repro.core.costmodel import PF_HIGH as JAX_PF_HIGH
from repro.core.placement import PlacementOptimizer as JaxOptimizer
from repro.core.scheduler import BacklogScheduler as JaxBacklogScheduler
from repro.models.model import Model as JaxModel
from repro.retrieval import distributed as jdist
from repro.retrieval.synthetic import ArrayEmbedder as JaxArrayEmbedder
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
from repro_torch.core.placement import PlacementOptimizer
from repro_torch.core.scheduler import BacklogScheduler
from repro_torch.kernels import ops
from repro_torch.retrieval import HashEmbedder, ShardedIVFStore
from repro_torch.retrieval.distributed import (assign_partitions,
                                               pad_for_row_shards)
from repro_torch.retrieval.synthetic import (ArrayEmbedder, blob_corpus,
                                             perturb_queries)
from repro_torch.retrieval.vectorstore import SearchStats, VectorStore
from repro_torch.serving import (ContinuousGenerator, Generator,
                                 GeneratorConfig, RagdollEngine, Request)

COUNTERS = ("partitions_searched", "partitions_loaded", "partitions_pruned",
            "hot_hits", "cache_hits", "cache_misses")


def _stores(n=1200, dim=32, parts=8, seed=3, root=None, spill=False):
    """The same blob corpus in a port store and a JAX store."""
    vecs = blob_corpus(n=n, dim=dim, clusters=parts, seed=seed)
    texts = [str(i) for i in range(n)]
    store = VectorStore.build(texts, ArrayEmbedder(vecs),
                              num_partitions=parts, seed=seed, device="cpu",
                              root=None if root is None else f"{root}/torch")
    jstore = JaxVectorStore.build(
        texts, JaxArrayEmbedder(vecs), num_partitions=parts, seed=seed,
        root=None if root is None else f"{root}/jax")
    assert np.array_equal(store.centroids, jstore.centroids)
    if spill:
        for pid in range(store.num_partitions):
            store.spill(pid)
            jstore.spill(pid)
    return store, jstore, vecs


# ------------------------------------------------------------- assignment
@pytest.mark.parametrize("with_centroids", [True, False],
                         ids=["centroids", "contiguous"])
@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_assign_partitions_equals_jax(shards, with_centroids):
    store, jstore, _ = _stores(n=600, parts=8)
    cent = store.centroids if with_centroids else None
    for seed in (0, 1):
        got = assign_partitions(cent, shards, num_partitions=8, seed=seed)
        want = jdist.assign_partitions(cent, shards, num_partitions=8,
                                       seed=seed)
        assert got == want
        flat = sorted(pid for g in got for pid in g)
        assert flat == list(range(8)) and all(got)
        assert max(len(g) for g in got) <= -(-8 // shards)


def test_assignment_is_centroid_aware_not_round_robin():
    store, _, _ = _stores(n=3200, dim=16, parts=16, seed=5)
    cent = store.centroids
    groups = assign_partitions(cent, 4)
    shard_of = np.empty(cent.shape[0], int)
    for sid, g in enumerate(groups):
        shard_of[g] = sid
    sim = cent @ cent.T
    same = shard_of[:, None] == shard_of[None, :]
    off_diag = ~np.eye(cent.shape[0], dtype=bool)
    assert sim[same & off_diag].mean() > sim[~same].mean(), groups


def test_assignment_more_shards_than_partitions_clamps():
    store, _, _ = _stores(n=300, parts=4)
    groups = assign_partitions(store.centroids, 16)
    assert len(groups) == 4
    assert sorted(p for g in groups for p in g) == list(range(4))
    assert assign_partitions(None, 9, num_partitions=3) == [[0], [1], [2]]


# ------------------------------------------ sharded == single host == JAX
@pytest.mark.parametrize("spill", [False, True], ids=["ram", "disk"])
@pytest.mark.parametrize("nprobe", [None, 3], ids=["exact", "nprobe3"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_search_matches_single_host_and_jax(tmp_path, shards, nprobe,
                                                    spill):
    store, jstore, vecs = _stores(root=tmp_path, spill=spill)
    q = perturb_queries(vecs, 5, seed=11)
    single_stats = SearchStats()
    s1, i1 = store.search(q, 10, nprobe=nprobe, stats=single_stats)
    sharded = ShardedIVFStore(store, shards)
    jsharded = jdist.ShardedIVFStore(jstore, shards)
    assert sharded.assignment == jsharded.assignment
    stats, jstats = SearchStats(), JaxSearchStats()
    try:
        s2, i2 = sharded.search(q, 10, nprobe=nprobe, stats=stats)
        js, ji = jsharded.search(q, 10, nprobe=nprobe, stats=jstats)
    finally:
        sharded.close()
        jsharded.close()
    assert isinstance(s2, np.ndarray) and isinstance(i2, np.ndarray)
    np.testing.assert_array_equal(i1, i2)
    assert np.array_equal(s1.view(np.int32), s2.view(np.int32))
    np.testing.assert_array_equal(i2, np.asarray(ji))
    np.testing.assert_allclose(s2, np.asarray(js), atol=1e-4, rtol=0)
    # sweep work is conserved: each probed partition searched once, by
    # one shard, and the totals equal the reference's
    assert stats.partitions_searched == single_stats.partitions_searched
    for name in COUNTERS:
        assert getattr(stats, name) == getattr(jstats, name), name
    assert stats.heat() == jstats.heat()
    assert store.resident_set() == ([] if spill
                                    else list(range(store.num_partitions)))


def test_sharded_stats_aggregate_across_shards(tmp_path):
    store, jstore, vecs = _stores(root=tmp_path, spill=True)
    q = perturb_queries(vecs, 3, seed=2)
    single = SearchStats()
    store.search(q, 8, nprobe=3, stats=single)
    sharded = ShardedIVFStore(store, 4)
    jsharded = jdist.ShardedIVFStore(jstore, 4)
    agg, jagg = SearchStats(), JaxSearchStats()
    try:
        sharded.search(q, 8, nprobe=3, stats=agg)
        jsharded.search(q, 8, nprobe=3, stats=jagg)
    finally:
        sharded.close()
        jsharded.close()
    for name in ("partitions_searched", "partitions_loaded",
                 "partitions_pruned"):
        assert getattr(agg, name) == getattr(single, name) \
            == getattr(jagg, name), name
    assert sorted(agg.load_ewma) == sorted(jagg.load_ewma)


def test_tiny_corpus_sharded_matches_single_host_sentinels():
    """top_k > candidates: both paths emit the same (NEG_INF, -1) tails."""
    store, jstore, vecs = _stores(n=12, dim=16, parts=4, seed=0)
    q = vecs[[0, 7]]
    s1, i1 = store.search(q, 8, nprobe=1)
    sharded = ShardedIVFStore(store, 2, use_streamers=False)
    s2, i2 = sharded.search(q, 8, nprobe=1)
    sharded.close()
    jsharded = jdist.ShardedIVFStore(jstore, 2, use_streamers=False)
    js, ji = jsharded.search(q, 8, nprobe=1)
    np.testing.assert_array_equal(i1, i2)
    assert np.array_equal(s1.view(np.int32), s2.view(np.int32))
    np.testing.assert_array_equal(i2, np.asarray(ji))
    assert (i2 == -1).any(), "expected sentinel rows (k > candidates)"
    assert (s2[i2 == -1] == ops.NEG_INF).all()


# ----------------------------------------------------- per-shard disk tier
def test_per_shard_streamer_budget_split(tmp_path):
    store, _, _ = _stores(root=tmp_path, spill=True)
    sharded = ShardedIVFStore(store, 4)
    try:
        sharded.set_budget(4e9)
        assert [sh.streamer.free_bytes for sh in sharded.shards] \
            == [1e9] * 4
        sharded.set_budgets([1.0, 2.0, 3.0, -4.0])
        assert [sh.streamer.free_bytes for sh in sharded.shards] \
            == [1.0, 2.0, 3.0, 0.0]
        with pytest.raises(ValueError):
            sharded.set_budgets([1.0])
    finally:
        sharded.close()


def test_each_shard_streams_only_its_own_partitions(tmp_path):
    store, jstore, vecs = _stores(root=tmp_path, spill=True)
    q = perturb_queries(vecs, 4, seed=9)
    sharded = ShardedIVFStore(store, 2)
    jsharded = jdist.ShardedIVFStore(jstore, 2)
    loads = []
    try:
        for shard, jshard in zip(sharded.shards, jsharded.shards):
            stats, jstats = SearchStats(), JaxSearchStats()
            _, _, searched = store.sweep_boards(
                q, shard.pids, 5, streamer=shard.streamer, stats=stats)
            _, _, jsearched = jstore.sweep_boards(
                q, jshard.pids, 5, streamer=jshard.streamer, stats=jstats)
            assert set(np.nonzero(searched)[0]) == shard.pid_set
            assert np.array_equal(searched, np.asarray(jsearched))
            assert stats.partitions_loaded == jstats.partitions_loaded
            loads.append(stats.partitions_loaded)
    finally:
        sharded.close()
        jsharded.close()
    assert sum(loads) == store.num_partitions and all(n > 0 for n in loads)


# ------------------------------------------------------- sharded hot tier
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_hot_sweep_bit_equal_and_eligible(tmp_path, shards):
    """Each shard's hot tier promotes only its own partitions under its
    share of the grant (as JAX's does), and the hot search equals the
    cold one bit for bit with hot hits."""
    store, jstore, vecs = _stores(root=tmp_path, spill=True)
    q = perturb_queries(vecs, 6, seed=4)
    cold_s, cold_i = store.search(q, 7, nprobe=3)
    sharded = ShardedIVFStore(store, shards)
    jsharded = jdist.ShardedIVFStore(jstore, shards)
    grant = 4 * store.partition_bytes()
    ranking = [5, 2, 7, 0, 3, 6, 1, 4]
    budgets = [grant // shards] * shards
    try:
        sharded.set_hot_budgets(budgets, ranking)
        jsharded.set_hot_budgets(budgets, ranking)
        for shard in sharded.shards:
            assert set(shard.hot.pids()) <= shard.pid_set
            assert shard.hot.device_bytes() <= grant // shards
        assert sharded.hot_partitions() == jsharded.hot_partitions()
        assert sharded.hot_device_bytes() == jsharded.hot_device_bytes()
        assert sharded.hot_partitions(), "the grant promoted nothing"
        stats = SearchStats()
        hot_s, hot_i = sharded.search(q, 7, nprobe=3, stats=stats)
        with pytest.raises(ValueError):
            sharded.set_hot_budgets([grant], ranking)
    finally:
        sharded.close()
        jsharded.close()
    np.testing.assert_array_equal(hot_i, cold_i)
    assert np.array_equal(hot_s.view(np.int32), cold_s.view(np.int32))
    assert stats.hot_hits > 0
    assert store.resident_set() == []


# ------------------------------------------------- uneven row-shard padding
@pytest.mark.parametrize("n, shards", [(10, 4), (21, 4), (12, 3), (7, 1),
                                       (5, 8)])
def test_pad_for_row_shards_equals_jax_bitwise(n, shards):
    rng = np.random.default_rng(n * 10 + shards)
    q = rng.normal(size=(3, 8)).astype(np.float32)
    db = rng.normal(size=(n, 8)).astype(np.float32)
    q_aug, db_aug, local_n = pad_for_row_shards(torch.from_numpy(q),
                                                torch.from_numpy(db), shards)
    jq, jdb, jlocal = jdist.pad_for_row_shards(jnp.asarray(q),
                                               jnp.asarray(db), shards)
    assert local_n == jlocal
    for got, want in ((q_aug, jq), (db_aug, jdb)):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_padded_rows_never_win_even_with_negative_scores():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(np.abs(rng.normal(size=(3, 8))).astype(np.float32))
    db = torch.from_numpy(-np.abs(rng.normal(size=(10, 8))).astype(np.float32))
    q_aug, db_aug, local_n = pad_for_row_shards(q, db, 4)
    assert tuple(db_aug.shape) == (12, 9) and local_n == 3
    s, i = ops.retrieval_topk(q_aug, db_aug, 8)
    assert (i < 10).all(), i
    assert (s > -1e29).all()


def test_pad_for_row_shards_keeps_real_scores():
    """Ids equal the unpadded search's; scores within 1e-4 (JAX's padded
    product moves a score by an ulp, so bitwise is not the contract)."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(4, 16)).astype(np.float32))
    db = torch.from_numpy(rng.normal(size=(21, 16)).astype(np.float32))
    s_ref, i_ref = ops.retrieval_topk(q, db, 5)
    q_aug, db_aug, _ = pad_for_row_shards(q, db, 4)
    s_aug, i_aug = ops.retrieval_topk(q_aug, db_aug, 5)
    assert torch.equal(i_ref, i_aug)
    torch.testing.assert_close(s_aug, s_ref, atol=1e-4, rtol=0)


# -------------------------------------------------------- engine wiring
def _close(eng):
    """What ``stop`` closes, for an engine driven without its threads."""
    eng.streamer.close()
    eng.sharded.close()


def test_engine_retrieval_stage_uses_sharded_store(tmp_path):
    """``tests/test_sharded.py``'s engine wiring: the sharded retrieval
    stage gives the single-host chunks, and the boundary splits the host
    headroom across the shards' streamers."""
    emb = HashEmbedder(dim=16)
    texts = [f"doc {i} topic{i % 5}" for i in range(160)]
    store = VectorStore.build(texts, emb, num_partitions=4, root=str(tmp_path),
                              device="cpu")
    mp = ModelProfile.from_config(get_config("llama3-70b"))
    cm = CostModel(PF_HIGH, mp, partition_bytes=8 * GB, num_partitions=4,
                   retrieval_shards=2)
    eng = RagdollEngine(store, emb, generator=None,
                        ret_scheduler=BacklogScheduler(max_batch=8),
                        gen_scheduler=BacklogScheduler(max_batch=8),
                        optimizer=PlacementOptimizer(cm, 512, 32),
                        retrieval_shards=2, device="cpu")
    try:
        assert eng.sharded is not None and eng.sharded.num_shards == 2
        reqs = [Request(rid=i, query=f"query {i}", arrival=0.0)
                for i in range(3)]
        out = eng._retrieve_batch(reqs)
        q = emb.embed([r.query for r in reqs])
        _, want_ids = store.search(q, reqs[0].top_k, nprobe=eng.nprobe)
        assert [r.retrieved for r in out] == store.get_chunks(want_ids)
        eng._gen_boundary()
        budgets = [sh.streamer.free_bytes for sh in eng.sharded.shards]
        assert len(set(budgets)) == 1 and 0.0 <= budgets[0] < float("inf")
        snap = eng.metrics_snapshot()
        assert snap["gauges"]["hot.partitions"] == float(
            len(eng.sharded.hot_partitions()))
    finally:
        _close(eng)


# ------------------------------------ side by side with the JAX engine
N_DOCS, DIM, PARTS, SPILLED = 1024, 32, 8, (6, 7)
CTX, MAX_NEW, PAGE, CHUNK, SLOTS = 32, 4, 8, 16, 3
EVERY = 2
SEED_SAMPLES = [(1.0, 1.0), (4.0, 1.5)]


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_config("llama3-8b").reduced(num_layers=2)
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(0),
                                               jnp.float32)
    cfg = get_config("llama3-8b").reduced(num_layers=2)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu", dtype=torch.float32)
    return cfg, params, jcfg, jparams


class _Seeded(BacklogScheduler):
    def observe(self, batch, seconds):
        pass


class _JaxSeeded(JaxBacklogScheduler):
    def observe(self, batch, seconds):
        pass


def _schedulers(cls):
    gen = cls(max_batch=SLOTS)
    gen.seed(SEED_SAMPLES)
    return cls(max_batch=8), gen


def _optimizers(store):
    """A reduced llama3-8b on PF-High with a slow disk and 60 kB of host
    memory, priced with 2 retrieval shards on this store's partitions."""
    kw = dict(partition_bytes=float(store.partition_bytes()),
              num_partitions=store.num_partitions, db_dim=DIM,
              chunks_per_partition=store.partition_bytes() / (4 * DIM),
              partition_mem_overhead=1.0, retrieval_shards=1)
    hw = dict(disk_read_bw=1e6, cpu_mem=6e4)
    mp = ModelProfile.from_config(get_config("llama3-8b").reduced(num_layers=8))
    jmp = JaxModelProfile.from_config(
        jax_get_config("llama3-8b").reduced(num_layers=8))
    opt = PlacementOptimizer(
        CostModel(dataclasses.replace(PF_HIGH, **hw), mp, **kw),
        avg_ctx_len=16, avg_out_len=16)
    jopt = JaxOptimizer(
        JaxCostModel(dataclasses.replace(JAX_PF_HIGH, **hw), jmp, **kw),
        avg_ctx_len=16, avg_out_len=16)
    return opt, jopt


def _observe(eng, store, rows):
    ev = dataclasses.asdict(eng.policy_trace[-1])
    ev.pop("t")
    gen = eng.generator
    caps = ((gen.num_slots, gen.kv.pool.capacity, gen.kv.host.capacity)
            if getattr(gen, "paged", False) else None)
    shards = eng.sharded.shards
    rows.append(dict(
        event=ev, nprobe=eng.nprobe, hot=eng.sharded.hot_partitions(),
        shard_hot=[sh.hot.pids() for sh in shards],
        hot_budgets=[sh.hot.byte_budget for sh in shards],
        streamer_budgets=[sh.streamer.free_bytes for sh in shards],
        resident=sorted(store.resident_set()), caps=caps,
        target=eng.pcache.target))


def _drive(eng, store, waves, continuous):
    rows = []
    eng._gen_boundary()          # the probe width for the first retrieval
    _observe(eng, store, rows)
    if continuous:
        pumps, total = 0, 0

        def pump():
            nonlocal pumps
            done = eng.pump_once()
            pumps += 1
            if pumps % EVERY == 0:
                eng._gen_boundary()
                _observe(eng, store, rows)
            return done

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
    else:
        batch, queue = 2, eng.pipeline.context_queue
        for wave in waves:
            eng._retrieve_batch(wave)
            queue.put_many(wave)
            eng._generate_batch(queue.pop_batch(batch))
            eng._gen_boundary()
            _observe(eng, store, rows)
            batch = rows[-1]["event"]["gen_batch"]
        while len(queue):
            eng._generate_batch(queue.pop_batch(batch))
            eng._gen_boundary()
            _observe(eng, store, rows)
            batch = rows[-1]["event"]["gen_batch"]
    return sorted(eng.completed, key=lambda r: r.rid), rows


@pytest.mark.parametrize("continuous", [True, False],
                         ids=["continuous", "whole-batch"])
def test_sharded_engine_minitrace_matches_jax_engine(tmp_path, weights,
                                                     continuous):
    cfg, params, jcfg, jparams = weights
    store, jstore, vecs = _stores(n=N_DOCS, dim=DIM, parts=PARTS, seed=9,
                                  root=tmp_path)
    for pid in SPILLED:
        store.spill(pid)
        jstore.spill(pid)
    opt, jopt = _optimizers(store)
    # queries from one partition, so its heat funds the hot tier: the
    # smallest of 12 rows or more, as the market grants one largest
    # partition's bytes and the even split gives each shard half of it
    hot_pid = min((p for p in store.partitions.values()
                   if len(p.doc_ids) >= 12), key=lambda p: p.nbytes).pid
    assert 2 * store.partitions[hot_pid].nbytes <= store.partition_bytes()
    queries = [str(int(d)) for d in store.partitions[hot_pid].doc_ids[:12]]
    g = GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW)
    jg = JaxGeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW)
    if continuous:
        gen = ContinuousGenerator(cfg, params, g, num_slots=SLOTS, paged=True,
                                  page_size=PAGE, prefill_chunk=CHUNK,
                                  device="cpu")
        jgen = JaxContinuous(jcfg, jparams, jg, num_slots=SLOTS, paged=True,
                             page_size=PAGE, prefill_chunk=CHUNK)
    else:
        gen = Generator(cfg, params, g, device="cpu")
        jgen = JaxGenerator(jcfg, jparams, jg)
    kw = dict(initial_partitions=PARTS - len(SPILLED), policy_every=EVERY,
              retrieval_shards=2)
    eng = RagdollEngine(store, ArrayEmbedder(vecs), gen,
                        *_schedulers(_Seeded), optimizer=opt, device="cpu",
                        **kw)
    jeng = JaxEngine(jstore, JaxArrayEmbedder(vecs), jgen,
                     *_schedulers(_JaxSeeded), optimizer=jopt, **kw)

    def waves(cls):
        reqs = [cls(rid=i, query=q, arrival=0.0, top_k=5,
                    max_new_tokens=MAX_NEW, priority=int(i % 3 == 2))
                for i, q in enumerate(queries)]
        return [reqs[i:i + 4] for i in range(0, len(reqs), 4)]

    try:
        jreqs, jrows = _drive(jeng, jstore, waves(JaxRequest), continuous)
        reqs, rows = _drive(eng, store, waves(Request), continuous)
    finally:
        _close(eng)
        _close(jeng)
    assert len(rows) == len(jrows) >= 4
    for i, (got, want) in enumerate(zip(rows, jrows)):
        assert got == want, f"boundary {i}"
    assert [r.rid for r in reqs] == [r.rid for r in jreqs] == list(range(12))
    for r, j in zip(reqs, jreqs):
        assert r.retrieved == j.retrieved, r.rid
        assert r.output == j.output, r.rid
    # the trace exercised the shards: a funded hot tier, pruned probes,
    # finite per-shard streamer budgets
    assert any(hot_pid in row["hot"] for row in rows)
    assert any(row["nprobe"] is not None and row["nprobe"] < PARTS
               for row in rows)
    assert all(len(row["streamer_budgets"]) == 2
               and max(row["streamer_budgets"]) < float("inf")
               for row in rows)


# ------------------------------------------------------ hypothesis property
@settings(max_examples=20, deadline=None)
@given(n=st.integers(24, 200), shards=st.sampled_from([1, 2, 3, 4]),
       nprobe=st.sampled_from([None, 1, 2, 3]), seed=st.integers(0, 4))
def test_sharded_equals_single_host_property(n, shards, nprobe, seed):
    """``tests/test_sharded.py``'s property: the sharded search equals the
    single-host search bit for bit, sentinel tails included."""
    store, _, vecs = _stores(n=n, dim=16, parts=6, seed=seed)
    rng = np.random.default_rng(seed + 100)
    q = vecs[rng.integers(0, n, size=3)]
    top_k = int(rng.integers(1, 12))
    s1, i1 = store.search(q, top_k, nprobe=nprobe)
    sharded = ShardedIVFStore(store, shards, use_streamers=False)
    s2, i2 = sharded.search(q, top_k, nprobe=nprobe)
    sharded.close()
    np.testing.assert_array_equal(i1, i2)
    assert np.array_equal(s1.view(np.int32), s2.view(np.int32))


# ------------------------------------------------------------- the mesh
def test_make_mesh_needs_a_process_group_and_the_card():
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh((1,), ("data",), device_type="cpu")
    with pytest.raises(ValueError):
        make_mesh((2, 2), ("data",), device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh((1,), ("data",))
