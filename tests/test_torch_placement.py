"""The port's placement slice against the JAX package's.

The cost model, the placement optimizer (``solve``, ``candidates``,
``project``, ``score``, ``market`` and the page and shard budgets) and the
active profiler are pure Python arithmetic on the same profiles, so every
float must be equal (``==``), not close: over a hypothesis grid of batch,
context, weight and KV fractions, residency, probe width, hot partitions
and KV format, for llama3-8b, llama3-70b and reduced variants on PF-High,
PF-Low and the port's measured ``H100_HOST``.  Then the port's
counterparts of ``tests/test_placement.py`` and of the market tests in
``tests/test_hot_tier.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as jax_get_config
from repro.core import costmodel as jcm
from repro.core.placement import Placement as JaxPlacement
from repro.core.placement import PlacementOptimizer as JaxOptimizer
from repro.core.profiler import ActiveProfiler as JaxProfiler

from repro_torch.configs import get_config
from repro_torch.core import costmodel as cm
from repro_torch.core.costmodel import (GB, H100_HOST, PF_HIGH, PF_LOW,
                                        CostModel, ModelProfile)
from repro_torch.core.placement import Placement, PlacementOptimizer
from repro_torch.core.profiler import ActiveProfiler
from repro_torch.retrieval.cache import HotPartitionSet
from repro_torch.retrieval.synthetic import ArrayEmbedder, blob_corpus
from repro_torch.retrieval.vectorstore import VectorStore

MODELS = ("llama3-8b", "llama3-70b", "llama3-8b-r8", "llama3-70b-r2")
HWS = ("PF-High", "PF-Low", "H100")
KV_FORMATS = (None, "fp32", "bf16", "int8")


def _configs(name):
    base = name.split("-r")[0]
    pcfg, jcfg = get_config(base), jax_get_config(base)
    if "-r" in name:
        layers = int(name.split("-r")[1])
        pcfg = pcfg.reduced(num_layers=layers)
        jcfg = jcfg.reduced(num_layers=layers)
    return pcfg, jcfg


def _hws(name):
    port = {"PF-High": PF_HIGH, "PF-Low": PF_LOW, "H100": H100_HOST}[name]
    if name == "H100":       # the JAX package has no H100 profile
        return port, jcm.HardwareProfile(**dataclasses.asdict(port))
    return port, {"PF-High": jcm.PF_HIGH, "PF-Low": jcm.PF_LOW}[name]


def _pair(model="llama3-8b", hw="PF-High", kv_format=None, *,
          partition_bytes=8 * GB, num_partitions=32, ctx=512, out=32,
          page=16, **cost_kw):
    """The same optimizer in both packages."""
    pcfg, jcfg = _configs(model)
    phw, jhw = _hws(hw)
    pmp = ModelProfile.from_config(pcfg, kv_format=kv_format)
    jmp = jcm.ModelProfile.from_config(jcfg, kv_format=kv_format)
    popt = PlacementOptimizer(
        CostModel(phw, pmp, partition_bytes=partition_bytes,
                  num_partitions=num_partitions, **cost_kw),
        avg_ctx_len=ctx, avg_out_len=out, kv_page_size=page)
    jopt = JaxOptimizer(
        jcm.CostModel(jhw, jmp, partition_bytes=partition_bytes,
                      num_partitions=num_partitions, **cost_kw),
        avg_ctx_len=ctx, avg_out_len=out, kv_page_size=page)
    return popt, jopt


def _same(port, ref):
    """Dataclasses equal field for field, floats with ``==``."""
    assert type(port).__name__ == type(ref).__name__
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def _placements(p):
    return (Placement(**dataclasses.asdict(p)),
            JaxPlacement(**dataclasses.asdict(p)))


# ------------------------------------------------------------ cost model
def test_profiles_and_constants_equal_the_reference():
    _same(PF_HIGH, jcm.PF_HIGH)
    _same(PF_LOW, jcm.PF_LOW)
    assert cm.KV_FORMAT_BYTES == jcm.KV_FORMAT_BYTES and cm.GB == jcm.GB
    assert not hasattr(cm, "TPU_V5E_HOST")
    # every field of the H100 profile is a measurement, none left at 0
    for f in dataclasses.fields(H100_HOST):
        if f.name != "name":
            assert getattr(H100_HOST, f.name) > 0, f.name


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("kv_format", KV_FORMATS)
def test_model_profile_equals_the_reference(model, kv_format):
    pcfg, jcfg = _configs(model)
    pmp = ModelProfile.from_config(pcfg, kv_format=kv_format)
    jmp = jcm.ModelProfile.from_config(jcfg, kv_format=kv_format)
    _same(pmp, jmp)
    for fmt in ("fp32", "bf16", "int8"):
        _same(pmp.with_kv_format(fmt), jmp.with_kv_format(fmt))
        for page in (1, 4, 16):
            assert (pmp.with_kv_format(fmt).kv_page_bytes(page)
                    == jmp.with_kv_format(fmt).kv_page_bytes(page))
    assert pmp.layer_bytes == jmp.layer_bytes
    assert pmp.flops_per_token() == jmp.flops_per_token()
    assert pmp.kv_bytes(8, 1056) == jmp.kv_bytes(8, 1056)
    assert pmp.workspace_bytes(8, 1024) == jmp.workspace_bytes(8, 1024)


@settings(max_examples=60, deadline=None)
@given(model=st.sampled_from(MODELS), hw=st.sampled_from(HWS),
       kv_format=st.sampled_from(KV_FORMATS),
       batch=st.integers(1, 256), ctx=st.integers(1, 4096),
       out=st.integers(1, 512), w_gpu=st.floats(0, 1), c_gpu=st.floats(0, 1),
       w_cpu=st.one_of(st.none(), st.floats(0, 1)),
       resident=st.integers(0, 64),
       nprobe=st.one_of(st.none(), st.integers(1, 64)),
       hot=st.integers(0, 64),
       hot_rate=st.one_of(st.none(), st.floats(0, 1)),
       cached=st.integers(0, 4096), depth=st.integers(0, 8),
       pages=st.integers(0, 4096), overlap=st.booleans(),
       hidden=st.floats(0, 1))
def test_cost_model_equals_the_reference(model, hw, kv_format, batch, ctx,
                                         out, w_gpu, c_gpu, w_cpu, resident,
                                         nprobe, hot, hot_rate, cached,
                                         depth, pages, overlap, hidden):
    popt, jopt = _pair(model, hw, kv_format, partition_bytes=48e6,
                       num_partitions=64, chunks_per_partition=15625.0,
                       partition_mem_overhead=1.0)
    p, j = popt.cost, jopt.cost
    assert (p.retrieval_time(batch, resident, nprobe=nprobe,
                             hot_partitions=hot, hot_hit_rate=hot_rate)
            == j.retrieval_time(batch, resident, nprobe=nprobe,
                                hot_partitions=hot, hot_hit_rate=hot_rate))
    assert p.partition_load_time() == j.partition_load_time()
    assert p.device_search_time(batch) == j.device_search_time(batch)
    assert (p.prefill_time(batch, ctx, w_gpu, c_gpu, depth, w_cpu=w_cpu,
                           cached_len=cached)
            == j.prefill_time(batch, ctx, w_gpu, c_gpu, depth, w_cpu=w_cpu,
                              cached_len=cached))
    assert (p.decode_time_per_token(batch, ctx, w_gpu, c_gpu, depth,
                                    w_cpu=w_cpu)
            == j.decode_time_per_token(batch, ctx, w_gpu, c_gpu, depth,
                                       w_cpu=w_cpu))
    assert (p.batch_generation_time(batch, ctx, out, w_gpu, c_gpu,
                                    w_cpu=w_cpu, cached_len=cached)
            == j.batch_generation_time(batch, ctx, out, w_gpu, c_gpu,
                                       w_cpu=w_cpu, cached_len=cached))
    fmt = kv_format or "bf16"
    assert (p.kv_swap_time(pages, 16, kv_format=fmt, overlap=overlap,
                           hidden_s=hidden)
            == j.kv_swap_time(pages, 16, kv_format=fmt, overlap=overlap,
                              hidden_s=hidden))
    assert (p.placement_shift_time(pages * 1e6)
            == j.placement_shift_time(pages * 1e6))


# ------------------------------------------------------------- placement
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("hw", HWS)
def test_solve_and_candidates_equal_the_reference(model, hw):
    popt, jopt = _pair(model, hw)
    for b in (1, 4, 8, 16, 64):
        pc, jc = popt.candidates(b), jopt.candidates(b)
        assert len(pc) == len(jc)
        for a, r in zip(pc, jc):
            _same(a, r)
            assert popt.score(a) == jopt.score(r)
        _same(popt.solve(b), jopt.solve(b))


@settings(max_examples=60, deadline=None)
@given(model=st.sampled_from(MODELS), hw=st.sampled_from(HWS),
       wg=st.floats(0, 1), cg=st.floats(0, 1), wc=st.floats(0, 1),
       cc=st.floats(0, 1), pres=st.integers(0, 32),
       b=st.sampled_from([1, 3, 4, 16, 64, 256]),
       nprobe=st.one_of(st.none(), st.integers(1, 32)),
       kv_format=st.sampled_from(KV_FORMATS), page=st.sampled_from([4, 16]),
       shards=st.integers(1, 5), host_free=st.floats(-1e9, 1e12))
def test_project_and_budgets_equal_the_reference(model, hw, wg, cg, wc, cc,
                                                 pres, b, nprobe, kv_format,
                                                 page, shards, host_free):
    popt, jopt = _pair(model, hw)
    p, j = _placements(JaxPlacement(
        w_gpu=wg, w_cpu=(1 - wg) * wc, c_gpu=cg, c_cpu=(1 - cg) * cc,
        resident_partitions=pres, gen_batch=b, nprobe=nprobe))
    _same(popt.memory_use(p), jopt.memory_use(j))
    assert popt.feasible(p) == jopt.feasible(j)
    pq, jq = popt.project(p), jopt.project(j)
    _same(pq, jq)
    assert popt.score(pq) == jopt.score(jq)
    assert popt.pipeline_times(pq) == jopt.pipeline_times(jq)
    assert popt.pipeline_times(pq, 7) == jopt.pipeline_times(jq, 7)
    for name in ("kv_page_budget", "kv_host_page_budget"):
        assert (getattr(popt, name)(pq, page, kv_format)
                == getattr(jopt, name)(jq, page, kv_format))
    assert (popt.prefix_cache_page_budget(pq, page)
            == jopt.prefix_cache_page_budget(jq, page))
    assert popt.device_byte_budget(pq) == jopt.device_byte_budget(jq)
    assert (popt.paged_batch_capacity(pq, page, 544)
            == jopt.paged_batch_capacity(jq, page, 544))
    assert (popt.dense_batch_capacity(pq, 1152)
            == jopt.dense_batch_capacity(jq, 1152))
    assert (popt.shard_resident_budgets(pq, shards)
            == jopt.shard_resident_budgets(jq, shards))
    assert (popt.shard_streamer_budgets(host_free, shards)
            == jopt.shard_streamer_budgets(host_free, shards))
    assert (popt.shard_hot_budgets(host_free, shards)
            == jopt.shard_hot_budgets(host_free, shards))


@settings(max_examples=60, deadline=None)
@given(model=st.sampled_from(MODELS[2:]), hw=st.sampled_from(HWS),
       cg=st.floats(0.05, 1.0), b=st.sampled_from([1, 2, 4, 8, 16]),
       nprobe=st.one_of(st.none(), st.integers(1, 8)),
       heat=st.lists(st.floats(0.0, 50.0), max_size=12),
       kv_format=st.sampled_from(KV_FORMATS), page=st.sampled_from([4, 16]),
       pressure=st.floats(0, 1))
def test_market_equals_the_reference(model, hw, cg, b, nprobe, heat,
                                     kv_format, page, pressure):
    """Reduced models on small partitions, so every hot fraction of the
    grid can clear some partitions and the clearings differ."""
    popt, jopt = _pair(model, hw, partition_bytes=65536.0, num_partitions=8,
                       ctx=16, out=16, page=page, db_dim=16,
                       chunks_per_partition=600 / 8,
                       partition_mem_overhead=1.0)
    p, j = _placements(jopt.project(
        JaxPlacement(1.0, 0.0, cg, 0.0, 0, b, nprobe=nprobe)))
    ranked = sorted(heat, reverse=True)
    _same(popt.market(p, page_size=page, partition_heat=ranked,
                      kv_format=kv_format, priority_pressure=pressure),
          jopt.market(j, page_size=page, partition_heat=ranked,
                      kv_format=kv_format, priority_pressure=pressure))


@pytest.mark.parametrize("model,hw", [("llama3-70b", "PF-High"),
                                      ("llama3-8b", "PF-Low"),
                                      ("llama3-8b", "H100")])
def test_active_profiler_equals_the_reference(model, hw):
    popt, jopt = _pair(model, hw)
    batches = (1, 4, 8, 16, 32, 64)

    def measure(opt):
        # a deterministic stand-in for a real measurement: the cost model
        # perturbed by the batch, so the best batch is the measure's
        return lambda p: tuple(t * (1.0 + 0.01 * p.gen_batch)
                               for t in opt.pipeline_times(p))

    for m in (None, "measure"):
        got = ActiveProfiler(popt, batches).profile(
            measure=measure(popt) if m else None)
        want = JaxProfiler(jopt, batches).profile(
            measure=measure(jopt) if m else None)
        assert got.best_batch == want.best_batch
        assert got.gen_samples == want.gen_samples
        assert got.ret_samples == want.ret_samples
        assert sorted(got.placements) == sorted(want.placements)
        for b in got.placements:
            _same(got.placements[b], want.placements[b])
        _same(got.best_placement, want.best_placement)


# ------------------------------- counterparts of tests/test_placement.py
def _opt(model="llama3-8b", hw=PF_HIGH):
    mp = ModelProfile.from_config(get_config(model))
    cost = CostModel(hw, mp, partition_bytes=8 * GB, num_partitions=32)
    return PlacementOptimizer(cost, avg_ctx_len=512, avg_out_len=32)


@settings(max_examples=30, deadline=None)
@given(wg=st.floats(0, 1), cg=st.floats(0, 1),
       pres=st.integers(0, 32), b=st.sampled_from([1, 4, 16, 64, 256]))
def test_project_always_feasible(wg, cg, pres, b):
    opt = _opt("llama3-70b", PF_LOW)
    p = Placement(w_gpu=wg, w_cpu=1 - wg, c_gpu=cg, c_cpu=1 - cg,
                  resident_partitions=pres, gen_batch=b)
    assert opt.feasible(opt.project(p))


@pytest.mark.parametrize("model,hw", [("llama3-8b", PF_HIGH),
                                      ("llama3-70b", PF_HIGH),
                                      ("llama3-8b", PF_LOW),
                                      ("llama3-70b", PF_LOW),
                                      ("llama3-8b", H100_HOST),
                                      ("llama3-70b", H100_HOST)])
def test_solve_returns_feasible(model, hw):
    opt = _opt(model, hw)
    for b in (4, 16, 64):
        p = opt.solve(b)
        assert opt.feasible(p)
        use = opt.memory_use(p)
        assert use.gpu <= hw.gpu_mem * hw.mem_headroom
        assert use.cpu <= hw.cpu_mem * hw.mem_headroom


def test_memory_monotone_in_batch():
    opt = _opt()
    p8 = Placement(0.5, 0.5, 0.5, 0.5, 4, 8)
    p64 = dataclasses.replace(p8, gen_batch=64)
    assert opt.memory_use(p64).gpu > opt.memory_use(p8).gpu


def test_bigger_model_offloads_more():
    """70B must put a smaller weight fraction on the 24GB GPU than 8B."""
    assert _opt("llama3-70b").solve(32).w_gpu < _opt("llama3-8b").solve(32).w_gpu


def test_profiler_balances_pipelines():
    opt = _opt("llama3-70b")
    res = ActiveProfiler(opt, batches=(8, 16, 32, 64)).profile()
    assert res.best_batch in res.placements
    assert opt.feasible(res.best_placement)
    assert len(res.gen_samples) >= 3


def test_retrieval_time_decreases_with_residency():
    opt = _opt()
    ts = [opt.cost.retrieval_time(32, r) for r in (0, 8, 16, 32)]
    assert all(a >= b for a, b in zip(ts, ts[1:]))


def test_paper_70b_needs_offloading():
    """70B weights cannot fully fit PF-High's 24 GB of device memory."""
    opt = _opt("llama3-70b", PF_HIGH)
    assert not opt.feasible(Placement(1.0, 0.0, 1.0, 0.0, 0, 8))


def test_paged_pool_admits_strictly_more_than_dense_rows():
    """``tests/test_paged.py``'s page dimension on llama3-70b: under one
    device KV byte budget, page-granular admission beats dense worst-case
    rows, and the page budget stays inside the byte budget."""
    mp = ModelProfile.from_config(get_config("llama3-70b"))
    cost = CostModel(PF_HIGH, mp, partition_bytes=8 * GB, num_partitions=32)
    opt = PlacementOptimizer(cost, avg_ctx_len=512, avg_out_len=32,
                             kv_page_size=16)
    p = opt.solve(16)
    if p.c_gpu == 0.0:
        p = Placement(p.w_gpu, p.w_cpu, 0.5, 0.5, p.resident_partitions,
                      p.gen_batch, nprobe=p.nprobe)
    assert (opt.paged_batch_capacity(p, req_len=512 + 32)
            > opt.dense_batch_capacity(p, worst_case_len=1024 + 128))
    assert opt.kv_page_budget(p) * mp.kv_page_bytes(16) <= opt.kv_gpu_bytes(p)


# ------------------- counterparts of the market tests, test_hot_tier.py
def _build_store(n, dim, parts, seed):
    vecs = blob_corpus(n=n, dim=dim, clusters=parts, seed=seed)
    return VectorStore.build([str(i) for i in range(n)], ArrayEmbedder(vecs),
                             num_partitions=parts, seed=seed, device="cpu")


def tiny_optimizer(store, dim):
    """``tests/test_hot_tier.py``'s ``_tiny_optimizer`` in the port."""
    mp = ModelProfile.from_config(get_config("llama3-8b").reduced(num_layers=8))
    hw = dataclasses.replace(PF_HIGH, disk_read_bw=1e6)
    cost = CostModel(hw, mp, partition_bytes=float(store.partition_bytes()),
                     num_partitions=store.num_partitions, db_dim=dim,
                     chunks_per_partition=len(store.chunks)
                     / store.num_partitions,
                     partition_mem_overhead=1.0)
    return PlacementOptimizer(cost, avg_ctx_len=16, avg_out_len=16)


_PROP_STORE = _build_store(600, 16, 8, 5)
_PROP_OPT = tiny_optimizer(_PROP_STORE, 16)


@settings(max_examples=30, deadline=None)
@given(steps=st.lists(
    st.tuples(st.floats(0.05, 1.0), st.sampled_from([1, 2, 4, 8]),
              st.lists(st.floats(0.01, 50.0), min_size=0, max_size=8)),
    min_size=1, max_size=6))
def test_market_invariant_across_retargets(steps):
    """However the placement and heat evolve, every clearing keeps
    pages * page_bytes + hot_bytes inside the pool, the prefix cap inside
    the page budget, and the hot set inside its grant."""
    hot = HotPartitionSet(_PROP_STORE, device="cpu")
    for c_gpu, gen_batch, heat in steps:
        p = _PROP_OPT.project(
            Placement(1.0, 0.0, c_gpu, 0.0, 0, gen_batch, nprobe=2))
        split = _PROP_OPT.market(p, partition_heat=sorted(heat, reverse=True))
        hot.retarget(split.hot_bytes, list(range(len(heat))))
        assert (split.kv_page_budget * split.page_bytes
                + split.hot_bytes) <= split.total_bytes + 1e-6
        assert split.prefix_page_budget <= max(split.kv_page_budget, 0)
        assert hot.device_bytes() <= split.hot_bytes


def test_market_legacy_equivalence_paper_scale():
    """Paper-scale partitions (GBs) dwarf the pool: the market reproduces
    the per-subsystem budgets exactly and funds no hot partition."""
    mp = ModelProfile.from_config(get_config("llama3-8b"))
    cost = CostModel(PF_HIGH, mp, partition_bytes=8 * GB, num_partitions=32)
    opt = PlacementOptimizer(cost, avg_ctx_len=512, avg_out_len=32)
    p = opt.project(Placement(0.5, 0.5, 1.0, 0.0, 4, 8, nprobe=8))
    split = opt.market(p, partition_heat=[5.0] * 32)
    assert split.kv_page_budget == opt.kv_page_budget(p)
    assert split.prefix_page_budget == opt.prefix_cache_page_budget(p)
    assert split.host_page_budget == opt.kv_host_page_budget(p)
    assert split.hot_partitions == 0 and split.hot_bytes == 0


def test_shard_hot_budgets_partition_the_grant():
    mp = ModelProfile.from_config(get_config("llama3-8b"))
    opt = PlacementOptimizer(CostModel(PF_HIGH, mp, partition_bytes=1.0,
                                       num_partitions=4))
    for total, shards in ((1000, 3), (7, 2), (0, 4)):
        budgets = opt.shard_hot_budgets(total, shards)
        assert len(budgets) == shards
        assert sum(budgets) == total
        assert max(budgets) - min(budgets) <= 1
