"""Port layer-streamed offloading (``StreamedExecutor``, ``streamed=True``)
vs the JAX package, on the CPU.

Counterparts of the reference's streamed tests: ``test_system.py``'s
streamed-equals-resident generation, ``test_continuous.py``'s streamed
schedules and slot-mask contract (an all-dead step returns zeros and
touches no cache or layer; the mask never changes live rows),
``test_paged.py``'s streamed paged and chunked cases, ``test_prefix.py``'s
streamed prefix cache, ``test_swap.py``'s streamed preemption,
``test_reqsched.py``'s streamed scheduler preemption (partial and
overlapped), ``test_quant_kv.py``'s streamed int8 generators and
``test_serving.py``'s streamed engine; beside them the streamed ``resize``,
the executor's logits against the JAX executor's, its staging order
against the JAX one's, and ``launch/serve.py --streamed``.

Bars: tokens and retrieved ids equal exactly, logits to 2e-5; int8
logits to 2e-3 and tokens equal where every greedy gap exceeds 2e-3
(ROADMAP queue 3).  Weights: ``PRNGKey(1)``, whose greedy choices on
these prompts all have top-2 gaps above 1e-3 (asserted in ``dense_ref``).
Most cases compare with the port's resident path, which the other
``test_torch_*`` files hold to the JAX package; a few compare with the
JAX streamed generators directly.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.core.prefetch import PrefetchPolicy as JaxPolicy
from repro.core.prefetch import StreamedExecutor as JaxExecutor
from repro.core.scheduler import BacklogScheduler as JaxBacklogScheduler
from repro.models.model import Model as JaxModel
from repro.retrieval import HashEmbedder as JaxHashEmbedder
from repro.retrieval import VectorStore as JaxVectorStore
from repro.serving.engine import RagdollEngine as JaxEngine
from repro.serving.generator import ContinuousGenerator as JaxContinuous
from repro.serving.generator import Generator as JaxGenerator
from repro.serving.generator import GeneratorConfig as JaxGeneratorConfig
from repro.serving.kvpool import PagedKVCache as JaxPagedKVCache
from repro.serving.request import Request as JaxRequest

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.pipeline import StageQueue
from repro_torch.core.prefetch import PrefetchPolicy, StreamedExecutor
from repro_torch.core.scheduler import BacklogScheduler
from repro_torch.launch import serve
from repro_torch.launch.serve import build_corpus
from repro_torch.models import transformer
from repro_torch.retrieval import HashEmbedder, VectorStore
from repro_torch.serving import (ContinuousGenerator, Generator,
                                 GeneratorConfig, RagdollEngine, Request)
from repro_torch.serving.kvpool import PagedKVCache
from repro_torch.serving.reqsched import RequestScheduler

CTX, MAX_NEW = 16, 5
MARGIN = 1e-3
INT8_MARGIN = 2e-3


def _prompts(n=6):
    return [f"query {i} topic{i % 3} alpha beta" for i in range(n)]


def _random_schedule(seed, ticks=40, max_joins=3):
    rng = np.random.default_rng(seed)
    return [int(rng.integers(0, max_joins)) for _ in range(ticks)]


def _gap(logits) -> float:
    top2 = np.sort(np.asarray(logits, dtype=np.float32), axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


def _convert(jparams, cfg):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu", dtype=torch.float32)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_config("llama3-8b").reduced(num_layers=2)
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(1),
                                               jnp.float32)
    cfg = get_config("llama3-8b").reduced(num_layers=2)
    return jcfg, jparams, cfg, _convert(jparams, cfg)


@pytest.fixture(scope="module")
def dense_ref(weights):
    """The port's resident whole-batch tokens of the six prompts, equal
    to the JAX ``Generator``'s, whose every greedy gap exceeds 1e-3."""
    jcfg, jparams, cfg, params = weights
    jgen = JaxGenerator(jcfg, jparams, JaxGeneratorConfig(
        ctx_len=CTX, max_new_tokens=MAX_NEW))
    gaps = []
    prefill, decode = jgen._prefill, jgen._decode

    def rec(fn):
        def call(*a):
            logits, cache = fn(*a)
            gaps.append(_gap(logits))
            return logits, cache
        return call

    jgen._prefill, jgen._decode = rec(prefill), rec(decode)
    want = jgen.generate(_prompts())
    assert min(gaps) > MARGIN, "prompts lack a greedy margin"
    got = Generator(cfg, params, GeneratorConfig(
        ctx_len=CTX, max_new_tokens=MAX_NEW), device="cpu").generate(
            _prompts())
    assert got == want
    return got


def _streamed(weights, **kw):
    _, _, cfg, params = weights
    return ContinuousGenerator(
        cfg, params, GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW),
        num_slots=3, streamed=True, device="cpu", **kw)


# ------------------------------------------------- whole-batch generation
def test_streamed_executor_equals_resident_generation():
    """``test_system.py``: offloading generation == resident generation,
    on a 3-layer model, beside the JAX streamed ``Generator``."""
    jcfg = jax_get_config("llama3-8b").reduced(num_layers=3)
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(1),
                                               jnp.float32)
    cfg = get_config("llama3-8b").reduced(num_layers=3)
    params = _convert(jparams, cfg)
    prompts = ["alpha beta gamma", "delta epsilon"]
    g = GeneratorConfig(ctx_len=16, max_new_tokens=4)
    res = Generator(cfg, params, g, device="cpu").generate(prompts)
    gen = Generator(cfg, params, g, streamed=True,
                    policy=PrefetchPolicy(max_depth=2, prefill_depth=1),
                    device="cpu")
    assert gen.exec.n_layers == 3 and gen.model is None
    assert gen.generate(prompts) == res
    jout = JaxGenerator(jcfg, jparams, JaxGeneratorConfig(
        ctx_len=16, max_new_tokens=4), streamed=True,
        policy=JaxPolicy(max_depth=2, prefill_depth=1)).generate(prompts)
    assert res == jout
    assert gen.exec.passes == 4               # one prefill, three decodes


# ------------------------------------------------------- the executor
def _jax_layered(jcfg, b, total, page, kv_format, kinds):
    return JaxPagedKVCache(jcfg, b, total, page,
                           kv_format=kv_format).init_layered(kinds)


@pytest.mark.parametrize("kv_format,tol", [(None, 2e-5), ("int8", 2e-3)])
def test_executor_logits_match_jax(weights, kv_format, tol):
    """Paged chunk prefill (batch 1, then two rows at different offsets
    in one call, then batch 1) and paged decode through one block table:
    the port's executor against the JAX executor on the same inputs."""
    jcfg, jparams, cfg, params = weights
    ctx, chunk, page, steps, b = 16, 8, 4, 4, 2
    total = ctx + steps
    nmax = -(-total // page)
    jex = JaxExecutor(jcfg, jparams, JaxPolicy(max_depth=2))
    ex = StreamedExecutor(cfg, params, PrefetchPolicy(max_depth=2),
                          device="cpu")
    jc = _jax_layered(jcfg, b, total, page, kv_format, jex.layer_kinds())
    tc = PagedKVCache(cfg, b, total, page, kv_format=kv_format,
                      device="cpu").init_layered(ex.layer_kinds())
    tab = np.arange(1, b * nmax + 1, dtype=np.int32).reshape(b, nmax)
    rng = np.random.default_rng(0)
    toks = rng.integers(2, cfg.vocab_size, size=(b, ctx)).astype(np.int32)
    worst = 0.0
    # (rows, offsets): row 0's first chunk, both rows batched at offsets
    # 8 and 0, row 1's last chunk
    for rows, offs in (([0], [0]), ([0, 1], [8, 0]), ([1], [8])):
        x = np.stack([toks[r, o:o + chunk] for r, o in zip(rows, offs)])
        off = np.asarray(offs, np.int32)
        jl, jc = jex.prefill_chunk(jnp.asarray(x), jc, jnp.asarray(off),
                                   block_tab=jnp.asarray(tab[rows]),
                                   kv_span=ctx)
        tl = ex.prefill_chunk(torch.from_numpy(x), tc, torch.from_numpy(off),
                              block_tab=torch.from_numpy(tab[rows]),
                              kv_span=ctx)
        worst = max(worst, float(np.abs(tl.numpy() - np.asarray(jl)).max()))
    cur = np.zeros((b, 1), np.int32)
    for t in range(steps):
        pos = np.full(b, ctx + t, np.int32)
        jl, jc = jex.decode(jnp.asarray(cur), jc, jnp.asarray(pos),
                            block_tab=jnp.asarray(tab), kv_span=total)
        tl = ex.decode(torch.from_numpy(cur), tc, torch.from_numpy(pos),
                       block_tab=torch.from_numpy(tab), kv_span=total)
        jl = np.asarray(jl)
        worst = max(worst, float(np.abs(tl.numpy() - jl).max()))
        if _gap(jl) > (INT8_MARGIN if kv_format else MARGIN):
            assert (tl.numpy().argmax(-1) == jl.argmax(-1)).all()
        cur = jl.argmax(-1).reshape(b, 1).astype(np.int32)
    assert worst < tol, worst


def test_executor_dense_prefill_and_decode_match_jax(weights):
    jcfg, jparams, cfg, params = weights
    b, total = 3, CTX + 3
    jex = JaxExecutor(jcfg, jparams, JaxPolicy(max_depth=8))
    ex = StreamedExecutor(cfg, params, PrefetchPolicy(max_depth=8),
                          device="cpu")
    toks = np.random.default_rng(1).integers(
        2, cfg.vocab_size, size=(b, CTX)).astype(np.int32)
    jl, jc = jex.prefill(jnp.asarray(toks), jex.init_caches(b, total))
    tc = ex.init_caches(b, total)
    tl = ex.prefill(torch.from_numpy(toks), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5)
    for t in range(3):
        cur = np.asarray(jnp.argmax(jl, -1)).reshape(b, 1).astype(np.int32)
        pos = np.full(b, CTX + t, np.int32)
        jl, jc = jex.decode(jnp.asarray(cur), jc, jnp.asarray(pos))
        tl = ex.decode(torch.from_numpy(cur), tc, torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5)
    for jb, tb in zip(jc, tc["blocks"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(tb[name].numpy(), np.asarray(jb[name]),
                                       atol=2e-5)


def _record_port(monkeypatch):
    """Log the port executor's staging (layer index) and compute ("c")."""
    log = []
    stage, apply_layer = StreamedExecutor._stage, transformer.apply_layer

    def rec_stage(self, i):
        log.append(i)
        return stage(self, i)

    def rec_apply(*a, **kw):
        log.append("c")
        return apply_layer(*a, **kw)

    monkeypatch.setattr(StreamedExecutor, "_stage", rec_stage)
    monkeypatch.setattr(transformer, "apply_layer", rec_apply)
    return log


def _record_jax(monkeypatch, jex):
    """Log the JAX executor's ``jax.device_put`` of a layer (its index)
    and its layer calls ("c")."""
    log = []
    index = {id(lp): i for i, (_, lp) in enumerate(jex.layers)}
    put, apply_fn = jax.device_put, jex._apply_fn

    def rec_put(x, *a, **kw):
        if id(x) in index:
            log.append(index[id(x)])
        return put(x, *a, **kw)

    def rec_apply_fn(kind, mode, kv_span=None):
        fn = apply_fn(kind, mode, kv_span)

        def call(*a):
            log.append("c")
            return fn(*a)
        return call

    monkeypatch.setattr(jax, "device_put", rec_put)
    monkeypatch.setattr(jex, "_apply_fn", rec_apply_fn)
    return log


@pytest.mark.parametrize("resident", [0, 1])
@pytest.mark.parametrize("depths", [(8, 1, float("inf")), (8, 2, 2.5),
                                    (1, 1, float("inf"))],
                         ids=["deep", "capped", "shallow"])
def test_staging_order_equals_reference(monkeypatch, resident, depths):
    """Per pass and phase (prefill, chunk, decode), the port stages the
    layers in the reference's order, interleaved with the compute the
    same way: with and without a resident layer, and with ``free_bytes``
    capping the depth (at 2.5 layers' bytes)."""
    max_depth, prefill_depth, free_layers = depths
    jcfg = jax_get_config("llama3-8b").reduced(num_layers=4)
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(1),
                                               jnp.float32)
    cfg = get_config("llama3-8b").reduced(num_layers=4)
    params = _convert(jparams, cfg)
    jex = JaxExecutor(jcfg, jparams, JaxPolicy(max_depth, prefill_depth),
                      resident_layers=resident)
    free = free_layers * jex.layer_bytes
    jex.free_bytes = free
    ex = StreamedExecutor(cfg, params, PrefetchPolicy(max_depth,
                                                      prefill_depth),
                          device="cpu", resident_layers=resident,
                          free_bytes=free)
    assert ex.layer_bytes == jex.layer_bytes
    b, ctx, page = 2, 8, 4
    total = ctx + 2
    nmax = -(-total // page)
    tab = np.arange(1, b * nmax + 1, dtype=np.int32).reshape(b, nmax)
    toks = np.ones((b, ctx), np.int32)
    jlog, tlog = _record_jax(monkeypatch, jex), _record_port(monkeypatch)
    jd, td = jex.init_caches(b, total), ex.init_caches(b, total)
    jp = _jax_layered(jcfg, b, total, page, None, jex.layer_kinds())
    tp = PagedKVCache(cfg, b, total, page, device="cpu").init_layered(
        ex.layer_kinds())
    passes = [
        ("prefill", lambda: jex.prefill(jnp.asarray(toks), jd),
         lambda: ex.prefill(torch.from_numpy(toks), td)),
        ("chunk", lambda: jex.prefill_chunk(
            jnp.asarray(toks[:, :4]), jp, jnp.zeros((b,), jnp.int32),
            block_tab=jnp.asarray(tab), kv_span=ctx),
         lambda: ex.prefill_chunk(
             torch.from_numpy(toks[:, :4]), tp,
             torch.zeros((b,), dtype=torch.int32),
             block_tab=torch.from_numpy(tab), kv_span=ctx)),
        ("decode", lambda: jex.decode(
            jnp.asarray(toks[:, :1]), jd, jnp.full((b,), ctx, jnp.int32)),
         lambda: ex.decode(torch.from_numpy(toks[:, :1]), td,
                           torch.full((b,), ctx, dtype=torch.int32))),
    ]
    for phase, jrun, trun in passes:
        del jlog[:], tlog[:]
        jrun()
        trun()
        assert tlog == jlog, phase
        assert tlog.count("c") == 4
        assert sorted(i for i in tlog if i != "c") == list(range(resident,
                                                                 4))
    assert ex.ring_slots <= 4 - resident


# -------------------------------------------- continuous, slot-mask contract
def test_streamed_executor_skips_stream_when_all_slots_dead(weights,
                                                            monkeypatch):
    gen = ContinuousGenerator(
        weights[2], weights[3], GeneratorConfig(ctx_len=CTX,
                                                max_new_tokens=4),
        num_slots=2, streamed=True, device="cpu")
    before = [{k: v.clone() for k, v in layer.items()}
              for layer in gen.cache["blocks"]]
    staged = _record_port(monkeypatch)
    logits = gen.exec.decode(torch.zeros((2, 1), dtype=torch.int32),
                             gen.cache, torch.full((2,), CTX,
                                                   dtype=torch.int32),
                             slot_mask=np.zeros(2, bool))
    assert logits.shape == (2, gen.cfg.vocab_size)
    assert not logits.any()
    assert staged == [] and gen.exec.passes == 0   # no layer streamed
    for old, layer in zip(before, gen.cache["blocks"]):
        for k, v in layer.items():
            assert torch.equal(v, old[k])


def test_streamed_decode_mask_never_changes_live_rows(weights):
    gen = ContinuousGenerator(
        weights[2], weights[3], GeneratorConfig(ctx_len=CTX,
                                                max_new_tokens=4),
        num_slots=2, streamed=True, device="cpu")
    gen.join("live", "alpha beta")
    cur = torch.from_numpy(gen._cur)[:, None]
    pos = torch.from_numpy(gen._pos)
    mask = gen.table.mask()
    assert mask.tolist() == [True, False]
    masked = gen.exec.decode(cur, gen.cache, pos, slot_mask=mask)
    plain = gen.exec.decode(cur, gen.cache, pos)
    assert torch.equal(masked[0], plain[0])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_continuous_token_identical_streamed(weights, dense_ref, layout,
                                             seed):
    """``test_continuous.py`` and ``test_paged.py``: randomized join/leave
    schedules on the streamed path give the whole-batch tokens."""
    kw = dict(paged=True, page_size=4) if layout == "paged" else {}
    cont = _streamed(weights, **kw)
    assert cont.run(_prompts(), schedule=_random_schedule(seed)) == dense_ref
    assert cont.free_slots == cont.num_slots
    if layout == "paged":
        assert cont.kv.pool.used_pages == 0
        assert cont.kv.pool.reserved_pages == 0


def test_chunked_prefill_streamed_batches_joiners_and_matches_jax(
        weights, dense_ref):
    """``test_paged.py``'s chunked prefill on the streamed path: joiners
    whose next chunk has the same width ride one call (padded to a power
    of two), live slots decode in between, and the tokens equal the JAX
    streamed generator's on the same schedule."""
    jcfg, jparams, cfg, params = weights
    batches = []
    cont = _streamed(weights, paged=True, page_size=4, prefill_chunk=7)
    chunk = cont.exec.prefill_chunk

    def rec(inputs, *a, **kw):
        batches.append(tuple(inputs.shape))
        return chunk(inputs, *a, **kw)

    cont.exec.prefill_chunk = rec
    jcont = JaxContinuous(jcfg, jparams, JaxGeneratorConfig(
        ctx_len=CTX, max_new_tokens=MAX_NEW), num_slots=3, streamed=True,
        paged=True, page_size=4, prefill_chunk=7)
    schedule = [2, 1, 0, 1, 1, 0, 1]
    out = cont.run(_prompts(), schedule=schedule)
    assert out == dense_ref
    assert out == jcont.run(_prompts(), schedule=schedule)
    # three joiners at offsets 7, 7 and 0 share width 7: one call padded
    # to 4 rows; groups of 1 and 2 run too
    assert (4, 7) in batches
    assert {b for b, _ in batches} == {1, 2, 4}
    assert cont.steps == jcont.steps


def test_chunked_prefill_interleaves_with_decode_streamed(weights,
                                                          dense_ref):
    cont = _streamed(weights, paged=True, page_size=4, prefill_chunk=7)
    pending = list(enumerate(_prompts()))[::-1]
    results = [None] * len(pending)
    overlap = 0
    while pending or cont.active_slots:
        if pending and cont.admit_capacity > 0:     # one join per tick
            key, prompt = pending.pop()
            assert cont.join(key, prompt) is not None
        live = sum(1 for r in cont.table.active_refs()
                   if r.index not in cont._prefilling)
        if cont._prefilling and live:
            overlap += 1
        cont.step()
        for key, text, _ in cont.harvest():
            results[key] = text
    assert results == dense_ref
    assert overlap > 0, "chunked prefill never overlapped live decode"


def test_dense_eos_and_resize_streamed(weights, dense_ref):
    """Dense streamed rows through EOS exits and a grow/shrink of the slot
    table mid-flight (rows padded and cut)."""
    _, _, cfg, params = weights
    eos = int(dense_ref[0].split()[2][3:])
    g = GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW, eos_id=eos)
    want = Generator(cfg, params, g, device="cpu").generate(_prompts())
    cont = ContinuousGenerator(cfg, params, g, num_slots=2, streamed=True,
                               device="cpu")
    pending = list(enumerate(_prompts()))[::-1]
    results = [None] * len(pending)
    tick = 0
    while pending or cont.active_slots:
        if tick == 2:
            assert cont.resize(4) == 4
        if tick == 6:
            cont.resize(2)
        while pending and cont.admit_capacity > 0:
            key, prompt = pending.pop()
            assert cont.join(key, prompt) is not None
        cont.step()
        for key, text, _ in cont.harvest():
            results[key] = text
        tick += 1
        assert tick < 300
    assert results == want
    assert len(want[0].split()) <= 3          # the trim actually bit
    assert cont.cache["blocks"][0]["k"].shape[0] == cont.num_slots


def test_paged_resize_and_retarget_streamed(weights, dense_ref):
    cont = _streamed(weights, paged=True, page_size=4, prefill_chunk=7)
    pending = list(enumerate(_prompts()))[::-1]
    results = [None] * len(pending)
    tick = 0
    while pending or cont.active_slots:
        if tick == 2:
            assert cont.resize(4) == 4
            cont.set_page_budget(cont.kv.pool.capacity + 8)
        if tick == 6:
            cont.retarget(num_slots=2, page_budget=2 * cont.kv.nmax)
        while pending and cont.admit_capacity > 0:
            key, prompt = pending.pop()
            assert cont.join(key, prompt) is not None
        cont.step()
        for key, text, _ in cont.harvest():
            results[key] = text
        tick += 1
        assert tick < 300
    assert results == dense_ref


# -------------------------------------------------------------- prefix
def test_shared_prefix_token_identical_streamed(weights):
    """``test_prefix.py``: the streamed prefix cache (suffix prefill
    through ``prefill_chunk``) gives the resident prefix generator's
    tokens and counts."""
    _, _, cfg, params = weights
    base = ["alpha beta gamma", "alpha beta delta", "omega psi chi"]
    prompts = [f"{base[i % 3]} item{i // 3}" for i in range(4)]
    outs = []
    for streamed in (False, True):
        cont = ContinuousGenerator(
            cfg, params, GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW),
            num_slots=2, streamed=streamed, paged=True, page_size=4,
            prefix_cache=True, device="cpu")
        res = []
        pending = list(enumerate(prompts))[::-1]
        results = [None] * len(prompts)
        while pending or cont.active_slots:
            while pending and cont.admit_capacity > 0:
                key, prompt = pending.pop()
                assert cont.join(key, prompt) is not None
            cont.step()
            for key, text, _ in cont.harvest():
                results[key] = text
        res = (results, cont.prefix_hit_tokens, cont.prefill_tokens,
               cont.cow_copies, vars(cont.prefix.stats).copy())
        outs.append(res)
    assert outs[1] == outs[0]
    assert outs[1][1] > 0 and outs[1][4]["hits"] > 0
    assert outs[0][0] == Generator(cfg, params, GeneratorConfig(
        ctx_len=CTX, max_new_tokens=MAX_NEW), device="cpu").generate(prompts)


# ------------------------------------------------------------ preemption
def _run_with_preemption(cont, prompts, schedule, preempt_every=3,
                         park_ticks=2):
    pending = list(enumerate(prompts))[::-1]
    results = [None] * len(prompts)
    parked = []
    tick = cycles = 0
    while pending or cont.active_slots or cont.parked_slots:
        for due, handle in list(parked):
            if tick >= due and cont.resume(handle) is not None:
                parked.remove((due, handle))
                cycles += 1
        allow = len(pending)
        if tick < len(schedule):
            allow = min(allow, schedule[tick])
        joined = 0
        while pending and joined < allow and cont.admit_capacity > 0:
            key, prompt = pending.pop()
            assert cont.join(key, prompt) is not None
            joined += 1
        if tick % preempt_every == preempt_every - 1:
            victim = cont.swap_victim()
            if victim is not None:
                handle = cont.preempt(victim)
                if handle is not None:
                    parked.append((tick + park_ticks, handle))
        cont.step()
        for key, text, _ in cont.harvest():
            results[key] = text
        tick += 1
        assert tick < 500, "preemption driver stalled"
    return results, cycles


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_preempt_resume_token_identical_streamed(weights, dense_ref, seed):
    """``test_swap.py``: forced preempt/resume cycles on the streamed path
    (parked rows ride the batched decode, masked dead)."""
    cont = _streamed(weights, paged=True, page_size=4)
    out, cycles = _run_with_preemption(cont, _prompts(),
                                       _random_schedule(seed))
    assert out == dense_ref
    assert cycles > 0 and cont.swap_outs == cont.swap_ins
    assert cont.kv.pool.used_pages == 0 and cont.kv.host.used_pages == 0


def test_sched_preemption_token_identical_streamed(weights, dense_ref):
    """``test_reqsched.py``: the scheduler preempts on the streamed path
    with partial swap and overlapped copies together."""
    worst = -(-(CTX + MAX_NEW) // 4)
    gen = _streamed(weights, paged=True, page_size=4,
                    page_budget=2 * worst + 2, overlap_swap=True)
    queue = StageQueue("ctx")
    sched = RequestScheduler(gen, queue, partial_swap=True)
    shed = []
    preempt = gen.preempt

    def rec(ref, pages=None):
        shed.append(pages)
        return preempt(ref, pages=pages)

    gen.preempt = rec
    reqs = []
    for i, p in enumerate(_prompts()):
        r = Request(rid=i, query=p, arrival=time.perf_counter(),
                    max_new_tokens=MAX_NEW)
        r.prompt = p
        reqs.append(r)
    queue.put_many(reqs)
    for r in reqs:
        sched.note_queued(r)
    done, tick = {}, 0
    while len(done) < len(reqs):
        cap = sched.capacity()
        items = queue.pop_batch(cap) if cap > 0 else []
        if items:
            sched.admit(items)
        sched.tick()
        gen.step()
        for key, text, _ in gen.harvest():
            done[key.rid] = text
            sched.note_done([key])
        if tick % 4 == 0:
            gen.fence()
        tick += 1
        assert tick < 2000, "scheduler driver stalled"
    gen.kv.close()
    assert [done[i] for i in range(len(reqs))] == dense_ref
    assert any(p is not None for p in shed), shed
    assert gen.kv.outstanding == 0
    assert gen.kv.pool.used_pages == 0 and gen.kv.host.used_pages == 0


# ----------------------------------------------------------------- int8
@pytest.mark.parametrize("chunk", [None, 8])
def test_int8_streamed_generator_matches_jax(weights, chunk):
    """``test_quant_kv.py``'s streamed variants: the streamed int8 paged
    generator gives the resident int8 generator's tokens and the JAX
    streamed int8 generator's where every live greedy gap exceeds 2e-3."""
    jcfg, jparams, cfg, params = weights
    prompts = [f"query {i} topic{i % 3} alpha beta" for i in range(5)]
    kw = dict(num_slots=3, paged=True, page_size=4, kv_format="int8",
              prefill_chunk=chunk)
    g = GeneratorConfig(ctx_len=16, max_new_tokens=6)
    res = ContinuousGenerator(cfg, params, g, device="cpu", **kw)
    gen = ContinuousGenerator(cfg, params, g, streamed=True, device="cpu",
                              **kw)
    assert gen.kv_format == "int8"
    jgen = JaxContinuous(jcfg, jparams, JaxGeneratorConfig(
        ctx_len=16, max_new_tokens=6), streamed=True, **kw)
    gaps = []
    decode = jgen.exec.decode

    def rec(inputs, caches, pos, slot_mask=None, **k):
        logits, caches = decode(inputs, caches, pos, slot_mask=slot_mask,
                                **k)
        live = np.asarray(slot_mask).astype(bool)
        gaps.append(_gap(np.asarray(logits)[live]))
        return logits, caches

    jgen.exec.decode = rec
    want = jgen.run(prompts)
    out = gen.run(prompts)
    assert out == res.run(prompts)
    assert min(gaps) > INT8_MARGIN
    assert out == want


# ---------------------------------------------------------------- engine
def test_ragdoll_engine_over_streamed_generator_matches_jax(weights,
                                                            tmp_path):
    """``test_serving.py``'s streamed case: the whole-batch engine over a
    streamed ``Generator`` retrieves and generates what the JAX engine
    over its streamed ``Generator`` does (threaded: conservation)."""
    jcfg, jparams, cfg, params = weights
    texts = build_corpus(120)
    n, ctx, new = 10, 32, 4
    jstore = JaxVectorStore.build(texts, JaxHashEmbedder(dim=32),
                                  num_partitions=4, root=str(tmp_path / "j"))
    jstore.spill(3)
    jeng = JaxEngine(jstore, JaxHashEmbedder(dim=32), JaxGenerator(
        jcfg, jparams, JaxGeneratorConfig(ctx_len=ctx, max_new_tokens=new),
        streamed=True), JaxBacklogScheduler(max_batch=8),
        JaxBacklogScheduler(max_batch=4), initial_partitions=3)
    jreqs = [JaxRequest(rid=i, query=f"question about fact {i}",
                        arrival=time.perf_counter()) for i in range(n)]
    try:
        jeng._retrieve_batch(jreqs)
        jeng._generate_batch(jreqs)
    finally:
        jeng.streamer.close()
    for threaded in (False, True):
        store = VectorStore.build(texts, HashEmbedder(dim=32),
                                  num_partitions=4,
                                  root=str(tmp_path / f"t{threaded}"),
                                  device="cpu")
        store.spill(3)
        gen = Generator(cfg, params, GeneratorConfig(ctx_len=ctx,
                                                     max_new_tokens=new),
                        streamed=True, device="cpu")
        eng = RagdollEngine(store, HashEmbedder(dim=32), gen,
                            BacklogScheduler(max_batch=8),
                            BacklogScheduler(max_batch=4),
                            initial_partitions=3, device="cpu")
        reqs = [Request(rid=i, query=f"question about fact {i}",
                        arrival=time.perf_counter()) for i in range(n)]
        if threaded:
            eng.start()
            try:
                for r in reqs:
                    eng.submit(r)
                got = eng.drain(n, timeout=120)
            finally:
                eng.stop()
        else:
            try:
                eng._retrieve_batch(reqs)
                eng._generate_batch(reqs)
            finally:
                eng.streamer.close()
            got = eng.completed
        got = sorted(got, key=lambda r: r.rid)
        assert [r.rid for r in got] == list(range(n))
        for r, j in zip(got, sorted(jeng.completed, key=lambda r: r.rid)):
            assert r.retrieved == j.retrieved, r.rid
            assert r.output == j.output, r.rid
            assert len(r.output.split()) == new
        assert gen.exec.passes > 0


def _pump_engine(weights, root, streamed, gaps=None):
    """fig8's paged mini-trace through ``RagdollEngine.pump_once`` on the
    launcher's corpus; ``gaps`` records the resident run's greedy gaps
    (live decode rows, emitting chunks)."""
    _, _, cfg, params = weights
    store = VectorStore.build(build_corpus(120), HashEmbedder(dim=32),
                              num_partitions=4, root=root, device="cpu")
    store.spill(3)
    gen = ContinuousGenerator(cfg, params, GeneratorConfig(
        ctx_len=32, max_new_tokens=4), num_slots=3, streamed=streamed,
        paged=True, page_size=8, prefill_chunk=12, device="cpu")
    if gaps is not None:
        decode, chunk = gen.model.decode, gen.model.chunk_prefill

        def decode_rec(*a, **kw):
            live = [r.index for r in gen.table.active_refs()
                    if r.index not in gen._prefilling]
            logits = decode(*a, **kw)
            gaps.append(_gap(logits[live].numpy()))
            return logits

        def chunk_rec(p, x, c, off, *a, **kw):
            logits = chunk(p, x, c, off, *a, **kw)
            if int(off[0]) + x.shape[1] >= 32:      # the emitting chunk
                gaps.append(_gap(logits.numpy()))
            return logits

        gen.model.decode, gen.model.chunk_prefill = decode_rec, chunk_rec
    eng = RagdollEngine(store, HashEmbedder(dim=32), gen,
                        BacklogScheduler(max_batch=8),
                        BacklogScheduler(max_batch=3),
                        initial_partitions=3, device="cpu")
    reqs = [Request(rid=i, query=f"question about fact {i}",
                    arrival=time.perf_counter(), max_new_tokens=4)
            for i in range(8)]
    try:
        eng._retrieve_batch(reqs)
        eng.pipeline.context_queue.put_many(reqs)
        guard = 0
        while eng.pump_once() < len(reqs):
            guard += 1
            assert guard < 1000, "the pump stalled"
    finally:
        eng.streamer.close()
    return sorted(eng.completed, key=lambda r: r.rid), gen


def test_continuous_engine_over_streamed_generator(weights, tmp_path):
    """The continuous ``RagdollEngine`` takes a streamed paged generator
    unchanged: the same retrieved chunks and tokens as over the resident
    one (whose every greedy gap exceeds 1e-3), joiners' chunks batched."""
    gaps = []
    want, _ = _pump_engine(weights, str(tmp_path / "r"), False, gaps)
    got, gen = _pump_engine(weights, str(tmp_path / "s"), True)
    assert min(gaps) > MARGIN, "mini-trace lacks a greedy margin"
    assert [r.rid for r in got] == list(range(8))
    for r, w in zip(got, want):
        assert r.retrieved == w.retrieved and len(r.retrieved) == 5
        assert r.output == w.output, r.rid
    assert gen.exec.passes > 0


def test_launch_serve_streamed_on_cpu(capsys):
    serve.main(["--streamed", "--device", "cpu", "--requests", "3",
                "--rate", "600"])
    out = capsys.readouterr().out
    assert "mode=ragdoll" in out and "streamed=True" in out
    assert "  n                3" in out and "  incomplete       0" in out


def test_streamed_entry_points_refuse_cpu_fallback(weights):
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid")
    _, _, cfg, params = weights
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamedExecutor(cfg, params, PrefetchPolicy())
    with pytest.raises(RuntimeError, match="CUDA"):
        Generator(cfg, params, GeneratorConfig(), streamed=True)
