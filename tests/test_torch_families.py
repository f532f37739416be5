"""The attention families beyond llama: the port against the JAX package.

gemma2-2b (head dim 256 reduced to 16, alternating local and global
layers, attention softcap 50, final softcap 30, GeGLU, tied and scaled
embeddings), gemma-7b (MHA), chatglm3-6b (QKV bias, RoPE on half the head
dims) and granite-moe-1b-a400m (the MoE FFN), at ``.reduced()`` size, in
fp32 on the CPU, on the same converted weights and the same prompts.
``reduced()`` keeps at most 2 kv heads, so three more variants set the
head groupings: ``num_kv_heads=4`` (G = 1), ``num_heads=32,
num_kv_heads=2`` (G = 16) and llama3-70b's ``num_heads=16,
num_kv_heads=2`` (G = 8, its full size's 64/8).  Its sliding window is 16 tokens, and the
prompts here are 24, so the window masks in every mode.  chatglm3's
biases are drawn at random here (the reference initialises them to
zero, which would test nothing).

* configs: the port's copies equal the reference's field by field;
* logits: one-shot prefill and dense decode, chunked prefill and paged
  decode over fp32 and int8 pages, against the JAX ``Model`` (3e-4, the
  bar ``tests/test_models.py`` holds JAX's own prefill and decode to;
  2e-3 over int8 pages, as ``tests/test_torch_quant.py``);
* greedy tokens of every generator path (whole-batch, dense and paged
  continuous, chunked prefill over fp32 and int8 pages, ``streamed=True``,
  the prefix cache, preempt/resume inline and overlapped) equal the JAX
  whole-batch ``Generator``'s, after
  asserting that every greedy choice of the JAX run has a top-2 logit gap
  above 1e-3 (2e-3 for int8 pages; seeds chosen for it);
* the fig8 ``paged`` mini-trace through both ``RagdollEngine``s, for
  gemma2 and granite: the same ids and tokens;
* ``launch/serve.py --arch gemma2-2b --device cpu`` runs.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import all_configs as jax_all_configs
from repro.configs import get_config as jax_get_config
from repro.core.scheduler import BacklogScheduler as JaxBacklogScheduler
from repro.models import layers as jax_layers
from repro.models.model import Model as JaxModel
from repro.models.model import init_cache as jax_init_cache
from repro.models.model import make_cache_specs as jax_cache_specs
from repro.retrieval import HashEmbedder as JaxHashEmbedder
from repro.retrieval import VectorStore as JaxVectorStore
from repro.serving.engine import RagdollEngine as JaxEngine
from repro.serving.generator import ContinuousGenerator as JaxContinuous
from repro.serving.generator import Generator as JaxGenerator
from repro.serving.generator import GeneratorConfig as JaxGeneratorConfig
from repro.serving.kvpool import PagedKVCache as JaxPagedKVCache
from repro.serving.request import Request as JaxRequest

from repro_torch.configs import ASSIGNED_ARCHS, all_configs, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.scheduler import BacklogScheduler
from repro_torch.models import layers
from repro_torch.models.model import Model, init_cache
from repro_torch.retrieval import HashEmbedder, VectorStore
from repro_torch.serving import (ContinuousGenerator, Generator,
                                 GeneratorConfig, RagdollEngine, Request)
from repro_torch.serving.kvpool import PagedKVCache

FAMILIES = ["gemma2-2b", "gemma-7b", "chatglm3-6b", "granite-moe-1b-a400m"]
# (arch, reduced() overrides, JAX init seed with greedy margins)
VARIANTS = [
    ("gemma2-2b", {}, 2),
    ("gemma-7b", {}, 2),
    ("chatglm3-6b", {}, 0),
    ("granite-moe-1b-a400m", {}, 0),
    ("gemma2-2b", {"num_kv_heads": 4}, 0),                  # G = 1
    ("chatglm3-6b", {"num_heads": 32, "num_kv_heads": 2}, 0),  # G = 16
    ("llama3-70b", {"num_heads": 16, "num_kv_heads": 2}, 2),   # G = 8
]
VARIANT_IDS = ["gemma2", "gemma7b", "chatglm3", "granite", "gemma2-g1",
               "chatglm3-g16", "llama70b-g8"]
CTX, MAX_NEW, PAGE, CHUNK, STEPS = 24, 5, 8, 8, 6
MARGIN, INT8_MARGIN = 1e-3, 2e-3
LOGIT_TOL, INT8_TOL = 3e-4, 2e-3


def _prompts(n=6):
    return [f"query {i} topic{i % 3} alpha beta" for i in range(n)]


def _gap(logits) -> float:
    top2 = np.sort(np.asarray(logits, dtype=np.float32), axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


def _jax_weights(arch, overrides, seed):
    jcfg = jax_get_config(arch).reduced(**overrides)
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(seed),
                                               jnp.float32)
    if jcfg.qkv_bias:
        rng = np.random.default_rng(seed)
        for blk in jparams["blocks"]:
            for name in ("bq", "bk", "bv"):
                blk["attn"][name] = jnp.asarray(rng.normal(
                    0, 0.5, blk["attn"][name].shape).astype(np.float32))
    return jcfg, jparams


@pytest.fixture(scope="module", params=VARIANTS, ids=VARIANT_IDS)
def family(request):
    arch, overrides, seed = request.param
    jcfg, jparams = _jax_weights(arch, overrides, seed)
    cfg = get_config(arch).reduced(**overrides)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu", dtype=torch.float32)
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def jax_tokens(family):
    """The JAX whole-batch ``Generator``'s tokens and its least greedy gap."""
    jcfg, jparams, _, _ = family
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
    out = jgen.generate(_prompts())
    return out, min(gaps)


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", FAMILIES)
def test_config_copies_match_reference(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for f in cfg.__dataclass_fields__:
        want, got = getattr(jcfg, f), getattr(cfg, f)
        if f == "moe" and want is not None:
            assert vars(got) == vars(want)
        else:
            assert got == want, f
    for red in ({}, {"num_kv_heads": 4}):
        jr, r = jcfg.reduced(**red), cfg.reduced(**red)
        assert r.param_count() == jr.param_count()
        assert r.param_count(active_only=True) == \
            jr.param_count(active_only=True)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.weight_bytes() == jcfg.weight_bytes()
    assert cfg.kv_cache_bytes_per_token() == jcfg.kv_cache_bytes_per_token()
    assert cfg.kv_scale_bytes_per_page() == jcfg.kv_scale_bytes_per_page()


def test_registry_serves_the_attention_families():
    assert set(FAMILIES) <= set(ASSIGNED_ARCHS)
    # and the two dense-cache families (tests/test_torch_mla.py,
    # tests/test_torch_ssm.py)
    assert {"deepseek-v2-lite-16b", "mamba2-370m"} <= set(ASSIGNED_ARCHS)
    # and the hybrid (tests/test_torch_hybrid.py)
    assert "jamba-1.5-large-398b" in ASSIGNED_ARCHS
    assert "llama3-70b" not in ASSIGNED_ARCHS
    assert set(all_configs()) <= set(jax_all_configs())
    assert set(all_configs()) == set(ASSIGNED_ARCHS) | {"llama3-70b"}
    # gemma2's KV bytes a token at full size: 26 layers x 2 x 4 x 256 x 2
    assert get_config("gemma2-2b").kv_cache_bytes_per_token() == 106_496


def test_family_check_refuses_the_other_mixers():
    """Every reference config is taken, MLA, Mamba, the hybrid (jamba),
    the embed frontend (chameleon) and the encoder-decoder (seamless)
    too; a mixer or FFN kind the port does not know still raises."""
    import dataclasses
    from repro.configs import ASSIGNED_ARCHS as JAX_ARCHS
    from repro_torch.models.transformer import _check_family
    assert len(JAX_ARCHS) == 10
    for arch in JAX_ARCHS:
        _check_family(jax_get_config(arch))
    base = jax_get_config("llama3-8b")
    for pattern in ((("rwkv", "dense"),), (("attn", "glu_moe"),)):
        with pytest.raises(NotImplementedError):
            _check_family(dataclasses.replace(base, layer_pattern=pattern))


# ---------------------------------------------------------------- MLPs
@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(kind):
    rng = np.random.default_rng(3)
    jp = jax_layers.init_mlp(jax.random.PRNGKey(4), 64, 96, kind,
                             jnp.float32)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    want = np.asarray(jax_layers.apply_mlp(jp, jnp.asarray(x), kind))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    got = layers.apply_mlp(tp, torch.from_numpy(x), kind).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)
    gen = torch.Generator().manual_seed(0)
    assert set(layers.init_mlp(gen, 64, 96, kind, torch.float32, "cpu")) \
        == set(jp)
    assert layers.mlp_flops(64, 96, kind, 7) == \
        jax_layers.mlp_flops(64, 96, kind, 7)


# --------------------------------------------------------------- logits
def _tables(b, total):
    nmax = -(-total // PAGE)
    tab = np.zeros((b, nmax), np.int32)
    for i in range(b):
        ids = np.arange(1 + i * nmax, 1 + (i + 1) * nmax)
        tab[i] = ids if i % 2 == 0 else ids[::-1]         # any page order
    return tab, b * nmax + 1


def test_one_shot_prefill_and_dense_decode_logits_match_jax(family):
    jcfg, jparams, cfg, params = family
    jm, tm = JaxModel(jcfg, remat=False), Model(cfg, device="cpu")
    rng = np.random.default_rng(5)
    prompts = rng.integers(2, cfg.vocab_size, size=(2, CTX)).astype(np.int32)
    total = CTX + STEPS
    jcache = jax_init_cache(jcfg, 2, total, jnp.float32)
    tcache = init_cache(cfg, 2, total, torch.float32, "cpu")
    jdec = jax.jit(jm.decode)
    jl, jcache = jax.jit(jm.prefill)(jparams, jnp.asarray(prompts), jcache)
    tl = tm.prefill(params, torch.from_numpy(prompts), tcache)
    jall, tall = [np.asarray(jl)], [tl.numpy()]
    cur = np.argmax(jall[0], -1).astype(np.int32)
    for t in range(STEPS):
        pos = np.full((2,), CTX + t, np.int32)
        jl, jcache = jdec(jparams, jnp.asarray(cur[:, None]), jcache,
                          jnp.asarray(pos))
        tl = tm.decode(params, torch.from_numpy(cur[:, None]), tcache,
                       torch.from_numpy(pos))
        jall.append(np.asarray(jl))
        tall.append(tl.numpy())
        cur = np.argmax(jall[-1], -1).astype(np.int32)
    np.testing.assert_allclose(np.stack(tall), np.stack(jall),
                               atol=LOGIT_TOL)


@pytest.mark.parametrize("kv_format", [None, "int8"])
def test_chunked_prefill_and_paged_decode_logits_match_jax(family,
                                                           kv_format):
    """Chunks of 8 at per-row offsets into a shared pool (the window of
    16 masks from the third chunk on), then paged decode."""
    jcfg, jparams, cfg, params = family
    jm, tm = JaxModel(jcfg, remat=False), Model(cfg, device="cpu")
    total = CTX + STEPS
    tab, pages = _tables(2, total)
    jcache = jax.tree.map(lambda sp: jnp.zeros(sp.shape, sp.dtype),
                          jax_cache_specs(jcfg, pages, PAGE, jnp.float32,
                                          kv_format=kv_format))
    tcache = init_cache(cfg, pages, PAGE, torch.float32, "cpu",
                        kv_format=kv_format)
    jtab, ttab = jnp.asarray(tab), torch.from_numpy(tab)
    rng = np.random.default_rng(6)
    prompts = rng.integers(2, cfg.vocab_size, size=(2, CTX)).astype(np.int32)
    jchunk = jax.jit(lambda p, x, c, off, bt: jm.chunk_prefill(
        p, x, c, off, block_tab=bt, kv_span=CTX))
    jdec = jax.jit(lambda p, x, c, pos, bt: jm.decode(
        p, x, c, pos, block_tab=bt, kv_span=total))
    jlast, tlast = [], []
    for slot in range(2):
        for off in range(0, CTX, CHUNK):
            chunk = prompts[slot:slot + 1, off:off + CHUNK]
            jl, jcache = jchunk(jparams, jnp.asarray(chunk), jcache,
                                jnp.full((1,), off, jnp.int32),
                                jtab[slot:slot + 1])
            tl = tm.chunk_prefill(
                params, torch.from_numpy(chunk), tcache,
                torch.full((1,), off, dtype=torch.int32), ttab[slot:slot + 1],
                kv_span=CTX)
            tol = INT8_TOL if kv_format else LOGIT_TOL
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol)
        jlast.append(np.asarray(jl)[0])
        tlast.append(tl[0].numpy())
    jall, tall = [np.stack(jlast)], [np.stack(tlast)]
    cur = np.argmax(jall[0], -1).astype(np.int32)
    for t in range(STEPS):
        pos = np.full((2,), CTX + t, np.int32)
        jl, jcache = jdec(jparams, jnp.asarray(cur[:, None]), jcache,
                          jnp.asarray(pos), jtab)
        tl = tm.decode(params, torch.from_numpy(cur[:, None]), tcache,
                       torch.from_numpy(pos), ttab, kv_span=total)
        jall.append(np.asarray(jl))
        tall.append(tl.numpy())
        cur = np.argmax(jall[-1], -1).astype(np.int32)
    np.testing.assert_allclose(np.stack(tall), np.stack(jall),
                               atol=INT8_TOL if kv_format else LOGIT_TOL)


# --------------------------------------------------- generators, engines
GEN_PATHS = {
    "whole_batch": None,
    "dense": dict(),
    "paged": dict(paged=True, page_size=PAGE),
    "chunked": dict(paged=True, page_size=PAGE, prefill_chunk=CHUNK),
    "chunked_int8": dict(paged=True, page_size=PAGE, prefill_chunk=CHUNK,
                         kv_format="int8"),
    "streamed": "streamed",
    "streamed_chunked": dict(paged=True, page_size=PAGE, prefill_chunk=CHUNK,
                             streamed=True),
    "prefix": dict(paged=True, page_size=PAGE, prefix_cache=True),
}


@pytest.mark.parametrize("path", list(GEN_PATHS))
def test_generator_paths_match_jax_tokens(family, jax_tokens, path):
    jcfg, jparams, cfg, params = family
    want, gap = jax_tokens
    assert gap > (INT8_MARGIN if path.endswith("int8") else MARGIN), \
        "prompts lack a greedy margin"
    g = GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW)
    kw = GEN_PATHS[path]
    prompts = _prompts()
    if kw is None or kw == "streamed":
        got = Generator(cfg, params, g, streamed=kw == "streamed",
                        device="cpu").generate(prompts)
    elif kw.get("prefix_cache"):
        # each prompt asked twice: the second asks hit the cache
        cont = ContinuousGenerator(cfg, params, g, num_slots=3,
                                   device="cpu", **kw)
        got2 = _run_fifo(cont, prompts + prompts)
        assert got2[len(prompts):] == got2[:len(prompts)]
        assert cont.prefix_hit_tokens > 0
        got = got2[:len(prompts)]
    else:
        cont = ContinuousGenerator(cfg, params, g, num_slots=3,
                                   device="cpu", **kw)
        got = cont.run(prompts, schedule=[2, 1, 0, 1, 3])
    assert got == want


@pytest.mark.parametrize("kv_format,overlap", [(None, False),
                                               ("int8", True)])
def test_preempt_resume_matches_jax_tokens(family, jax_tokens, kv_format,
                                           overlap):
    """Swap: forced preempt/resume cycles on the paged, chunk-prefilled
    generator (inline over fp32 pages, overlapped over int8 pages) give
    the JAX whole-batch tokens."""
    _, _, cfg, params = family
    want, gap = jax_tokens
    assert gap > INT8_MARGIN, "prompts lack a greedy margin"
    cont = ContinuousGenerator(
        cfg, params, GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW),
        num_slots=3, paged=True, page_size=PAGE, prefill_chunk=CHUNK,
        kv_format=kv_format, overlap_swap=overlap, device="cpu")
    pending = list(enumerate(_prompts()))[::-1]
    results, parked = [None] * len(pending), []
    tick = cycles = 0
    while pending or cont.active_slots or cont.parked_slots:
        for due, handle in list(parked):
            if tick >= due and cont.resume(handle) is not None:
                parked.remove((due, handle))
                cycles += 1
        while pending and cont.admit_capacity > 0:
            key, prompt = pending.pop()
            assert cont.join(key, prompt) is not None
        if tick % 3 == 2:
            victim = cont.swap_victim()
            handle = cont.preempt(victim) if victim is not None else None
            if handle is not None:
                parked.append((tick + 2, handle))
        cont.step()
        for key, text, _ in cont.harvest():
            results[key] = text
        tick += 1
        assert tick < 500, "preemption driver stalled"
    cont.kv.fence()
    assert results == want
    assert cycles > 0 and cont.swap_outs == cont.swap_ins
    assert cont.kv.pool.used_pages == 0 and cont.kv.host.used_pages == 0


def _run_fifo(cont, prompts):
    """Join as capacity allows, in order; a refused join waits a step."""
    pending = list(enumerate(prompts))[::-1]
    results = [None] * len(prompts)
    tick = 0
    while pending or cont.active_slots:
        while pending and cont.admit_capacity > 0:
            key, prompt = pending.pop()
            if cont.join(key, prompt) is None:
                pending.append((key, prompt))
                break
        cont.step()
        for key, text, _ in cont.harvest():
            results[key] = text
        tick += 1
        assert tick < 500, "driver stalled"
    return results


def test_chunked_int8_generator_matches_jax_generator(family):
    """The int8 paged, chunk-prefilled generators of both packages on the
    same join schedule."""
    jcfg, jparams, cfg, params = family
    kw = dict(num_slots=3, **GEN_PATHS["chunked_int8"])
    schedule = [2, 1, 0, 1, 3]
    jout = JaxContinuous(jcfg, jparams, JaxGeneratorConfig(
        ctx_len=CTX, max_new_tokens=MAX_NEW), **kw).run(_prompts(),
                                                        schedule=schedule)
    got = ContinuousGenerator(cfg, params, GeneratorConfig(
        ctx_len=CTX, max_new_tokens=MAX_NEW), device="cpu", **kw).run(
            _prompts(), schedule=schedule)
    assert got == jout


def test_paged_pool_bytes_match_jax(family):
    jcfg, _, cfg, _ = family
    for fmt in (None, "int8"):
        jkv = JaxPagedKVCache(jcfg, 3, CTX + MAX_NEW, PAGE, kv_format=fmt)
        kv = PagedKVCache(cfg, 3, CTX + MAX_NEW, PAGE, kv_format=fmt,
                          device="cpu")
        jpools, pools = jkv.init_stacked(), kv.init_stacked()
        assert kv.page_nbytes(pools) == jkv.page_nbytes(jpools)
        assert kv.pool_nbytes(pools) == jkv.pool_nbytes(jpools)


@pytest.mark.parametrize("arch", FAMILIES)
def test_full_width_page_bytes_match_jax(arch):
    """Page and scale bytes at the full configs' head dims (256 for the
    gemmas), bf16 and int8 pools of two pages."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for fmt in ("bf16", "int8"):
        jkv = JaxPagedKVCache(jcfg, 1, 16, 16, num_pages=2,
                              dtype=jnp.bfloat16, kv_format=fmt)
        kv = PagedKVCache(cfg, 1, 16, 16, num_pages=2, dtype=torch.bfloat16,
                          kv_format=fmt, device="cpu")
        want = jkv.page_nbytes(jkv.init_stacked())
        assert kv.page_nbytes(kv.init_stacked()) == want
        per_token = cfg.kv_cache_bytes_per_token(1 if fmt == "int8" else 2)
        scales = cfg.kv_scale_bytes_per_page() if fmt == "int8" else 0
        assert want == 16 * per_token + scales


def test_streamed_executor_counts_expert_and_local_layers(family):
    """``StreamedExecutor`` stages every leaf of a layer, the experts and
    the fp32 router included, and keeps the pattern's layer kinds."""
    from repro_torch.core.prefetch import PrefetchPolicy, StreamedExecutor
    _, _, cfg, params = family
    ex = StreamedExecutor(cfg, params, PrefetchPolicy(), device="cpu")
    per_layer = [sum(t.numel() * t.element_size() for t in _tensors(lp))
                 for lp in params["blocks"]]
    assert ex.layer_bytes == sum(per_layer) / len(per_layer)
    assert ex.streamed_bytes == sum(per_layer)
    assert ex.layer_kinds() == list(cfg.layer_kinds())
    if cfg.moe is not None:
        assert all("moe" in lp for lp in params["blocks"])


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


TEXTS = [f"doc {i} topic{i % 5}" for i in range(120)]
N_REQ = 8


def _drive(eng, reqs):
    eng._retrieve_batch(reqs)
    eng.pipeline.context_queue.put_many(reqs)
    guard = 0
    while eng.pump_once() < len(reqs):
        guard += 1
        assert guard < 100 * len(reqs), "mini-trace stalled"
    return sorted(eng.completed, key=lambda r: r.rid)


@pytest.mark.parametrize("arch,seed", [("gemma2-2b", 2),
                                       ("granite-moe-1b-a400m", 0)])
def test_fig8_paged_minitrace_matches_jax_engine(tmp_path, arch, seed):
    """fig8's ``paged`` row (ctx 32, max_new 4, page 8, chunks of 16, 3
    slots) through both engines, pumped single-threaded."""
    jcfg, jparams = _jax_weights(arch, {}, seed)
    cfg = get_config(arch).reduced()
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu", dtype=torch.float32)
    g = dict(ctx_len=32, max_new_tokens=4)
    knobs = dict(num_slots=3, paged=True, page_size=PAGE, prefill_chunk=16)
    jstore = JaxVectorStore.build(TEXTS, JaxHashEmbedder(dim=32),
                                  num_partitions=4, root=str(tmp_path / "j"))
    jstore.spill(3)
    jeng = JaxEngine(jstore, JaxHashEmbedder(dim=32), JaxContinuous(
        jcfg, jparams, JaxGeneratorConfig(**g), **knobs),
        JaxBacklogScheduler(max_batch=8), JaxBacklogScheduler(max_batch=3),
        initial_partitions=3, policy_every=2)
    store = VectorStore.build(TEXTS, HashEmbedder(dim=32), num_partitions=4,
                              root=str(tmp_path / "t"), device="cpu")
    store.spill(3)
    eng = RagdollEngine(store, HashEmbedder(dim=32), ContinuousGenerator(
        cfg, params, GeneratorConfig(**g), device="cpu", **knobs),
        BacklogScheduler(max_batch=8), BacklogScheduler(max_batch=3),
        initial_partitions=3, policy_every=2, device="cpu")
    try:
        jreqs = _drive(jeng, [JaxRequest(rid=i, query=f"query {i}",
                                         arrival=time.perf_counter())
                              for i in range(N_REQ)])
        treqs = _drive(eng, [Request(rid=i, query=f"query {i}",
                                     arrival=time.perf_counter())
                             for i in range(N_REQ)])
    finally:
        jeng.streamer.close()
        eng.streamer.close()
    assert [r.rid for r in treqs] == list(range(N_REQ))
    for j, t in zip(jreqs, treqs):
        assert t.retrieved == j.retrieved, t.rid
        assert t.output == j.output, t.rid


def test_launch_serve_gemma2_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "gemma2-2b", "--device", "cpu", "--requests", "3",
                "--rate", "6000", "--chunks", "120"])
    out = capsys.readouterr().out
    assert "arch=gemma2-2b device=cpu" in out
