"""deepseek-v2-lite-16b in the port against the JAX package, on the CPU.

MLA (latent KV cache, absorbed decode), the dense first layer
(``first_k_dense``, ``first_dense_d_ff``) and the MoE layers with shared
experts, at ``.reduced()`` size (4 heads, q/k 24 = 16 nope + 8 rope, v
16, latent 32; one dense layer and one MLA + MoE layer) in fp32, on the
same converted weights (``PRNGKey(1)``) and the same prompts:

* the config copy field by field, with its byte counts at full size;
* ``mla_forward``'s prefill and decode outputs and caches;
* ``attention_reference`` and ``flash_attention_plain`` at a value head
  dim unlike the query/key's, against JAX's reference and its Pallas
  kernel (interpret mode), to 3e-5;
* one-shot prefill and dense decode logits (3e-4, the families' bar);
* greedy tokens of the whole-batch ``Generator``, the dense
  ``ContinuousGenerator`` and ``streamed=True`` equal the JAX whole-batch
  ``Generator``'s, after asserting every greedy gap exceeds 1e-3;
* the capacity path's drops in a whole-batch prefill, row for row;
* ``paged=True`` and chunked prefill raise, in both packages;
* ``resize_cache_rows`` on the MLA leaves; the streamed executor's order
  and bytes over layers of two sizes; ``launch/serve.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.core.prefetch import PrefetchPolicy as JaxPolicy
from repro.core.prefetch import StreamedExecutor as JaxExecutor
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import attention as jax_attention
from repro.models import moe as jmoe
from repro.models.model import Model as JaxModel
from repro.models.model import init_cache as jax_init_cache
from repro.serving.generator import Generator as JaxGenerator
from repro.serving.generator import GeneratorConfig as JaxGeneratorConfig
from repro.serving.kvpool import PagedKVCache as JaxPagedKVCache
from repro.serving.kvpool import resize_cache_rows as jax_resize_rows

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.prefetch import PrefetchPolicy, StreamedExecutor
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.models import attention, moe, transformer
from repro_torch.models.model import Model, init_cache
from repro_torch.serving import ContinuousGenerator, Generator
from repro_torch.serving import GeneratorConfig
from repro_torch.serving.kvpool import PagedKVCache, resize_cache_rows

ARCH = "deepseek-v2-lite-16b"
CTX, MAX_NEW, STEPS = 24, 5, 6
LOGIT_TOL, ATTN_TOL, MARGIN = 3e-4, 3e-5, 1e-3


def _prompts(n=6):
    return [f"query {i} topic{i % 3} alpha beta" for i in range(n)]


def _gap(logits) -> float:
    top2 = np.sort(np.asarray(logits, dtype=np.float32), axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_config(ARCH).reduced()
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(1),
                                               jnp.float32)
    cfg = get_config(ARCH).reduced()
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu", dtype=torch.float32)
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def jax_tokens(weights):
    """The JAX whole-batch ``Generator``'s tokens and its least greedy
    gap."""
    jcfg, jparams, _, _ = weights
    jgen = JaxGenerator(jcfg, jparams, JaxGeneratorConfig(
        ctx_len=CTX, max_new_tokens=MAX_NEW))
    gaps = []

    def rec(fn):
        def call(*a):
            logits, cache = fn(*a)
            gaps.append(_gap(logits))
            return logits, cache
        return call

    jgen._prefill, jgen._decode = rec(jgen._prefill), rec(jgen._decode)
    return jgen.generate(_prompts()), min(gaps)


# ------------------------------------------------------------- config
def test_config_copy_matches_reference():
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    for f in cfg.__dataclass_fields__:
        want, got = getattr(jcfg, f), getattr(cfg, f)
        if f in ("moe", "mla") and want is not None:
            assert vars(got) == vars(want), f
        else:
            assert got == want, f
    for c, j in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced())):
        assert c.param_count() == j.param_count()
        assert c.param_count(active_only=True) == \
            j.param_count(active_only=True)
        assert c.weight_bytes() == j.weight_bytes()
        assert c.kv_cache_bytes_per_token() == j.kv_cache_bytes_per_token()
    assert cfg.weight_bytes() == 31_412_940_800
    assert cfg.kv_cache_bytes_per_token() == 31_104     # 27 x (512 + 64) x 2
    assert cfg.layer_kinds()[:2] == (("mla", "dense"), ("mla", "moe"))


def test_init_layouts_match_reference(weights):
    """The port's own ``init`` gives the reference's leaves and shapes:
    the prefix first (a dense MLP of ``first_dense_d_ff``), then MLA + MoE
    layers with shared experts."""
    _, jparams, cfg, _ = weights
    own = Model(cfg, device="cpu").init(seed=0, dtype=torch.float32)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(np.shape(tree))

    assert len(own["blocks"]) == cfg.num_layers
    assert shapes(own["blocks"][0]) == shapes(jparams["prefix"][0])
    stacked = shapes(jparams["blocks"][0])
    assert shapes(own["blocks"][1]) == jax.tree.map(
        lambda s: s[1:], stacked, is_leaf=lambda x: isinstance(x, tuple))
    assert own["blocks"][0]["ffn"]["w_gate"].shape == (
        cfg.d_model, cfg.first_dense_d_ff)
    assert "shared" in own["blocks"][1]["moe"]
    assert own["blocks"][1]["moe"]["router"].dtype == torch.float32


# ----------------------------------------------------------- MLA forward
def test_mla_forward_prefill_and_decode_match_jax():
    """Prefill writes ``ckv``/``krope`` rows ``[0, S)``; decode at
    per-row positions writes one row each and attends in the absorbed
    form over the whole cache, masked past ``pos``."""
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp = jax_attention.init_mla(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = {k: _t(v) for k, v in jp.items()}
    rng = np.random.default_rng(4)
    b, s, total = 2, 12, 16
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    jcache = {n: jnp.zeros(sp[0], jnp.float32) for n, sp in
              attention.make_mla_cache_spec(cfg, b, total, None).items()}
    tcache = {n: torch.zeros(sp[0]) for n, sp in
              attention.make_mla_cache_spec(cfg, b, total, None).items()}
    want, jcache = jax_attention.mla_forward(jp, jnp.asarray(x), jcfg,
                                             mode="prefill", cache=jcache)
    got = attention.mla_forward(tp, torch.from_numpy(x), cfg,
                                mode="prefill", cache=tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    for pos in ([12, 12], [13, 12], [14, 15]):
        xd = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
        p = np.asarray(pos, np.int32)
        want, jcache = jax_attention.mla_forward(
            jp, jnp.asarray(xd), jcfg, mode="decode", cache=jcache,
            pos=jnp.asarray(p))
        got = attention.mla_forward(tp, torch.from_numpy(xd), cfg,
                                    mode="decode", cache=tcache,
                                    pos=torch.from_numpy(p))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
        for n in ("ckv", "krope"):
            np.testing.assert_allclose(tcache[n].numpy(),
                                       np.asarray(jcache[n]), atol=2e-6)


@pytest.mark.parametrize("case", ["causal", "kv_len"])
def test_attention_at_dv_unlike_dqk_matches_jax(case):
    """``attention_reference`` and ``flash_attention_plain`` return
    ``(B, Sq, H, DV)`` at q/k 24 and v 16 (GQA 4/2), against JAX's
    reference and its Pallas kernel in interpret mode."""
    rng = np.random.default_rng(5)
    b, s, h, kvh, d, dv = 2, 32, 4, 2, 24, 16
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kvh, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kvh, dv)).astype(np.float32)
    kw = dict(causal=True, scale=d ** -0.5)
    if case == "kv_len":
        kw = dict(causal=False, scale=0.3)
        kv_len = np.array([20, 32], np.int32)
    jkw = dict(kw, kv_len=jnp.asarray(kv_len)) if case == "kv_len" else kw
    tkw = dict(kw, kv_len=_t(kv_len)) if case == "kv_len" else kw
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(jax_ref.attention_reference(jq, jk, jv, **jkw))
    kernel = np.asarray(jax_ops.flash_attention(
        jq, jk, jv, impl="pallas", block_q=16, block_kv=16, **jkw))
    assert want.shape == kernel.shape == (b, s, h, dv)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got_ref = ref.attention_reference(tq, tk, tv, **tkw)
    got_plain = fa.flash_attention_plain(tq, tk, tv, block_kv=8, **tkw)
    for got in (got_ref, got_plain):
        assert tuple(got.shape) == (b, s, h, dv)
        np.testing.assert_allclose(got.numpy(), want, atol=ATTN_TOL)
        np.testing.assert_allclose(got.numpy(), kernel, atol=ATTN_TOL)


def test_flash_kernel_shapes_are_checked_before_any_build():
    """A pair of head dims the bf16 kernel is not built for raises with
    the built pairs in the message; CPU tensors are refused outright."""
    assert (192, 128) in fa.BF16_HEAD_DIMS
    q = torch.zeros((1, 4, 2, 192))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_cuda(q, q, torch.zeros((1, 4, 2, 128)))


# ---------------------------------------------------------------- logits
def test_one_shot_prefill_and_dense_decode_logits_match_jax(weights):
    jcfg, jparams, cfg, params = weights
    jm, tm = JaxModel(jcfg, remat=False), Model(cfg, device="cpu")
    rng = np.random.default_rng(6)
    prompts = rng.integers(2, cfg.vocab_size, size=(2, CTX)).astype(np.int32)
    total = CTX + STEPS
    jcache = jax_init_cache(jcfg, 2, total, jnp.float32)
    tcache = init_cache(cfg, 2, total, torch.float32, "cpu")
    assert set(tcache["blocks"][0]) == {"ckv", "krope"}
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
    # the caches agree too: the prefix layer's and the MoE layer's latents
    for i, tc in enumerate(tcache["blocks"]):
        jc = jcache["prefix"][0] if i == 0 else jax.tree.map(
            lambda a: a[0], jcache["blocks"][0])
        for n in ("ckv", "krope"):
            np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                       atol=1e-4)


# ------------------------------------------------------------ generators
GEN_PATHS = {
    "whole_batch": dict(),
    "streamed": dict(streamed=True),
    "dense": dict(continuous=True),
    "dense_streamed": dict(continuous=True, streamed=True),
}


@pytest.mark.parametrize("path", list(GEN_PATHS))
def test_generator_paths_match_jax_tokens(weights, jax_tokens, path):
    _, _, cfg, params = weights
    want, gap = jax_tokens
    assert gap > MARGIN, "prompts lack a greedy margin"
    kw = dict(GEN_PATHS[path])
    g = GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW)
    if kw.pop("continuous", False):
        cont = ContinuousGenerator(cfg, params, g, num_slots=3, device="cpu",
                                   **kw)
        got = cont.run(_prompts(), schedule=[2, 1, 0, 1, 3])
    else:
        got = Generator(cfg, params, g, device="cpu", **kw).generate(
            _prompts())
    assert got == want


def test_dense_resize_keeps_tokens(weights, jax_tokens):
    """The dense slot table grown and shrunk between joins: the latent
    rows ride ``resize_cache_rows`` and the slot scatter."""
    _, _, cfg, params = weights
    want, _ = jax_tokens
    cont = ContinuousGenerator(cfg, params, GeneratorConfig(
        ctx_len=CTX, max_new_tokens=MAX_NEW), num_slots=2, device="cpu")
    prompts = _prompts()
    results, pending, tick = [None] * len(prompts), list(
        enumerate(prompts))[::-1], 0
    while pending or cont.active_slots:
        if tick == 2:
            assert cont.resize(4) == 4
        if tick == 5:
            cont.resize(3)
        while pending and cont.free_slots:
            key, text = pending.pop()
            assert cont.join(key, text) is not None
        cont.step()
        for key, text, _ in cont.harvest():
            results[key] = text
        tick += 1
        assert tick < 200
    assert results == want
    assert cont.cache["blocks"][1]["ckv"].shape[0] == cont.num_slots


def test_whole_batch_prefill_capacity_drops_match_jax(weights,
                                                      monkeypatch):
    """With the capacity threshold lowered in both packages, a
    whole-batch prefill of the six padded prompts (288 rows, capacity 96
    an expert) takes the capacity path: the same rows come back dropped
    (zero) in both, as many as ``capacity_drops`` counts, and the
    prefill's logits agree."""
    jcfg, jparams, cfg, params = weights
    monkeypatch.setattr(jmoe, "CAPACITY_THRESHOLD", 64)
    monkeypatch.setattr(moe, "CAPACITY_THRESHOLD", 64)
    seen = {"jax": [], "port": []}
    jgrouped, tgrouped = jmoe.grouped_ffn, moe.grouped_ffn

    def jrec(p, xs, gs, kind, impl="auto"):
        y = jgrouped(p, xs, gs, kind, impl)
        seen["jax"].append((np.asarray(gs), np.asarray(y)))
        return y

    def trec(p, xs, gs, kind, impl="auto"):
        y = tgrouped(p, xs, gs, kind, impl)
        seen["port"].append((gs.numpy(), y.numpy()))
        return y

    monkeypatch.setattr(jmoe, "grouped_ffn", jrec)
    monkeypatch.setattr(moe, "grouped_ffn", trec)
    from repro_torch.serving.generator import HashTokenizer
    tok = HashTokenizer(cfg.vocab_size)
    ids = np.stack([tok.encode(p, CTX) for p in _prompts()])
    total = CTX + 2
    with jax.disable_jit():
        jl, _ = JaxModel(jcfg, remat=False).prefill(
            jparams, jnp.asarray(ids), jax_init_cache(jcfg, 6, total,
                                                      jnp.float32))
    tl = Model(cfg, device="cpu").prefill(
        params, torch.from_numpy(ids), init_cache(cfg, 6, total,
                                                  torch.float32, "cpu"))
    assert len(seen["jax"]) == len(seen["port"]) == 1   # one MoE layer
    (jgs, jy), (tgs, ty) = seen["jax"][0], seen["port"][0]
    np.testing.assert_array_equal(tgs, jgs)
    dropped = ~jy.any(axis=1)
    np.testing.assert_array_equal(~ty.any(axis=1), dropped)
    assert int(moe.capacity_drops(torch.from_numpy(tgs), ty.shape[0])) == \
        int(dropped.sum()) > 0
    np.testing.assert_allclose(ty, jy, atol=2e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)


# -------------------------------------------------------------- refusals
def test_paged_and_chunked_prefill_raise_as_in_jax(weights):
    jcfg, jparams, cfg, params = weights
    g = GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW)
    with pytest.raises(NotImplementedError):
        JaxPagedKVCache(jcfg, 2, CTX + MAX_NEW, 8)
    with pytest.raises(NotImplementedError):
        PagedKVCache(cfg, 2, CTX + MAX_NEW, 8, device="cpu")
    with pytest.raises(NotImplementedError):
        ContinuousGenerator(cfg, params, g, num_slots=2, paged=True,
                            device="cpu")
    with pytest.raises(NotImplementedError):
        ContinuousGenerator(cfg, params, g, num_slots=2, paged=True,
                            prefill_chunk=8, device="cpu")
    cache = init_cache(cfg, 4, 8, torch.float32, "cpu")
    tab = torch.arange(1, 4, dtype=torch.int32)[None]
    ids = torch.ones((1, 8), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="attn-family"):
        Model(cfg, device="cpu").chunk_prefill(
            params, ids, cache, torch.zeros((1,), dtype=torch.int32), tab,
            kv_span=8)
    with pytest.raises(NotImplementedError, match="attn-family"):
        JaxModel(jcfg, remat=False).chunk_prefill(
            jparams, jnp.ones((1, 8), jnp.int32),
            jax_init_cache(jcfg, 4, 8, jnp.float32),
            jnp.zeros((1,), jnp.int32), block_tab=jnp.asarray(tab.numpy()),
            kv_span=8)


# ------------------------------------------------ cache rows, streaming
def test_resize_cache_rows_on_mla_leaves_matches_jax(weights):
    jcfg, _, cfg, _ = weights
    rng = np.random.default_rng(7)
    tc = init_cache(cfg, 3, 10, torch.float32, "cpu")
    jc = jax_init_cache(jcfg, 3, 10, jnp.float32)
    for i, layer in enumerate(tc["blocks"]):
        for n in ("ckv", "krope"):
            a = rng.normal(size=layer[n].shape).astype(np.float32)
            layer[n].copy_(torch.from_numpy(a))
            if i == 0:
                jc["prefix"][0][n] = jnp.asarray(a)
            else:
                jc["blocks"][0][n] = jnp.asarray(a)[None]
    for rows in (5, 2):
        resize_cache_rows(tc, rows)
        jc = jax_resize_rows(jc, rows)
        for i, layer in enumerate(tc["blocks"]):
            want = jc["prefix"][0] if i == 0 else jax.tree.map(
                lambda a: a[0], jc["blocks"][0])
            assert set(layer) == {"ckv", "krope"}
            for n in ("ckv", "krope"):
                assert layer[n].shape[0] == rows
                np.testing.assert_array_equal(layer[n].numpy(),
                                              np.asarray(want[n]))


def test_streamed_executor_streams_the_prefix_and_moe_layers(
        weights, monkeypatch):
    """Layers of two sizes (the dense prefix layer, the MLA + MoE layer):
    the port stages and runs them in the JAX executor's order, counts
    their bytes, and gives the JAX executor's logits."""
    jcfg, jparams, cfg, params = weights
    ex = StreamedExecutor(cfg, params, PrefetchPolicy(max_depth=1),
                          device="cpu")
    jex = JaxExecutor(jcfg, jparams, JaxPolicy(max_depth=1))
    per_layer = [sum(t.numel() * t.element_size()
                     for t in jax.tree.leaves(lp)) for lp in params["blocks"]]
    assert per_layer[0] != per_layer[1]
    assert ex.streamed_bytes == sum(per_layer)
    assert ex.layer_bytes == jex.layer_bytes == sum(per_layer) / 2
    assert ex.layer_kinds() == list(cfg.layer_kinds()) == \
        list(jex.layer_kinds())
    log, jlog = [], []
    stage, apply_layer = StreamedExecutor._stage, transformer.apply_layer
    monkeypatch.setattr(StreamedExecutor, "_stage",
                        lambda self, i: (log.append(i), stage(self, i))[1])

    def rec_apply(lp, *a, **kw):
        log.append("dense" if "ffn" in lp else "moe")
        return apply_layer(lp, *a, **kw)

    monkeypatch.setattr(transformer, "apply_layer", rec_apply)
    index = {id(lp): i for i, (_, lp) in enumerate(jex.layers)}
    put = jax.device_put
    monkeypatch.setattr(jax, "device_put", lambda x, *a, **kw: (
        jlog.append(index[id(x)]) if id(x) in index else None,
        put(x, *a, **kw))[1])
    toks = np.arange(2, 2 + 2 * CTX, dtype=np.int32).reshape(2, CTX)
    jd, td = jex.init_caches(2, CTX + 1), ex.init_caches(2, CTX + 1)
    jl = jex.prefill(jnp.asarray(toks), jd)
    tl = ex.prefill(torch.from_numpy(toks), td)
    assert log == [0, 1, "dense", "moe"]      # one layer ahead
    assert [i for i in log if isinstance(i, int)] == jlog == [0, 1]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl[0]),
                               atol=LOGIT_TOL)


def test_launch_serve_deepseek_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                "--rate", "6000", "--chunks", "120"])
    out = capsys.readouterr().out
    assert f"arch={ARCH} device=cpu" in out
