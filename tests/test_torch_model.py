"""Port model vs the JAX model on the same converted weights.

``Model(get_config("llama3-8b").reduced(num_layers=2))`` in fp32 on the
CPU: chunked prefill of two slots into a shared page pool, then 8 paged
decode steps, through the same block table in both packages.  Logits
agree to 1e-4; greedy tokens are equal (after asserting that every JAX
step's top-2 logit gap exceeds 1e-3, so equal tokens are a fair demand).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models.model import Model as JaxModel
from repro.models.model import init_cache as jax_init_cache

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models.model import Model, init_cache

CTX, CHUNK, PAGE, STEPS = 24, 8, 8, 8
MARGIN = 1e-3


def _margin(logits: np.ndarray) -> float:
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("llama3-8b").reduced(num_layers=2)
    jm = JaxModel(jcfg, remat=False)
    jparams = jm.init(jax.random.PRNGKey(0), jnp.float32)
    cfg = get_config("llama3-8b").reduced(num_layers=2)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu", dtype=torch.float32)
    return jm, jparams, Model(cfg, device="cpu"), params


def test_config_copy_matches_reference():
    jcfg = jax_get_config("llama3-8b")
    cfg = get_config("llama3-8b")
    assert cfg == type(cfg)(**{f: getattr(jcfg, f)
                               for f in cfg.__dataclass_fields__})
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.kv_cache_bytes_per_token() == jcfg.kv_cache_bytes_per_token()


def test_chunked_prefill_and_paged_decode_match_jax(models):
    jm, jparams, tm, params = models
    cfg = tm.cfg
    total = CTX + STEPS
    nmax = -(-total // PAGE)
    rng = np.random.default_rng(0)
    prompts = rng.integers(2, cfg.vocab_size, size=(2, CTX)).astype(np.int32)
    tab = np.zeros((2, nmax), np.int32)
    tab[0] = np.arange(1, nmax + 1)
    tab[1] = np.arange(nmax + 1, 2 * nmax + 1)[::-1]   # any page order
    pages = 2 * nmax + 1                              # + trash page 0

    jcache = jax_init_cache(jm.cfg, pages, PAGE, jnp.float32)
    jcache = {"blocks": [{k: v for k, v in c.items()}
                         for c in jcache["blocks"]]}
    tcache = init_cache(cfg, pages, PAGE, torch.float32, "cpu")
    jtab, ttab = jnp.asarray(tab), torch.from_numpy(tab)

    jlog, tlog = [], []
    for slot in range(2):
        for off in range(0, CTX, CHUNK):
            chunk = prompts[slot:slot + 1, off:off + CHUNK]
            jl, jcache = jm.chunk_prefill(
                jparams, jnp.asarray(chunk), jcache,
                jnp.full((1,), off, jnp.int32), block_tab=jtab[slot:slot + 1],
                kv_span=CTX)
            tl = tm.chunk_prefill(
                params, torch.from_numpy(chunk), tcache,
                torch.full((1,), off, dtype=torch.int32), ttab[slot:slot + 1],
                kv_span=CTX)
        jlog.append(np.asarray(jl)[0])
        tlog.append(tl[0].numpy())
    jlogits = [np.stack(jlog)]
    tlogits = [np.stack(tlog)]
    jcur = np.argmax(jlogits[0], -1).astype(np.int32)
    tcur = np.argmax(tlogits[0], -1).astype(np.int32)
    for t in range(STEPS - 1):
        pos = np.full((2,), CTX + t, np.int32)
        jl, jcache = jm.decode(jparams, jnp.asarray(jcur[:, None]), jcache,
                               jnp.asarray(pos), block_tab=jtab,
                               kv_span=total)
        tl = tm.decode(params, torch.from_numpy(tcur[:, None]), tcache,
                       torch.from_numpy(pos), ttab, kv_span=total)
        jlogits.append(np.asarray(jl))
        tlogits.append(tl.numpy())
        jcur = np.argmax(jlogits[-1], -1).astype(np.int32)
        tcur = np.argmax(tlogits[-1], -1).astype(np.int32)

    jall, tall = np.stack(jlogits), np.stack(tlogits)
    assert _margin(jall) > MARGIN, "prompts lack a greedy margin"
    np.testing.assert_allclose(tall, jall, atol=1e-4)
    np.testing.assert_array_equal(tall.argmax(-1), jall.argmax(-1))


# ------------------------------------------- residual adds fused into norms
def _unfused_logits(params, cfg, inputs, cache, *, mode, pos=None,
                    block_tab=None, kv_span=None, last):
    """The layer stack with every residual add a separate op before its
    norm: the composition the fused stack must reproduce bit for bit."""
    from repro_torch.models import attention, layers, transformer
    x = transformer._embed_inputs(params, cfg, inputs)
    for lp, (mixer, _), c in zip(params["blocks"], cfg.layer_kinds(),
                                 cache["blocks"]):
        h = layers.rms_norm(x, lp["norm1"], cfg.norm_eps)
        x = x + attention.attention_forward(
            lp["attn"], h, cfg, mixer=mixer, mode=mode, cache=c, pos=pos,
            block_tab=block_tab, kv_span=kv_span)
        h2 = layers.rms_norm(x, lp["norm2"], cfg.norm_eps)
        x = x + layers.apply_mlp(lp["ffn"], h2, cfg.mlp_kind)
    if last:
        x = x[:, -1:]
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return transformer.unembed(params, cfg, x)[:, 0]


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


def _same(a, b):
    assert torch.equal(a, b)


def _caches_equal(a, b):
    for ca, cb in zip(a["blocks"], b["blocks"]):
        for name in ca:
            _same(ca[name], cb[name])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("path", ["one_shot_prefill", "dense_decode",
                                  "chunked_prefill", "paged_decode"])
def test_fused_residual_norms_match_unfused_stack(models, path, dtype):
    """Prefill, chunked prefill and decode (dense and paged) of the fused
    stack give the same logits and caches, bit for bit, as the stack with
    each residual add on its own."""
    _, _, tm, params = models
    cfg = tm.cfg
    params = _cast(params, dtype)
    rng = np.random.default_rng(9)
    prompts = torch.from_numpy(
        rng.integers(2, cfg.vocab_size, size=(2, CTX)).astype(np.int32))
    total = CTX + STEPS
    if path in ("one_shot_prefill", "dense_decode"):
        fused = init_cache(cfg, 2, total, dtype, "cpu")
        plain = init_cache(cfg, 2, total, dtype, "cpu")
        got = tm.prefill(params, prompts, fused)
        _same(got, _unfused_logits(params, cfg, prompts, plain,
                                   mode="prefill", last=True))
        cur = got.argmax(-1).to(torch.int32)[:, None]
        for t in range(STEPS if path == "dense_decode" else 0):
            pos = torch.full((2,), CTX + t, dtype=torch.int32)
            got = tm.decode(params, cur, fused, pos)
            _same(got, _unfused_logits(params, cfg, cur, plain,
                                       mode="decode", pos=pos, last=False))
            cur = got.argmax(-1).to(torch.int32)[:, None]
        _caches_equal(fused, plain)
        return
    nmax = -(-total // PAGE)
    tab = torch.arange(1, 2 * nmax + 1, dtype=torch.int32).reshape(2, nmax)
    fused = init_cache(cfg, 2 * nmax + 1, PAGE, dtype, "cpu")
    plain = init_cache(cfg, 2 * nmax + 1, PAGE, dtype, "cpu")
    last = []
    for slot in range(2):
        for off in range(0, CTX, CHUNK):
            chunk = prompts[slot:slot + 1, off:off + CHUNK]
            offset = torch.full((1,), off, dtype=torch.int32)
            got = tm.chunk_prefill(params, chunk, fused, offset,
                                   tab[slot:slot + 1], kv_span=CTX)
            _same(got, _unfused_logits(
                params, cfg, chunk, plain, mode="prefill", pos=offset,
                block_tab=tab[slot:slot + 1], kv_span=CTX, last=True))
        last.append(got[0])
    cur = torch.stack(last).argmax(-1).to(torch.int32)[:, None]
    for t in range(STEPS if path == "paged_decode" else 0):
        pos = torch.full((2,), CTX + t, dtype=torch.int32)
        got = tm.decode(params, cur, fused, pos, tab, kv_span=total)
        _same(got, _unfused_logits(params, cfg, cur, plain, mode="decode",
                                   pos=pos, block_tab=tab, kv_span=total,
                                   last=False))
        cur = got.argmax(-1).to(torch.int32)[:, None]
    _caches_equal(fused, plain)


# --------------------------------------- float inputs as embeddings
@pytest.mark.parametrize("arch", ["llama3-8b", "gemma2-2b"])
def test_float_inputs_are_embeddings_as_in_jax(arch):
    """A floating ``inputs`` tensor is taken as embeddings ``(B, S, D)``,
    not truncated to token ids, and scaled as the config says (gemma2
    scales its embeddings): ``_embed_inputs`` and one-shot prefill
    against the JAX package's on the same converted weights."""
    from repro.models import transformer as jax_transformer
    from repro_torch.models import transformer
    jcfg = jax_get_config(arch).reduced(num_layers=2)
    cfg = get_config(arch).reduced(num_layers=2)
    assert cfg.scale_embeddings == (arch == "gemma2-2b")
    jm = JaxModel(jcfg, remat=False)
    jparams = jm.init(jax.random.PRNGKey(2), jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu", dtype=torch.float32)
    emb = np.random.default_rng(8).normal(
        0, 0.5, size=(2, 12, cfg.d_model)).astype(np.float32)
    want = np.asarray(jax_transformer._embed_inputs(jparams, jcfg,
                                                    jnp.asarray(emb)))
    got = transformer._embed_inputs(params, cfg, torch.from_numpy(emb))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    jl, _ = jm.prefill(jparams, jnp.asarray(emb),
                       jax_init_cache(jcfg, 2, 12, jnp.float32))
    tl = Model(cfg, device="cpu").prefill(
        params, torch.from_numpy(emb), init_cache(cfg, 2, 12, torch.float32,
                                                  "cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    # integer ids still index the table
    ids = torch.tensor([[3, 5]], dtype=torch.int32)
    x = transformer._embed_inputs(params, cfg, ids)
    scale = cfg.d_model ** 0.5 if cfg.scale_embeddings else 1.0
    np.testing.assert_allclose(x.numpy(), params["embed"][[3, 5]][None]
                               .numpy() * scale, rtol=1e-6)
