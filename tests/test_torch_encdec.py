"""The embed frontend in the port against the JAX package, on the CPU:
seamless-m4t-medium's encoder-decoder and chameleon-34b's embedding
inputs.

seamless at ``.reduced()`` (2 encoder + 2 decoder layers, d_model 64, 4/2
heads x 16, GELU MLP) and a variant at 4/4 heads x 64 (G = 1 at head dim
64, the decode kernels' new instance); chameleon at ``.reduced()`` (2
layers, 4/2 heads x 16, SwiGLU, no token table).  fp32 on the same weights
converted from ``PRNGKey(SEED)`` and the same numpy inputs:

* the config copies field by field; ``ASSIGNED_ARCHS`` is the
  reference's ten;
* the converted tree's keys are JAX's (the encoder's and the cross
  leaves; no ``embed`` for chameleon), the cache specs' ``ck``/``cv``;
* seamless's ``encode``, its prefill and dense decode logits (3e-4, the
  bar of ``tests/test_models.py``) and every layer's cache, ``ck``/``cv``
  included; greedy tokens after asserting every JAX greedy gap exceeds
  1e-3; chameleon's prefill and decode over embeddings;
* chameleon's ``StreamedExecutor`` against the JAX executor: logits and
  the staging order; it refuses seamless;
* the refusals where the reference crashes or refuses: the generators,
  the paged pool and ``launch/serve.py --arch``;
* the plain kernels against JAX's: flash non-causal at Sq != Sk and a
  ragged Sk (3e-5), dense decode at 16/16 x 64 (2e-5), the bars of
  ``tests/test_kernels.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import ASSIGNED_ARCHS as JAX_ASSIGNED_ARCHS
from repro.configs import get_config as jax_get_config
from repro.core.prefetch import PrefetchPolicy as JaxPolicy
from repro.core.prefetch import StreamedExecutor as JaxExecutor
from repro.kernels import ops as jops
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import transformer as jtransformer
from repro.models.model import Model as JaxModel
from repro.models.model import init_cache as jax_init_cache
from repro.models.model import make_cache_specs as jax_cache_specs
from repro.serving.generator import Generator as JaxGenerator
from repro.serving.generator import GeneratorConfig as JaxGeneratorConfig
from repro.serving.kvpool import PagedKVCache as JaxPagedKVCache

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.prefetch import PrefetchPolicy, StreamedExecutor
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import transformer
from repro_torch.models.model import Model, init_cache, make_cache_specs
from repro_torch.serving import ContinuousGenerator, Generator
from repro_torch.serving import GeneratorConfig
from repro_torch.models.transformer import serves_tokens
from repro_torch.serving.kvpool import PagedKVCache

SEAMLESS, CHAMELEON = "seamless-m4t-medium", "chameleon-34b"
ENC, DEC, STEPS = 24, 8, 5          # encoder frames, decoder prompt, steps
LOGIT_TOL, MARGIN = 3e-4, 1e-3
SEED = 1
# (reduced() overrides): the reduced shape, and G = 1 at head dim 64
VARIANTS = [{}, {"num_heads": 4, "num_kv_heads": 4, "head_dim": 64}]
VARIANT_IDS = ["reduced", "g1_d64"]


def _convert(jcfg, cfg, seed=SEED):
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(seed),
                                               jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu", dtype=torch.float32)
    return jparams, params


@pytest.fixture(scope="module", params=VARIANTS, ids=VARIANT_IDS)
def seamless(request):
    jcfg = jax_get_config(SEAMLESS).reduced(**request.param)
    cfg = get_config(SEAMLESS).reduced(**request.param)
    return (jcfg, cfg) + _convert(jcfg, cfg)


@pytest.fixture(scope="module")
def chameleon():
    jcfg = jax_get_config(CHAMELEON).reduced()
    cfg = get_config(CHAMELEON).reduced()
    return (jcfg, cfg) + _convert(jcfg, cfg)


def _frames(cfg, b=2, n=ENC, seed=5):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, n, cfg.d_model)).astype(np.float32)


def _paths(tree, prefix=()):
    """Key paths of a nested dict (lists by index)."""
    if isinstance(tree, dict):
        return {p for k, v in tree.items() for p in _paths(v, prefix + (k,))}
    if isinstance(tree, list):
        return {p for i, v in enumerate(tree)
                for p in _paths(v, prefix + (i,))}
    return {prefix}


def _layer_paths(layers):
    return {p for lp in layers for p in _paths(lp)}


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", [SEAMLESS, CHAMELEON])
def test_config_copy_matches_reference(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for f in cfg.__dataclass_fields__:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    for c, j in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced())):
        assert c.param_count() == j.param_count()
        assert c.weight_bytes() == j.weight_bytes()
        assert c.kv_cache_bytes_per_token() == j.kv_cache_bytes_per_token()


def test_registry_is_the_reference_ten():
    assert ASSIGNED_ARCHS == JAX_ASSIGNED_ARCHS
    assert len(ASSIGNED_ARCHS) == 10
    # every reference config passes the port's family check
    for arch in ASSIGNED_ARCHS:
        transformer._check_family(jax_get_config(arch))
    # chameleon at full depth: the reference's tree holds 33.76 B
    # parameters, 67.5 GB in bf16; ``weight_bytes`` counts a token table
    # that the embed frontend does not have
    cham = get_config(CHAMELEON)
    specs = JaxModel(jax_get_config(CHAMELEON)).param_specs(jnp.bfloat16)
    tree_bytes = sum(s.size * 2 for s in jax.tree.leaves(specs))
    assert tree_bytes == 67_513_106_432
    assert cham.weight_bytes() - tree_bytes == \
        2 * cham.vocab_size * cham.d_model


# --------------------------------------------------------------- trees
def test_seamless_tree_keys_match_jax(seamless):
    jcfg, cfg, jparams, params = seamless
    assert set(params) == set(jparams) == {
        "embed", "blocks", "final_norm", "encoder"}     # tied: no lm_head
    jlayers = [jax.tree.map(lambda a: a[0], b) for b in jparams["blocks"]]
    assert _layer_paths(params["blocks"]) == _layer_paths(jlayers)
    assert {("norm_cross",), ("cross", "wq"), ("cross", "wo")} <= \
        _layer_paths(params["blocks"])
    enc = jparams["encoder"]
    assert set(params["encoder"]) == set(enc) == {"blocks", "final_norm"}
    assert len(params["encoder"]["blocks"]) == cfg.num_encoder_layers == 2
    jenc = [jax.tree.map(lambda a: a[0], b) for b in enc["blocks"]]
    assert _layer_paths(params["encoder"]["blocks"]) == _layer_paths(jenc)
    assert ("cross", "wq") not in _layer_paths(params["encoder"]["blocks"])
    # and the port's own init draws the same tree
    mine = Model(cfg, device="cpu").init(seed=0, dtype=torch.float32)
    assert _paths(mine) == _paths(params)


def test_chameleon_tree_has_no_token_table(chameleon):
    jcfg, cfg, jparams, params = chameleon
    assert "embed" not in jparams and "embed" not in params
    assert set(params) == set(jparams) == {"blocks", "final_norm", "lm_head"}
    mine = Model(cfg, device="cpu").init(seed=0, dtype=torch.float32)
    assert _paths(mine) == _paths(params)


def test_seamless_cache_specs_carry_cross_leaves(seamless):
    jcfg, cfg, _, _ = seamless
    spec = make_cache_specs(cfg, 3, 20, torch.float32, enc_len=12)["blocks"]
    jspec = jax_cache_specs(jcfg, 3, 20, jnp.float32, enc_len=12)["blocks"]
    assert len(spec) == cfg.num_layers and len(jspec) == 1
    for layer in spec:
        assert set(layer) == set(jspec[0]) == {"k", "v", "ck", "cv"}
        for n, (shape, dt) in layer.items():
            assert (cfg.num_layers,) + shape == tuple(jspec[0][n].shape), n
            assert str(dt).replace("torch.", "") == str(jspec[0][n].dtype)
    # no enc_len: no cross leaves, as the reference
    assert set(make_cache_specs(cfg, 3, 20)["blocks"][0]) == {"k", "v"}


# ----------------------------------------------------------- seamless
def test_seamless_encode_matches_jax(seamless):
    jcfg, cfg, jparams, params = seamless
    frames = _frames(cfg)
    want = jtransformer.encode(jparams, jcfg, jnp.asarray(frames), None)
    got = transformer.encode(params, cfg, torch.from_numpy(frames))
    assert got.shape == (2, ENC, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_TOL)


def _seamless_run(seamless, steps=STEPS, seed=9):
    """JAX and port: prefill on frames + a decoder prompt (drawn from
    ``seed``), then ``steps`` greedy dense decode steps (JAX's tokens fed
    to both).  Returns both runs' logits and caches."""
    jcfg, cfg, jparams, params = seamless
    jm, tm = JaxModel(jcfg, remat=False), Model(cfg, device="cpu")
    frames = _frames(cfg, seed=seed - 4)
    rng = np.random.default_rng(seed)
    prompt = rng.integers(2, cfg.vocab_size, size=(2, DEC)).astype(np.int32)
    total = DEC + steps
    jcache = jax_init_cache(jcfg, 2, total, jnp.float32, enc_len=ENC)
    tcache = init_cache(cfg, 2, total, torch.float32, "cpu", enc_len=ENC)
    jl, jcache = jax.jit(jm.prefill)(jparams, jnp.asarray(prompt), jcache,
                                     jnp.asarray(frames))
    tl = tm.prefill(params, torch.from_numpy(prompt), tcache,
                    enc_embeds=torch.from_numpy(frames))
    jall, tall = [np.asarray(jl)], [tl.numpy()]
    jdec = jax.jit(jm.decode)
    toks = []
    for t in range(steps):
        cur = np.argmax(jall[-1], -1).astype(np.int32)
        toks.append(cur)
        pos = np.full((2,), DEC + t, np.int32)
        jl, jcache = jdec(jparams, jnp.asarray(cur[:, None]), jcache,
                          jnp.asarray(pos))
        tl = tm.decode(params, torch.from_numpy(cur[:, None]), tcache,
                       torch.from_numpy(pos))
        jall.append(np.asarray(jl))
        tall.append(tl.numpy())
    return np.stack(jall), np.stack(tall), jcache, tcache


def _gaps(logits):
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def test_seamless_prefill_and_decode_match_jax(seamless):
    jcfg, cfg, _, _ = seamless
    jall, tall, jcache, tcache = _seamless_run(seamless)
    np.testing.assert_allclose(tall, jall, atol=LOGIT_TOL)
    for i, tc in enumerate(tcache["blocks"]):
        assert set(tc) == {"k", "v", "ck", "cv"}
        for n, leaf in tc.items():
            np.testing.assert_allclose(
                leaf.numpy(), np.asarray(jcache["blocks"][0][n][i]),
                atol=1e-4, err_msg=f"layer {i} {n}")
        assert tc["ck"].shape == (2, ENC, cfg.num_kv_heads,
                                  cfg.resolved_head_dim)


def test_seamless_greedy_tokens_match_jax(seamless):
    """Greedy tokens over 8 steps (inputs from seed 10): every JAX gap
    above the margin, then the port's tokens are JAX's."""
    jall, tall, _, _ = _seamless_run(seamless, steps=8, seed=10)
    assert _gaps(jall).min() > MARGIN, "inputs lack a greedy margin"
    np.testing.assert_array_equal(tall.argmax(-1), jall.argmax(-1))


def test_seamless_refuses_what_the_reference_cannot_serve(seamless):
    jcfg, cfg, _, params = seamless
    model = Model(cfg, device="cpu")
    cache = init_cache(cfg, 1, DEC, torch.float32, "cpu", enc_len=ENC)
    toks = torch.zeros((1, DEC), dtype=torch.int32)
    with pytest.raises(ValueError, match="enc_embeds"):
        model.prefill(params, toks, cache)
    with pytest.raises(ValueError, match="enc_len"):
        model.prefill(params, toks, init_cache(cfg, 1, DEC, torch.float32,
                                               "cpu"),
                      enc_embeds=torch.from_numpy(_frames(cfg, 1)))
    with pytest.raises(NotImplementedError, match="one-shot"):
        model.chunk_prefill(params, toks, cache,
                            torch.zeros(1, dtype=torch.int32),
                            torch.ones((1, 1), dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="dense cache"):
        model.decode(params, toks[:, :1], cache,
                     torch.zeros(1, dtype=torch.int32),
                     torch.ones((1, 1), dtype=torch.int32))


# ----------------------------------------------------------- chameleon
def test_chameleon_prefill_and_decode_over_embeddings_match_jax(chameleon):
    jcfg, cfg, jparams, params = chameleon
    jm, tm = JaxModel(jcfg, remat=False), Model(cfg, device="cpu")
    rng = np.random.default_rng(11)
    prompt = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    steps = rng.normal(size=(STEPS, 2, 1, cfg.d_model)).astype(np.float32)
    total = 12 + STEPS
    jcache = jax_init_cache(jcfg, 2, total, jnp.float32)
    tcache = init_cache(cfg, 2, total, torch.float32, "cpu")
    jl, jcache = jax.jit(jm.prefill)(jparams, jnp.asarray(prompt), jcache)
    jall = [np.asarray(jl)]
    tall = [tm.prefill(params, torch.from_numpy(prompt), tcache).numpy()]
    jdec = jax.jit(jm.decode)
    for t in range(STEPS):
        pos = np.full((2,), 12 + t, np.int32)
        jl, jcache = jdec(jparams, jnp.asarray(steps[t]), jcache,
                          jnp.asarray(pos))
        jall.append(np.asarray(jl))
        tall.append(tm.decode(params, torch.from_numpy(steps[t]), tcache,
                              torch.from_numpy(pos)).numpy())
    np.testing.assert_allclose(np.stack(tall), np.stack(jall),
                               atol=LOGIT_TOL)
    for i, tc in enumerate(tcache["blocks"]):
        for n, leaf in tc.items():
            np.testing.assert_allclose(
                leaf.numpy(), np.asarray(jcache["blocks"][0][n][i]),
                atol=1e-4)


def test_chameleon_streamed_executor_matches_jax(chameleon, monkeypatch):
    """The port's executor over embeddings: the JAX executor's logits at
    prefill and at each decode step, its layers staged in the JAX
    executor's order (one ahead), and zero logits for a step with no live
    slot (no token table to take the dtype from)."""
    jcfg, cfg, jparams, params = chameleon
    ex = StreamedExecutor(cfg, params, PrefetchPolicy(max_depth=1),
                          device="cpu")
    jex = JaxExecutor(jcfg, jparams, JaxPolicy(max_depth=1))
    assert "embed" not in ex.top and set(ex.top) == {"final_norm",
                                                     "lm_head"}
    log, jlog = [], []
    stage = StreamedExecutor._stage
    monkeypatch.setattr(StreamedExecutor, "_stage",
                        lambda self, i: (log.append(i), stage(self, i))[1])
    index = {id(lp): i for i, (_, lp) in enumerate(jex.layers)}
    put = jax.device_put
    monkeypatch.setattr(jax, "device_put", lambda x, *a, **kw: (
        jlog.append(index[id(x)]) if id(x) in index else None,
        put(x, *a, **kw))[1])
    rng = np.random.default_rng(13)
    prompt = rng.normal(size=(2, 10, cfg.d_model)).astype(np.float32)
    jd, td = jex.init_caches(2, 10 + 3), ex.init_caches(2, 10 + 3)
    jl, jd = jex.prefill(jnp.asarray(prompt), jd)
    tl = ex.prefill(torch.from_numpy(prompt), td)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    for t in range(3):
        x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        pos = np.full((2,), 10 + t, np.int32)
        jl, jd = jex.decode(jnp.asarray(x), jd, jnp.asarray(pos))
        tl = ex.decode(torch.from_numpy(x), td, torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL)
    assert log == jlog == list(range(cfg.num_layers)) * 4
    dead = ex.decode(torch.from_numpy(x), td, torch.from_numpy(pos),
                     slot_mask=np.zeros(2, bool))
    assert dead.shape == (2, cfg.vocab_size) and not dead.any()
    assert dead.dtype == torch.float32


def test_streamed_executor_refuses_seamless(seamless):
    _, cfg, _, params = seamless
    with pytest.raises(NotImplementedError, match="enc_embeds"):
        StreamedExecutor(cfg, params, PrefetchPolicy(), device="cpu")


# ------------------------------------------------------------ refusals
@pytest.mark.parametrize("arch", [SEAMLESS, CHAMELEON])
def test_generators_and_pool_refuse_where_the_reference_fails(arch):
    """The reference's whole-batch ``Generator`` crashes on both
    (seamless: ``encode`` gets ``enc_embeds=None``; chameleon: no
    ``embed``) and its pool refuses the encoder-decoder; the port's
    generators, dense or paged, and its pool raise ``NotImplementedError``
    for both."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jparams, params = _convert(jcfg, cfg)
    with pytest.raises((AttributeError, KeyError, TypeError)):
        JaxGenerator(jcfg, jparams, JaxGeneratorConfig(
            ctx_len=8, max_new_tokens=2)).generate(["a prompt"])
    if jcfg.encdec:
        with pytest.raises(NotImplementedError):
            JaxPagedKVCache(jcfg, 2, 16, 8)
    g = GeneratorConfig(ctx_len=8, max_new_tokens=2)
    with pytest.raises(NotImplementedError, match="Model.prefill"):
        Generator(cfg, params, g, device="cpu")
    assert not serves_tokens(cfg)
    for kw in ({}, {"paged": True}, {"streamed": True}):
        with pytest.raises(NotImplementedError, match="Model.prefill"):
            ContinuousGenerator(cfg, params, g, num_slots=2, device="cpu",
                                **kw)
    with pytest.raises(NotImplementedError, match="token-frontend"):
        PagedKVCache(cfg, 2, 16, 8, device="cpu")


@pytest.mark.parametrize("arch", [SEAMLESS, CHAMELEON])
def test_launcher_does_not_offer_them(arch, capsys):
    from repro_torch.launch import serve
    assert arch not in serve.SERVED_ARCHS
    with pytest.raises(SystemExit):
        serve.main(["--arch", arch, "--device", "cpu"])
    assert "invalid choice" in capsys.readouterr().err
    assert len(serve.SERVED_ARCHS) == 8


# ------------------------------------------------------ kernels (plain)
@pytest.mark.parametrize("sq,sk", [(8, 32), (16, 40), (40, 16)])
@pytest.mark.parametrize("h,kvh,d", [(4, 2, 16), (4, 4, 64)])
def test_flash_plain_non_causal_matches_jax(sq, sk, h, kvh, d):
    """Cross attention's call: never causal, Sq (decoder) != Sk
    (encoder), Sk ragged against the plain version's 16-key blocks (40)
    and the Pallas kernel's 8; against the Pallas kernel in interpret
    mode and JAX's naive reference."""
    rng = np.random.default_rng(sq + sk + d)
    q = rng.normal(size=(2, sq, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(2, sk, kvh, d)).astype(np.float32)
            for _ in range(2))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = jops.flash_attention(jq, jk, jv, causal=False, impl="naive")
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=False, block_kv=16)
    assert got.shape == (2, sq, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)
    if sq % 8 == 0 and sk % 8 == 0:
        pallas = flash_attention_pallas(jq, jk, jv, causal=False, block_q=8,
                                        block_kv=8, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                                   atol=3e-5)


@pytest.mark.parametrize("s,lens", [(48, (48, 48, 48)), (40, (3, 17, 40))])
def test_decode_plain_at_g1_d64_matches_jax(s, lens):
    """16/16 heads x 64 (seamless's self and cross decode): the cross
    decode's full rows and the self decode's ragged ones, against the
    Pallas kernel (interpret mode) and JAX's einsum tier."""
    rng = np.random.default_rng(s)
    q = rng.normal(size=(3, 16, 64)).astype(np.float32)
    k, v = (rng.normal(size=(3, s, 16, 64)).astype(np.float32)
            for _ in range(2))
    kv_len = np.array(lens, np.int32)
    jargs = tuple(jnp.asarray(a) for a in (q, k, v, kv_len))
    want = decode_attention_pallas(*jargs, block_kv=8, interpret=True)
    einsum = jops.decode_attention(*jargs, impl="einsum")
    got = ops.decode_attention(*(torch.from_numpy(a)
                                 for a in (q, k, v, kv_len)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(einsum), atol=2e-5)


def test_decode_shapes_take_g1_d64():
    """16/16 heads x 64 passes the decode kernels' shape check (the table
    itself is held to ``kBuilt`` by ``tests/test_torch_hybrid.py``)."""
    pa.check_decode_shape(16, 16, 64)
    pa.check_decode_shape(4, 4, 64)
    assert 64 in pa.BUILT_SHAPES[1]
    cfg = get_config(SEAMLESS)
    pa.check_decode_shape(cfg.num_heads, cfg.num_kv_heads,
                          cfg.resolved_head_dim)
    with pytest.raises(ValueError, match="not built"):
        pa.check_decode_shape(16, 16, 128)
