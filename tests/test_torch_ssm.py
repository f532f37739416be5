"""mamba2-370m (Mamba2's SSD mixers) in the port against the JAX package,
on the CPU.

The pieces of ``models/ssm.py`` on the same numpy inputs (fp32 rounding:
2e-6 to 2e-5 on values of order one, 1e-5 through the scan's sums),
``mamba_forward`` prefill then decode with
its cache, and the reduced mamba2 (2 layers, d_model 64, d_inner 128, 8
heads of 16, state 16, chunks of 8; ``PRNGKey(5)`` weights, whose
greedy choices on these prompts have gaps above 0.04, where
``PRNGKey(1)``'s least is 9.2e-4) in fp32:
one-shot prefill and dense decode logits to 3e-4, greedy tokens of the
whole-batch ``Generator``, the dense ``ContinuousGenerator`` (with a
resize) and ``streamed=True`` equal the JAX whole-batch ``Generator``'s
(after asserting every greedy gap exceeds 1e-3), ``PagedKVCache`` and
chunked prefill refuse it in both packages, and ``launch/serve.py --arch
mamba2-370m`` runs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import ssm as jssm
from repro.models.model import Model as JaxModel
from repro.models.model import init_cache as jax_init_cache
from repro.serving.generator import Generator as JaxGenerator
from repro.serving.generator import GeneratorConfig as JaxGeneratorConfig
from repro.serving.kvpool import PagedKVCache as JaxPagedKVCache

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.prefetch import PrefetchPolicy, StreamedExecutor
from repro_torch.models import ssm
from repro_torch.models.model import Model, init_cache
from repro_torch.serving import ContinuousGenerator, Generator
from repro_torch.serving import GeneratorConfig
from repro_torch.serving.kvpool import PagedKVCache

ARCH = "mamba2-370m"
CTX, MAX_NEW, STEPS = 24, 5, 6
LOGIT_TOL, TOL, MARGIN = 3e-4, 2e-6, 1e-3
SEED = 5


def _prompts(n=6):
    return [f"query {i} topic{i % 3} alpha beta" for i in range(n)]


def _gap(logits) -> float:
    top2 = np.sort(np.asarray(logits, dtype=np.float32), axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


def _t(x):
    return torch.from_numpy(np.array(x))


def _ssd_inputs(seed, b=2, s=16, h=4, p=8, g=2, n=16):
    r = np.random.default_rng(seed)
    return (r.normal(size=(b, s, h, p)).astype(np.float32),
            r.uniform(0.01, 0.3, size=(b, s, h)).astype(np.float32),
            -r.uniform(0.05, 1.0, size=(h,)).astype(np.float32),
            r.normal(size=(b, s, g, n)).astype(np.float32),
            r.normal(size=(b, s, g, n)).astype(np.float32))


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_config(ARCH).reduced()
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(SEED),
                                               jnp.float32)
    cfg = get_config(ARCH).reduced()
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu", dtype=torch.float32)
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def jax_tokens(weights):
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


# ------------------------------------------------------------ config
def test_config_copy_matches_reference():
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    for f in cfg.__dataclass_fields__:
        want, got = getattr(jcfg, f), getattr(cfg, f)
        if f == "ssm":
            assert vars(got) == vars(want)
        else:
            assert got == want, f
    for c, j in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced())):
        assert c.param_count() == j.param_count()
        assert c.weight_bytes() == j.weight_bytes()
        assert c.ssm_state_bytes() == j.ssm_state_bytes()
        assert c.kv_cache_bytes_per_token() == j.kv_cache_bytes_per_token()
    assert cfg.weight_bytes() == 736_550_912
    assert cfg.kv_cache_bytes_per_token() == 0      # constant state only


# ------------------------------------------------------- the SSD pieces
def test_causal_conv_matches_jax():
    r = np.random.default_rng(1)
    x = r.normal(size=(2, 9, 12)).astype(np.float32)
    w = r.normal(size=(12, 4)).astype(np.float32)
    bias = r.normal(size=(12,)).astype(np.float32)
    hist = r.normal(size=(2, 3, 12)).astype(np.float32)
    for init in (None, hist):
        want = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(bias),
                                 None if init is None else jnp.asarray(init))
        got = ssm._causal_conv(_t(x), _t(w), _t(bias),
                               None if init is None else _t(init))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_segsum_matches_jax():
    a = np.random.default_rng(2).uniform(-1, 0, size=(2, 3, 8)).astype(
        np.float32)
    want = np.asarray(jssm._segsum(jnp.asarray(a)))
    got = ssm._segsum(_t(a)).numpy()
    np.testing.assert_array_equal(got <= ssm.NEG_INF / 2, want <= -1e29)
    live = want > -1e29
    np.testing.assert_allclose(got[live], want[live], atol=TOL)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk", [4, 16])
def test_ssd_chunked_matches_jax(with_state, chunk):
    x, dt, a, bm, cm = _ssd_inputs(3)
    init = (np.random.default_rng(4).normal(size=(2, 4, 8, 16)).astype(
        np.float32) if with_state else None)
    y, st = jssm.ssd_chunked(*(jnp.asarray(v) for v in (x, dt, a, bm, cm)),
                             chunk, None if init is None
                             else jnp.asarray(init))
    ty, tst = ssm.ssd_chunked(*(_t(v) for v in (x, dt, a, bm, cm)), chunk,
                              None if init is None else _t(init))
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), atol=1e-5)
    np.testing.assert_allclose(tst.numpy(), np.asarray(st), atol=1e-5)
    with pytest.raises(AssertionError):
        ssm.ssd_chunked(*(_t(v)[:, :10] if v.ndim > 1 else _t(v)
                          for v in (x, dt, a, bm, cm)), 4)


def test_ssd_step_matches_jax_and_the_scan():
    x, dt, a, bm, cm = _ssd_inputs(5)
    st = np.random.default_rng(6).normal(size=(2, 4, 8, 16)).astype(
        np.float32)
    y, nst = jssm.ssd_step(*(jnp.asarray(v[:, 0]) for v in (x, dt)),
                           jnp.asarray(a), jnp.asarray(bm[:, 0]),
                           jnp.asarray(cm[:, 0]), jnp.asarray(st))
    ty, tst = ssm.ssd_step(_t(x[:, 0]), _t(dt[:, 0]), _t(a), _t(bm[:, 0]),
                           _t(cm[:, 0]), _t(st))
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), atol=TOL * 10)
    np.testing.assert_allclose(tst.numpy(), np.asarray(nst), atol=TOL * 10)
    # the step recurrence over the sequence equals the chunked scan
    cy, cst = ssm.ssd_chunked(*(_t(v) for v in (x, dt, a, bm, cm)), 4)
    state = torch.zeros_like(cst)
    for t in range(x.shape[1]):
        yt, state = ssm.ssd_step(_t(x[:, t]), _t(dt[:, t]), _t(a),
                                 _t(bm[:, t]), _t(cm[:, t]), state)
        np.testing.assert_allclose(yt.numpy(), cy[:, t].numpy(), atol=1e-4)
    np.testing.assert_allclose(state.numpy(), cst.numpy(), atol=1e-4)


def test_mamba_forward_prefill_then_decode_matches_jax():
    """Prefill of 16 tokens (two of the reduced chunks of 8) writes the
    conv history and the state; decode steps carry both on."""
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp = jssm.init_mamba(jax.random.PRNGKey(7), jcfg, jnp.float32)
    tp = {k: _t(v) for k, v in jp.items()}
    spec = ssm.make_mamba_cache_spec(cfg, 2, torch.float32)
    jspec = jssm.make_mamba_cache_spec(jcfg, 2, jnp.float32)
    assert {n: (tuple(s.shape), str(s.dtype)) for n, s in jspec.items()} \
        == {n: (sh, str(dt).replace("torch.", "")) for n, (sh, dt)
            in spec.items()}
    tcache = {n: torch.zeros(sh, dtype=dt) for n, (sh, dt) in spec.items()}
    r = np.random.default_rng(8)
    x = r.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    want, jcache = jssm.mamba_forward(jp, jnp.asarray(x), jcfg,
                                      mode="prefill", cache=None)
    got = ssm.mamba_forward(tp, _t(x), cfg, mode="prefill", cache=tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for t in range(4):
        xd = r.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        want, jcache = jssm.mamba_forward(
            jp, jnp.asarray(xd), jcfg, mode="decode", cache=jcache,
            pos=jnp.full((2,), 16 + t, jnp.int32))
        got = ssm.mamba_forward(tp, _t(xd), cfg, mode="decode",
                                cache=tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        for n in ("conv", "state"):
            np.testing.assert_allclose(tcache[n].numpy(),
                                       np.asarray(jcache[n]), atol=1e-5)


# ---------------------------------------------------------------- model
def test_one_shot_prefill_and_dense_decode_logits_match_jax(weights):
    jcfg, jparams, cfg, params = weights
    jm, tm = JaxModel(jcfg, remat=False), Model(cfg, device="cpu")
    rng = np.random.default_rng(9)
    prompts = rng.integers(2, cfg.vocab_size, size=(2, CTX)).astype(np.int32)
    total = CTX + STEPS
    jcache = jax_init_cache(jcfg, 2, total, jnp.float32)
    tcache = init_cache(cfg, 2, total, torch.float32, "cpu")
    assert all(set(c) == {"conv", "state"} for c in tcache["blocks"])
    assert tcache["blocks"][0]["state"].dtype == torch.float32
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
    for i, tc in enumerate(tcache["blocks"]):
        for n in ("conv", "state"):
            np.testing.assert_allclose(
                tc[n].numpy(), np.asarray(jcache["blocks"][0][n][i]),
                atol=1e-4)


def test_params_and_tied_embeddings(weights):
    _, _, cfg, params = weights
    assert cfg.tie_embeddings and "lm_head" not in params
    for lp in params["blocks"]:
        assert set(lp) == {"norm1", "mamba"}            # no FFN, no norm2
        for n in ("A_log", "dt_bias", "D"):
            assert lp["mamba"][n].dtype == torch.float32
    own = Model(cfg, device="cpu").init(seed=0, dtype=torch.bfloat16)
    assert own["blocks"][0]["mamba"]["A_log"].dtype == torch.float32
    assert own["blocks"][0]["mamba"]["in_x"].dtype == torch.bfloat16
    bf = params_from_numpy(jax.tree.map(np.asarray, JaxModel(
        jax_get_config(ARCH).reduced(), remat=False).init(
            jax.random.PRNGKey(SEED), jnp.float32)), cfg, device="cpu",
        dtype=torch.bfloat16)
    assert bf["blocks"][0]["mamba"]["D"].dtype == torch.float32


# ----------------------------------------------------------- generators
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
        cont.resize(5)
        assert cont.cache["blocks"][0]["state"].shape[0] == 5
        assert cont.run(_prompts()[:2]) == want[:2]
    else:
        got = Generator(cfg, params, g, device="cpu", **kw).generate(
            _prompts())
    assert got == want


def test_streamed_executor_counts_every_layer(weights):
    _, _, cfg, params = weights
    ex = StreamedExecutor(cfg, params, PrefetchPolicy(), device="cpu")
    per = [sum(t.numel() * t.element_size() for t in jax.tree.leaves(lp))
           for lp in params["blocks"]]
    assert ex.streamed_bytes == sum(per)
    assert ex.layer_kinds() == [("mamba", "none")] * cfg.num_layers
    cache = ex.init_caches(2, CTX + 1)
    assert set(cache["blocks"][0]) == {"conv", "state"}


def test_paged_and_chunked_prefill_raise_as_in_jax(weights):
    jcfg, _, cfg, params = weights
    with pytest.raises(NotImplementedError):
        JaxPagedKVCache(jcfg, 2, 32, 8)
    with pytest.raises(NotImplementedError):
        PagedKVCache(cfg, 2, 32, 8, device="cpu")
    with pytest.raises(NotImplementedError):
        PagedKVCache(get_config(ARCH), 2, 32, 8, device="cpu")
    with pytest.raises(NotImplementedError):
        ContinuousGenerator(cfg, params, GeneratorConfig(
            ctx_len=CTX, max_new_tokens=MAX_NEW), num_slots=2, paged=True,
            prefill_chunk=8, device="cpu")
    cache = init_cache(cfg, 4, 8, torch.float32, "cpu")
    with pytest.raises(NotImplementedError, match="attn-family"):
        Model(cfg, device="cpu").chunk_prefill(
            params, torch.ones((1, 8), dtype=torch.int32), cache,
            torch.zeros((1,), dtype=torch.int32),
            torch.arange(1, 3, dtype=torch.int32)[None], kv_span=8)


def test_launch_serve_mamba2_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                "--rate", "6000", "--chunks", "120"])
    out = capsys.readouterr().out
    assert f"arch={ARCH} device=cpu" in out
