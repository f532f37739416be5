"""Port vs the JAX package on the whole-batch path's kernels and model.

On shared numpy inputs, on the CPU, in fp32 unless a case says bf16:

* the plain flash attention against JAX ``flash_attention_pallas``
  (interpret mode) with a scalar ``q_offset``, at 3e-5 (the bar
  ``tests/test_kernels.py`` holds the Pallas kernel to), and against JAX
  ``kv_scan`` with a per-row ``q_offset`` and a ragged Sq, at 2e-5;
* the plain dense decode attention against JAX ``decode_attention_pallas``
  (interpret mode) and the ``einsum`` tier at 2e-5, and in bf16 against
  ``einsum`` to one bf16 rounding of the output;
* the reduced llama's one-shot ``prefill`` and 4 dense ``decode`` steps
  against the JAX model at 1e-4, with equal greedy tokens.

No case has a row without a valid key: there the JAX tiers average V
over the blocks they visit and the kernel over the tiles it visits, and
no generator path makes such a row.  The kernels are held against these
plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models.model import Model as JaxModel
from repro.models.model import init_cache as jax_init_cache

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models.model import Model, init_cache

MARGIN = 1e-3
BF16_ULP = 2.0 ** -8        # one rounding of a value in [1, 2) to bf16


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _margin(logits: np.ndarray) -> float:
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


# ------------------------------------------------------------ flash attention
def _flash_inputs(b, sq, sk, h=4, kvh=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, d)).astype(np.float32),
            rng.normal(size=(b, sk, kvh, d)).astype(np.float32),
            rng.normal(size=(b, sk, kvh, d)).astype(np.float32))


@pytest.mark.parametrize("q_offset", [0, 8])
@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (True, 5, None), (True, None, 3.0), (True, 5, 3.0),
    (False, None, None)])
def test_flash_plain_matches_pallas(q_offset, causal, window, softcap):
    """Sq 16 over block_q 8, Sk 32 over block_kv 8; kv_len [32, 24] keeps
    every row's window non-empty."""
    q, k, v = _flash_inputs(2, 16, 32)
    kv_len = np.array([32, 24], np.int32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_len=jnp.asarray(kv_len), q_offset=q_offset, block_q=8,
        block_kv=8, interpret=True, **kw)
    got = ops.flash_attention(_t(q), _t(k), _t(v), kv_len=_t(kv_len),
                              q_offset=q_offset, block_kv=8, **kw)
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-5)


def test_flash_plain_matches_pallas_without_kv_len():
    """One-shot prefill's call: Sq = Sk, causal, no kv_len, offset 0."""
    q, k, v = _flash_inputs(2, 16, 16, seed=1)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), block_q=8, block_kv=8,
                                  interpret=True)
    got = ops.flash_attention(_t(q), _t(k), _t(v), block_kv=8)
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-5)


@pytest.mark.parametrize("window,softcap", [(None, None), (6, None),
                                            (None, 4.0), (6, 4.0)])
def test_flash_plain_per_row_offset_matches_kv_scan(window, softcap):
    """Chunked prefill: per-row q_offset, Sq 7 (ragged against every
    tile), Sk 40 scanned in blocks of 16 (a ragged last block)."""
    q, k, v = _flash_inputs(3, 7, 40, seed=2)
    off = np.array([0, 13, 33], np.int32)
    kv_len = off + 7
    kw = dict(causal=True, window=window, softcap=softcap)
    want = jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="kv_scan",
        kv_len=jnp.asarray(kv_len), q_offset=jnp.asarray(off), block_kv=16,
        **kw)
    got = ops.flash_attention(_t(q), _t(k), _t(v), kv_len=_t(kv_len),
                              q_offset=_t(off), block_kv=16, **kw)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
    # impl="ref" is the same plain version, on any device
    ref = ops.flash_attention(_t(q), _t(k), _t(v), kv_len=_t(kv_len),
                              q_offset=_t(off), block_kv=16, impl="ref", **kw)
    np.testing.assert_array_equal(_np(ref), _np(got))


# ----------------------------------------------------------- dense decode
def _decode_inputs(seed=3):
    """B=3, H=4, KV=2, D=16 against S=32, kv_len 5, 17, 32."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(3, 4, 16)).astype(np.float32)
    k = rng.normal(size=(3, 32, 2, 16)).astype(np.float32)
    v = rng.normal(size=(3, 32, 2, 16)).astype(np.float32)
    return q, k, v, np.array([5, 17, 32], np.int32)


@pytest.mark.parametrize("window,softcap", [(None, None), (7, None),
                                            (None, 3.0), (7, 3.0)])
def test_decode_plain_matches_pallas_and_einsum(window, softcap):
    q, k, v, kv_len = _decode_inputs()
    kw = dict(window=window, softcap=softcap)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
             jnp.asarray(kv_len))
    want_pallas = decode_attention_pallas(*jargs, block_kv=16,
                                          interpret=True, **kw)
    want_einsum = jops.decode_attention(*jargs, impl="einsum", **kw)
    got = ops.decode_attention(_t(q), _t(k), _t(v), _t(kv_len), **kw)
    np.testing.assert_allclose(_np(got), _np(want_pallas), atol=2e-5)
    np.testing.assert_allclose(_np(got), _np(want_einsum), atol=2e-5)


@pytest.mark.parametrize("window,softcap", [(None, None), (7, 3.0)])
def test_decode_plain_bf16_matches_einsum(window, softcap):
    """bf16 cache: both keep bf16 operands with fp32 sums and round the
    probabilities to bf16 before PV.  Sum order may flip the output's
    rounding: one bf16 ulp (rtol; 1e-6 near zero)."""
    q, k, v, kv_len = _decode_inputs(seed=4)
    kw = dict(window=window, softcap=softcap)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    tb = [_t(a).to(torch.bfloat16) for a in (q, k, v)]
    want = jops.decode_attention(*jb, jnp.asarray(kv_len), impl="einsum",
                                 **kw)
    got = ops.decode_attention(*tb, _t(kv_len), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_ULP,
                               atol=1e-6)


# ------------------------------------------------------------ the model
@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("llama3-8b").reduced(num_layers=2)
    jm = JaxModel(jcfg, remat=False)
    jparams = jm.init(jax.random.PRNGKey(0), jnp.float32)
    cfg = get_config("llama3-8b").reduced(num_layers=2)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu", dtype=torch.float32)
    return jm, jparams, Model(cfg, device="cpu"), params


def test_prefill_and_dense_decode_match_jax(models):
    """Two prompts of 24 tokens into a dense cache of 28, then 4 decode
    steps at per-row positions that differ (24 and 23: row 1's cache
    holds a shorter prompt's last position)."""
    jm, jparams, tm, params = models
    ctx, steps, cache_len = 24, 4, 28
    rng = np.random.default_rng(0)
    prompts = rng.integers(2, tm.cfg.vocab_size, size=(2, ctx)).astype(
        np.int32)
    jcache = jax_init_cache(jm.cfg, 2, cache_len, jnp.float32)
    tcache = init_cache(tm.cfg, 2, cache_len, torch.float32, "cpu")
    jl, jcache = jm.prefill(jparams, jnp.asarray(prompts), jcache)
    tl = tm.prefill(params, _t(prompts), tcache)
    jlogits, tlogits = [np.asarray(jl)], [tl.numpy()]
    for layer in range(tm.cfg.num_layers):
        np.testing.assert_allclose(
            tcache["blocks"][layer]["k"].numpy(),
            np.asarray(jcache["blocks"][0]["k"][layer]), atol=1e-5)
    jcur = tcur = np.argmax(jlogits[0], -1).astype(np.int32)
    for t in range(steps):
        pos = np.array([ctx + t, ctx - 1 + t], np.int32)
        jl, jcache = jm.decode(jparams, jnp.asarray(jcur[:, None]), jcache,
                               jnp.asarray(pos))
        tl = tm.decode(params, _t(tcur[:, None]), tcache, _t(pos))
        jlogits.append(np.asarray(jl))
        tlogits.append(tl.numpy())
        jcur = np.argmax(jlogits[-1], -1).astype(np.int32)
        tcur = np.argmax(tlogits[-1], -1).astype(np.int32)
    jall, tall = np.stack(jlogits), np.stack(tlogits)
    assert _margin(jall) > MARGIN, "prompts lack a greedy margin"
    np.testing.assert_allclose(tall, jall, atol=1e-4)
    np.testing.assert_array_equal(tall.argmax(-1), jall.argmax(-1))


def test_dense_decode_clamps_a_position_past_the_end(models):
    """``dynamic_update_slice`` clamps a start past the end: the port's
    row update writes the last position instead, as JAX does."""
    jm, jparams, tm, params = models
    jcache = jax_init_cache(jm.cfg, 1, 8, jnp.float32)
    tcache = init_cache(tm.cfg, 1, 8, torch.float32, "cpu")
    tok, pos = np.array([[7]], np.int32), np.array([11], np.int32)
    jl, jcache = jm.decode(jparams, jnp.asarray(tok), jcache,
                           jnp.asarray(pos))
    tl = tm.decode(params, _t(tok), tcache, _t(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(
        tcache["blocks"][0]["v"].numpy(),
        np.asarray(jcache["blocks"][0]["v"][0]), atol=1e-5)
    assert tcache["blocks"][0]["v"][0, -1].abs().sum() > 0
