"""The port's plain flash passes of training against the JAX package's.

``repro_torch.kernels.flash_vjp`` (the blocked forward with its
log-sum-exp and the blocked backward, in plain torch: the plain version
of the card's two flash kernels of training) against
``repro.kernels.flash_vjp`` under ``jax.vjp`` on the same numpy inputs:
causal and bidirectional, a window, a softcap, ``kv_len`` padding, GQA,
a value head dim unlike the query/key's (MLA's 192 and 128 too), the
head dims 64 at G = 8 and 256, fp32.  The forward to 2e-5, the
gradients to 1e-4 of the largest |gradient|.  Also ``ops.flash_attention``
on the CPU, which routes as the JAX op does (``flash_vjp`` at multiples of
256, ``kv_scan`` otherwise), ``attention_fwd_lse``/``attention_bwd`` at
ragged lengths, the backward kernel's shape gate (the forward's head-dim
pairs), and the gradients of ``rmsnorm`` and ``add_rmsnorm`` against
``jax.grad``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.kernels import flash_vjp as jfv
from repro.kernels import ops as jops

from repro_torch.kernels import flash_vjp, ops

FWD_TOL, GRAD_TOL = 2e-5, 1e-4

# (B, Sq, Sk, H, KV, D, DV, causal, window, softcap, kv_len, block)
CASES = [
    (2, 256, 256, 4, 2, 32, 32, True, None, None, None, 64),
    (2, 256, 256, 4, 4, 32, 32, False, None, None, None, 128),
    (1, 512, 512, 4, 2, 16, 16, True, 100, None, None, 128),
    (2, 256, 256, 4, 2, 32, 32, True, None, 20.0, None, 64),
    (2, 128, 256, 2, 2, 32, 32, False, None, None, (256, 150), 64),
    (2, 256, 256, 8, 1, 16, 16, True, 64, 30.0, (256, 200), 64),
    (1, 256, 256, 4, 2, 48, 32, True, None, None, None, 128),
    # the head-dim pairs the card's backward kernel is built at beyond 16:
    # D = 256 (gemma2's window and softcap at G = 2; gemma-7b's G = 1),
    # MLA's q/k 192 with v 128 (causal, kv_len padding), D = 64 at G = 8
    (1, 256, 256, 4, 2, 256, 256, True, 100, 50.0, None, 128),
    (2, 256, 256, 2, 2, 256, 256, True, None, None, None, 128),
    (2, 256, 256, 2, 2, 192, 128, True, None, None, (256, 180), 128),
    (1, 256, 256, 8, 1, 64, 64, True, None, None, None, 64),
]
IDS = ["causal-gqa", "bidirectional", "window", "softcap", "kvlen-cross",
       "g8-window-softcap-kvlen", "dqk-ne-dv", "d256-window-softcap-g2",
       "d256-g1", "mla-192-128-kvlen", "d64-g8"]


def _inputs(case, seed=0):
    b, sq, sk, h, kvh, d, dv = case[:7]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, kvh, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, kvh, dv)).astype(np.float32)
    g = rng.normal(size=(b, sq, h, dv)).astype(np.float32)
    return q, k, v, g


def _kw(case):
    causal, window, softcap, lens = case[7:11]
    return dict(causal=causal, window=window, softcap=softcap), lens


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(1.0, np.abs(want).max()))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jax_vjp(fn, q, k, v, g):
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _torch_grads(fn, q, k, v, g):
    q, k, v = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = fn(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), _t(g))
    return out.detach().numpy(), [x.numpy() for x in grads]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flash_attention_train_matches_jax_vjp(case):
    q, k, v, g = _inputs(case)
    kw, lens = _kw(case)
    blk = case[11]
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    want_o, want_g = _jax_vjp(
        lambda a, b, c: jfv.flash_attention_train(a, b, c, kv_len=jl,
                                                  block=blk, **kw),
        q, k, v, g)
    got_o, got_g = _torch_grads(
        lambda a, b, c: flash_vjp.flash_attention_train(a, b, c, kv_len=tl,
                                                        block=blk, **kw),
        q, k, v, g)
    assert np.abs(got_o - want_o).max() <= FWD_TOL
    for name, a, b in zip(("dq", "dk", "dv"), got_g, want_g):
        assert a.shape == b.shape
        assert _rel(a, b) <= GRAD_TOL, name


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_lse_matches_jax(case):
    """The grouped forward's ``(out, lse)`` against the JAX one's, and
    ``attention_fwd_lse`` in the kernel's layouts (lse (B, H, Sq))."""
    q, k, v, _ = _inputs(case)
    kw, lens = _kw(case)
    b, sq, sk, h, kvh, d = case[:6]
    blk = case[11]
    scale = d ** -0.5
    jq = jnp.asarray(q).reshape(b, sq, kvh, h // kvh, d).transpose(
        0, 2, 3, 1, 4)
    lens_ = np.full((b,), sk, np.int32) if lens is None else np.asarray(
        lens, np.int32)
    out_j, lse_j = jfv._fwd(jq, jnp.asarray(k).transpose(0, 2, 1, 3),
                            jnp.asarray(v).transpose(0, 2, 1, 3),
                            jnp.asarray(lens_), kw["causal"], kw["window"],
                            kw["softcap"], 0, scale, blk)
    out_t, lse_t = flash_vjp.attention_fwd_lse(
        _t(q), _t(k), _t(v), kv_len=_t(lens_), block=blk, **kw)
    np.testing.assert_allclose(lse_t.numpy(),
                               np.asarray(lse_j).reshape(b, h, sq),
                               atol=FWD_TOL, rtol=FWD_TOL)
    want = np.asarray(out_j).transpose(0, 3, 1, 2, 4).reshape(b, sq, h, -1)
    assert np.abs(out_t.numpy() - want).max() <= FWD_TOL


@pytest.mark.parametrize("sq,sk", [(256, 256), (40, 40), (24, 88)])
def test_ops_flash_attention_gradients_route_as_jax(sq, sk):
    """``ops.flash_attention`` on the CPU: ``flash_vjp`` at multiples of
    256, ``kv_scan`` (differentiated by autograd) otherwise; gradients
    against ``jax.vjp`` of the JAX op, which routes the same way."""
    case = (2, sq, sk, 4, 2, 16, 16, sq == sk, None, None, None, 0)
    q, k, v, g = _inputs(case, seed=3)
    causal = case[7]
    want_o, want_g = _jax_vjp(
        lambda a, b, c: jops.flash_attention(a, b, c, causal=causal),
        q, k, v, g)
    got_o, got_g = _torch_grads(
        lambda a, b, c: ops.flash_attention(a, b, c, causal=causal),
        q, k, v, g)
    assert np.abs(got_o - want_o).max() <= FWD_TOL
    for a, b in zip(got_g, want_g):
        assert _rel(a, b) <= GRAD_TOL


@pytest.mark.parametrize("case", [
    (2, 200, 200, 4, 2, 16, 16, True, None, None, None),
    (1, 130, 70, 4, 1, 16, 16, False, None, 30.0, (61,)),
    (2, 96, 96, 4, 2, 32, 32, True, 40, None, (96, 70)),
], ids=["ragged-causal", "ragged-cross-softcap", "window-kvlen"])
def test_plain_kernel_passes_at_ragged_lengths_match_jax(case):
    """``attention_fwd_lse`` and ``attention_bwd`` (the card kernels'
    plain versions, which pad to whole blocks) against ``jax.vjp`` of the
    JAX ``kv_scan`` tier at lengths no block divides."""
    q, k, v, g = _inputs(case, seed=5)
    kw, lens = _kw(case)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    want_o, want_g = _jax_vjp(
        lambda a, b, c: jops.flash_attention(a, b, c, kv_len=jl,
                                             impl="kv_scan", **kw),
        q, k, v, g)
    out, lse = flash_vjp.attention_fwd_lse(_t(q), _t(k), _t(v), kv_len=tl,
                                           block=64, **kw)
    got = flash_vjp.attention_bwd(_t(q), _t(k), _t(v), out, _t(g), lse,
                                  kv_len=tl, block=64, **kw)
    assert np.abs(out.numpy() - want_o).max() <= FWD_TOL
    for a, b in zip(got, want_g):
        assert _rel(a.numpy(), b) <= GRAD_TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pair", [(16, 16), (64, 64), (128, 128), (256, 256),
                                  (192, 128), (96, 96), (24, 16), (128, 64)])
def test_backward_shape_gate_is_the_forward_pairs(pair, dtype):
    """``check_bwd_shape`` (the gate ``ops.flash_attention`` applies under
    autograd on the card) takes exactly the forward's bf16 pairs, in bf16
    and fp32, and raises ``NotImplementedError`` on any other pair:
    reduced deepseek's (24, 16) too, which the forward refuses as well."""
    from repro_torch.kernels import flash_attention as fa
    assert fa.BWD_HEAD_DIMS == fa.BF16_HEAD_DIMS
    if pair in fa.BF16_HEAD_DIMS:
        fa.check_bwd_shape(*pair, dtype)
    else:
        with pytest.raises(NotImplementedError, match=f"q/k {pair[0]}, "
                                                      f"v {pair[1]}"):
            fa.check_bwd_shape(*pair, dtype)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("rows,d", [(6, 64), (3, 100)])
def test_rmsnorm_gradients_match_jax_grad(fused, rows, d):
    """``ops.rmsnorm`` and ``ops.add_rmsnorm`` on the CPU (autograd of the
    plain versions, which the card's backward kernel is held to) against
    ``jax.grad`` of the reference's norm, with a cotangent on both of the
    fused form's outputs; and ``rmsnorm_bwd_plain`` on the same."""
    from repro_torch.kernels import rmsnorm as rn
    rng = np.random.default_rng(rows * d)
    x, r, gy, gs = (rng.normal(size=(rows, d)).astype(np.float32)
                    for _ in range(4))
    w = (1 + 0.1 * rng.normal(size=(d,))).astype(np.float32)

    def jloss(x, r, w):
        s = x + r if fused else x
        y = jops.rmsnorm(s, w, 1e-6)
        return jnp.sum(y * gy) + (jnp.sum(s * gs) if fused else 0.0)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(r),
                                              jnp.asarray(w))
    xt, rt, wt = (_t(a).requires_grad_(True) for a in (x, r, w))
    if fused:
        s, y = ops.add_rmsnorm(xt, rt, wt, 1e-6)
        loss = (y * _t(gy)).sum() + (s * _t(gs)).sum()
    else:
        loss = (ops.rmsnorm(xt, wt, 1e-6) * _t(gy)).sum()
    loss.backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want[0]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want[2]),
                               atol=1e-5, rtol=1e-5)
    if fused:
        np.testing.assert_allclose(rt.grad.numpy(), np.asarray(want[1]),
                                   atol=1e-5, rtol=1e-5)
    s_in = _t(x + r) if fused else _t(x)
    dx, dw = rn.rmsnorm_bwd_plain(s_in, _t(gy), _t(w), 1e-6,
                                  ds=_t(gs) if fused else None)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want[0]), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want[2]), atol=1e-5,
                               rtol=1e-5)
