"""Port kernels vs the JAX package: plain versions against the Pallas
kernels (interpret mode) and ``repro.kernels.ref``, on shared numpy inputs.

Everything runs in fp32 on the CPU.  Bars: 2e-5 (paged decode and
chunked-prefill attention), 1e-4 (top-k scores), 1e-5 (rmsnorm); ids and
sentinels are exact.  The kernels themselves are held against these
plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_decode_attention_pallas
from repro.kernels.rmsnorm import rmsnorm_pallas
from repro.kernels.topk_retrieval import topk_merge_pallas, topk_pallas
from repro.kernels import ops as jops

from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import rmsnorm as trn

NEG_INF = -1e30


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return np.asarray(x, np.float32) if not torch.is_tensor(x) \
        else x.detach().cpu().numpy()


# ---------------------------------------------------------------- rmsnorm
@pytest.mark.parametrize("shape", [(4, 64), (2, 7, 96)])
def test_rmsnorm_matches_jax(shape):
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=shape[-1:]).astype(np.float32)
    want_pallas = rmsnorm_pallas(jnp.asarray(x), jnp.asarray(w), 1e-5,
                                 interpret=True)
    want_ref = jref.rmsnorm_reference(jnp.asarray(x), jnp.asarray(w), 1e-5)
    got = ops.rmsnorm(_t(x), _t(w), 1e-5)
    np.testing.assert_allclose(_np(got), _np(want_pallas), atol=1e-5)
    np.testing.assert_allclose(_np(got), _np(want_ref), atol=1e-5)


@pytest.mark.parametrize("shape", [(4, 64), (2, 7, 96)])
def test_add_rmsnorm_matches_jax(shape):
    """The fused form's plain version against ``x + r`` then the Pallas
    kernel (interpret mode) and the JAX oracle: s exactly, y to 1e-5."""
    rng = np.random.default_rng(3)
    x, r = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    w = rng.normal(size=shape[-1:]).astype(np.float32)
    s_jax = jnp.asarray(x) + jnp.asarray(r)
    want_pallas = rmsnorm_pallas(s_jax, jnp.asarray(w), 1e-5, interpret=True)
    want_ref = jref.rmsnorm_reference(s_jax, jnp.asarray(w), 1e-5)
    s, y = ops.add_rmsnorm(_t(x), _t(r), _t(w), 1e-5)
    np.testing.assert_array_equal(_np(s), np.asarray(s_jax))
    np.testing.assert_allclose(_np(y), _np(want_pallas), atol=1e-5)
    np.testing.assert_allclose(_np(y), _np(want_ref), atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_rmsnorm_plain_is_add_then_norm(dtype):
    """On the CPU the fused op is exactly the eager add and the plain norm."""
    g = torch.Generator().manual_seed(5)
    x, r = (torch.randn((3, 5, 64), generator=g).to(dtype) for _ in range(2))
    w = torch.randn((64,), generator=g).to(dtype)
    s, y = ops.add_rmsnorm(x, r, w, 1e-6)
    assert s.dtype == y.dtype == dtype
    assert torch.equal(s, x + r)
    assert torch.equal(y, ops.rmsnorm(x + r, w, 1e-6))


# ------------------------------------------------------ paged decode attn
def _paged_inputs(quant: bool):
    """B=3, H=4, KV=2, D=16, page 8, nmax 5, ragged kv_len."""
    rng = np.random.default_rng(2)
    b, h, kvh, d, page, nmax, pages = 3, 4, 2, 16, 8, 5, 16
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    if quant:
        k = rng.integers(-127, 128, size=(pages, page, kvh, d)).astype(np.int8)
        v = rng.integers(-127, 128, size=(pages, page, kvh, d)).astype(np.int8)
        ks = rng.uniform(0.005, 0.02, size=(pages, kvh)).astype(np.float32)
        vs = rng.uniform(0.005, 0.02, size=(pages, kvh)).astype(np.float32)
    else:
        k = rng.normal(size=(pages, page, kvh, d)).astype(np.float32)
        v = rng.normal(size=(pages, page, kvh, d)).astype(np.float32)
        ks = vs = None
    perm = rng.permutation(np.arange(1, pages))
    tab = np.zeros((b, nmax), np.int32)
    kv_len = np.array([5, 17, 40], np.int32)
    used = 0
    for i, n in enumerate(kv_len):
        blocks = -(-int(n) // page)
        tab[i, :blocks] = perm[used:used + blocks]      # tail stays trash
        used += blocks
    return q, k, v, tab, kv_len, ks, vs


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window,softcap", [(None, None), (11, None),
                                            (None, 5.0), (11, 5.0)])
def test_paged_decode_matches_jax(quant, window, softcap):
    q, k, v, tab, kv_len, ks, vs = _paged_inputs(quant)
    jkw = dict(window=window, softcap=softcap,
               k_scale=None if ks is None else jnp.asarray(ks),
               v_scale=None if vs is None else jnp.asarray(vs))
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
             jnp.asarray(tab), jnp.asarray(kv_len))
    want_pallas = paged_decode_attention_pallas(*jargs, interpret=True, **jkw)
    want_ref = jref.paged_decode_attention_reference(*jargs, **jkw)
    got = ops.paged_decode_attention(
        _t(q), _t(k), _t(v), _t(tab), _t(kv_len), window=window,
        softcap=softcap, k_scale=None if ks is None else _t(ks),
        v_scale=None if vs is None else _t(vs))
    np.testing.assert_allclose(_np(got), _np(want_pallas), atol=2e-5)
    np.testing.assert_allclose(_np(got), _np(want_ref), atol=2e-5)


# -------------------------------------------------- chunked-prefill attn
@pytest.mark.parametrize("window,softcap", [(None, None), (7, 3.0)])
def test_chunk_attention_matches_jax_kv_scan(window, softcap):
    """Per-row q_offset (chunked prefill): JAX's kv_scan vs the port."""
    rng = np.random.default_rng(3)
    b, sq, sk, h, kvh, d = 2, 5, 24, 4, 2, 16
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, kvh, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, kvh, d)).astype(np.float32)
    off = np.array([3, 16], np.int32)
    kv_len = off + sq
    kw = dict(causal=True, window=window, softcap=softcap)
    want = jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="kv_scan",
        kv_len=jnp.asarray(kv_len), q_offset=jnp.asarray(off), block_kv=8,
        **kw)
    want_ref = jref.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_len=jnp.asarray(kv_len), q_offset=jnp.asarray(off), **kw)
    got = ops.flash_attention(_t(q), _t(k), _t(v), kv_len=_t(kv_len),
                              q_offset=_t(off), block_kv=8, **kw)
    got_ref = ref.attention_reference(_t(q), _t(k), _t(v), kv_len=_t(kv_len),
                                      q_offset=_t(off), **kw)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
    np.testing.assert_allclose(_np(got_ref), _np(want_ref), atol=2e-5)


# ------------------------------------------------------------------ top-k
def test_topk_matches_jax_with_pad_tiles_and_ties():
    """N=300 over block_n=64 (a padded last tile), k=7, and a tie row."""
    rng = np.random.default_rng(4)
    n, d, qn, k = 300, 24, 5, 7
    db = rng.normal(size=(n, d)).astype(np.float32)
    qs = rng.normal(size=(qn, d)).astype(np.float32)
    # query 0's best row duplicated further down: an exact score tie,
    # which must resolve to the lower row first
    best = int(np.argmax(db @ qs[0]))
    db[297] = db[best]
    want_s, want_i = topk_pallas(jnp.asarray(qs), jnp.asarray(db), k,
                                 block_n=64, interpret=True)
    ref_s, ref_i = jref.topk_reference(jnp.asarray(qs), jnp.asarray(db), k)
    got_s, got_i = ops.retrieval_topk(_t(qs), _t(db), k)
    for s, i in ((want_s, want_i), (ref_s, ref_i)):
        np.testing.assert_allclose(_np(got_s), _np(s), atol=1e-4)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(i))
    assert list(got_i[0, :2].numpy()) == sorted([best, 297])


def test_topk_k_above_n_leaves_sentinel_tail():
    rng = np.random.default_rng(5)
    db = rng.normal(size=(5, 8)).astype(np.float32)
    qs = rng.normal(size=(3, 8)).astype(np.float32)
    want_s, want_i = topk_pallas(jnp.asarray(qs), jnp.asarray(db), 7,
                                 interpret=True)
    got_s, got_i = ops.retrieval_topk(_t(qs), _t(db), 7)
    np.testing.assert_allclose(_np(got_s), _np(want_s), atol=1e-4)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert (got_i[:, 5:] == -1).all() and (got_s[:, 5:] == NEG_INF).all()


def test_topk_merge_matches_jax_with_fully_masked_rows():
    rng = np.random.default_rng(6)
    qn, p, k = 5, 6, 5
    s = rng.normal(size=(qn, p, k)).astype(np.float32)
    s = -np.sort(-s, axis=-1)                       # boards are sorted
    ids = rng.integers(0, 1000, size=(qn, p, k)).astype(np.int32)
    mask = rng.random((qn, p)) < 0.5
    mask[1] = False                                 # no partition probed
    mask[3] = False
    mask[3, 2] = True                               # one board of 5 ...
    s[3, 2, 3:] = NEG_INF                           # ... 3 of them real
    ids[3, 2, 3:] = -1
    js = (jnp.asarray(s), jnp.asarray(ids), jnp.asarray(mask))
    want_s, want_i = topk_merge_pallas(*js, k, interpret=True)
    ref_s, ref_i = jref.topk_merge_reference(*js, k)
    got_s, got_i = ops.retrieval_topk_merge(_t(s), _t(ids), _t(mask), k)
    for ws, wi in ((want_s, want_i), (ref_s, ref_i)):
        np.testing.assert_allclose(_np(got_s), _np(ws), atol=1e-4)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(wi))
    assert (got_i[1] == -1).all() and (got_s[1] == NEG_INF).all()
    assert (got_i[3, 3:] == -1).all()


# ---------------------------------------------------------- no fallback
def test_kernel_route_raises_instead_of_falling_back(monkeypatch, tmp_path):
    """A tensor on a device without a kernel raises; a kernel wrapper
    raises on CPU tensors; the CUDA route raises without nvcc."""
    x = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError):
        ops.rmsnorm(x, torch.empty((8,), device="meta"))
    if torch.cuda.is_available():
        return
    with pytest.raises((ValueError, ImportError)):
        trn.rmsnorm_cuda(torch.ones(2, 8), torch.ones(8))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library("paged_attention")


def test_launch_counts_start_at_zero_and_reset():
    ops.reset_launch_counts()
    assert set(ops.launch_counts()) == {
        "rmsnorm", "flash_attention", "decode_attention",
        "paged_decode_attention", "retrieval_topk", "retrieval_topk_merge"}
    assert all(v == 0 for v in ops.launch_counts().values())


# ------------------------------------------------- split-K decode planning
@pytest.mark.parametrize("batch,kv_heads,span,granule,sms", [
    (8, 8, 1056, 16, 132),      # llama3-8b decode step: 9 splits of 8 pages
    (1, 8, 1056, 16, 132),      # one slot: capped by the shortest split
    (3, 2, 40, 8, 132),         # a table shorter than one split
    (8, 8, 115, 16, 132),       # a window of 100 over pages of 16
    (4, 2, 300, 16, 132),       # a dense cache of 300, granules of 16
    (264, 2, 64, 16, 132),      # the batch fills the grid alone
    (4096, 8, 1056, 16, 132),   # far past the target grid
    (2, 2, 1, 16, 8),           # one token
])
def test_decode_splits_from_shapes(batch, kv_heads, span, granule, sms):
    """At least one split; whole granules covering the span with no empty
    tail split; no split shorter than the floor unless the span is; as
    many blocks as the target where the span allows it; one split once
    the batch alone reaches the target."""
    from repro_torch.kernels.paged_attention import (BLOCKS_PER_SM,
                                                     MIN_SPLIT_TOKENS,
                                                     decode_splits)
    splits, split_len = decode_splits(batch, kv_heads, span, granule, sms)
    units = -(-span // granule)
    assert splits >= 1 and split_len % granule == 0
    assert splits * split_len >= span > (splits - 1) * split_len
    assert split_len >= min(MIN_SPLIT_TOKENS, units * granule)
    target = BLOCKS_PER_SM * sms
    if batch * kv_heads >= target:
        assert splits == 1
    elif split_len > -(-MIN_SPLIT_TOKENS // granule) * granule:
        # longer than the floor only to keep the grid near the target
        assert batch * kv_heads * splits >= target * 0.5
