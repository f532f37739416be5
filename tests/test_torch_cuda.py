"""Port kernels on the card, against their plain versions.

Marked ``cuda``: they skip without an NVIDIA GPU.  This file imports no
JAX, so it also runs where only the port is installed:
``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return x.detach().cpu().numpy()


def _paged_inputs(quant: bool, h: int, d: int):
    """B=3, KV=2, page 8, nmax 5, ragged kv_len; H and D as given."""
    rng = np.random.default_rng(2)
    b, kvh, page, nmax, pages = 3, 2, 8, 5, 16
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("h,d", [(4, 16), (8, 16), (4, 128), (8, 128)])
def test_paged_decode_kernel_on_card(cuda_device, quant, h, d):
    """Every (query heads per kv head, head_dim) variant the kernel builds."""
    q, k, v, tab, kv_len, ks, vs = _paged_inputs(quant, h, d)
    args = [_t(a).to(cuda_device) for a in (q, k, v, tab, kv_len)]
    kw = {} if ks is None else dict(k_scale=_t(ks).to(cuda_device),
                                    v_scale=_t(vs).to(cuda_device))
    got = ops.paged_decode_attention(*args, window=11, softcap=5.0, **kw)
    want = ops.paged_decode_attention(*args, window=11, softcap=5.0,
                                      impl="ref", **kw)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)


@pytest.mark.cuda
def test_topk_kernels_on_card(cuda_device):
    rng = np.random.default_rng(7)
    db = _t(rng.normal(size=(1000, 64)).astype(np.float32)).to(cuda_device)
    qs = _t(rng.normal(size=(9, 64)).astype(np.float32)).to(cuda_device)
    got_s, got_i = ops.retrieval_topk(qs, db, 5)
    want_s, want_i = ops.retrieval_topk(qs, db, 5, impl="ref")
    np.testing.assert_allclose(_np(got_s), _np(want_s), atol=1e-4)
    np.testing.assert_array_equal(_np(got_i), _np(want_i))
    x = _t(rng.normal(size=(3, 4096)).astype(np.float32)).to(cuda_device)
    w = _t(rng.normal(size=(4096,)).astype(np.float32)).to(cuda_device)
    np.testing.assert_allclose(_np(ops.rmsnorm(x, w)),
                               _np(ops.rmsnorm(x, w, impl="ref")), atol=1e-5)


# ------------------------------------------------ flash and dense decode
BF16_ULP = 2.0 ** -8


def _bf16_bound(want, wmean_abs_v):
    """The bf16 kernels round P to bf16 (2**-9 relative, so at most 2**-9
    of the softmax-weighted mean of |v| per element) where the plain
    versions keep it fp32 (flash) or round the normalized P (decode);
    both round the output to bf16."""
    return BF16_ULP * np.abs(want) + BF16_ULP * wmean_abs_v + 1e-6


def _flash_case(dev, dtype, d, *, per_row, window, softcap, seed=11):
    """B=3, H=8, KV=2, Sq=70 (ragged against 64- and 32-row tiles) over
    Sk=150 (ragged against 128- and 32-key tiles)."""
    rng = np.random.default_rng(seed)
    b, sq, sk, h, kvh = 3, 70, 150, 8, 2
    q = _t(rng.normal(size=(b, sq, h, d)).astype(np.float32))
    k = _t(rng.normal(size=(b, sk, kvh, d)).astype(np.float32))
    v = _t(rng.normal(size=(b, sk, kvh, d)).astype(np.float32))
    if per_row:
        off = np.array([0, 37, 80], np.int32)       # chunk starts
        kw = dict(q_offset=_t(off).to(dev), kv_len=_t(off + sq).to(dev))
    else:
        kw = dict(q_offset=0, kv_len=_t(np.array([150, 90, 70], np.int32))
                  .to(dev))
    kw.update(causal=True, window=window, softcap=softcap)
    return [x.to(dev, dtype) for x in (q, k, v)], kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.float32, 16),
                                     (torch.float32, 128),
                                     (torch.bfloat16, 16),
                                     (torch.bfloat16, 64),
                                     (torch.bfloat16, 128)])
@pytest.mark.parametrize("per_row,window,softcap", [
    (False, None, None), (True, None, None), (True, 40, 30.0),
    (False, 33, None)])
def test_flash_attention_kernel_on_card(cuda_device, dtype, d, per_row,
                                        window, softcap):
    """Every compiled (dtype, head_dim) variant: scalar and per-row
    q_offset, window and softcap, ragged Sq and Sk.  fp32 at 2e-5."""
    (q, k, v), kw = _flash_case(cuda_device, dtype, d, per_row=per_row,
                                window=window, softcap=softcap)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, **kw)
    want = ops.flash_attention(q, k, v, impl="ref", **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
        return
    wmean = ops.flash_attention(q.float(), k.float(), v.float().abs(),
                                impl="ref", **kw)
    err = np.abs(_np(got.float()) - _np(want.float()))
    assert (err <= _bf16_bound(_np(want.float()), _np(wmean))).all(), \
        float(err.max())


def _decode_case(dev, dtype, h, d, seed=12):
    """B=4 against S=300, kv_len 1, 77, 256, 300 (the last a dead slot's
    whole row)."""
    rng = np.random.default_rng(seed)
    b, s, kvh = 4, 300, 2
    q = _t(rng.normal(size=(b, h, d)).astype(np.float32)).to(dev, dtype)
    k = _t(rng.normal(size=(b, s, kvh, d)).astype(np.float32)).to(dev, dtype)
    v = _t(rng.normal(size=(b, s, kvh, d)).astype(np.float32)).to(dev, dtype)
    return q, k, v, _t(np.array([1, 77, 256, 300], np.int32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,d", [(4, 16), (8, 16), (4, 128), (8, 128)])
@pytest.mark.parametrize("window,softcap", [(None, None), (50, 5.0)])
def test_dense_decode_kernel_on_card(cuda_device, dtype, h, d, window,
                                     softcap):
    """Every compiled (query heads per kv head, head_dim) variant, fp32
    (2e-5) and bf16 caches."""
    q, k, v, kv_len = _decode_case(cuda_device, dtype, h, d)
    kw = dict(window=window, softcap=softcap)
    before = ops.launch_counts()["decode_attention"]
    got = ops.decode_attention(q, k, v, kv_len, **kw)
    want = ops.decode_attention(q, k, v, kv_len, impl="ref", **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention"] == before + 1
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
        return
    wmean = ops.decode_attention(q.float(), k.float(), v.float().abs(),
                                 kv_len, impl="ref", **kw)
    err = np.abs(_np(got.float()) - _np(want.float()))
    assert (err <= _bf16_bound(_np(want.float()), _np(wmean))).all(), \
        float(err.max())


# ------------------------------------------------ split-K decode, wgmma flash
BF16_RTOL, BF16_ATOL = 1.6e-2, 1e-5      # one bf16 rounding of the output


def _split_len(dev, b, kvh, span, granule):
    from repro_torch.kernels.paged_attention import decode_splits
    props = torch.cuda.get_device_properties(dev)
    return decode_splits(b, kvh, span, granule, props.multi_processor_count)


def _wide_paged_case(dev, kv_dtype, lengths, *, page=16, nmax=70, h=8,
                     kvh=2, d=128, seed=21):
    """A table of nmax pages a slot (several splits), one slot a length;
    a length of -1 is a dead slot: every entry on trash page 0, kv_len the
    whole table."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    pages = b * nmax + 1
    shape = (pages, page, kvh, d)
    if kv_dtype == torch.int8:
        k = _t(rng.integers(-127, 128, size=shape).astype(np.int8))
        v = _t(rng.integers(-127, 128, size=shape).astype(np.int8))
        kw = dict(k_scale=_t(rng.uniform(0.005, 0.02, (pages, kvh))
                             .astype(np.float32)).to(dev),
                  v_scale=_t(rng.uniform(0.005, 0.02, (pages, kvh))
                             .astype(np.float32)).to(dev))
    else:
        k = _t(rng.normal(size=shape).astype(np.float32)).to(kv_dtype)
        v = _t(rng.normal(size=shape).astype(np.float32)).to(kv_dtype)
        kw = {}
    q_dtype = torch.bfloat16 if kv_dtype == torch.bfloat16 else torch.float32
    q = _t(rng.normal(size=(b, h, d)).astype(np.float32)).to(dev, q_dtype)
    tab = rng.permutation(np.arange(1, pages))[:b * nmax].reshape(b, nmax)
    lens = np.array(lengths, np.int32)
    for i, n in enumerate(lengths):
        if n < 0:
            tab[i] = 0
            lens[i] = nmax * page
    return ([q, k.to(dev), v.to(dev), _t(tab.astype(np.int32)).to(dev),
             _t(lens).to(dev)], kw)


def _check_decode(got, want):
    if got.dtype == torch.float32:
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
    else:
        np.testing.assert_allclose(_np(got.float()), _np(want.float()),
                                   rtol=BF16_RTOL, atol=BF16_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float32,
                                      torch.int8])
@pytest.mark.parametrize("window,softcap", [(None, None), (100, 30.0)])
def test_paged_decode_splits_on_card(cuda_device, kv_dtype, window, softcap):
    """Page 16 over 70 pages: lengths 1, 16, 17, one split's length and one
    past it, 1056, and a dead slot on trash page 0; the window empties
    whole splits.  Two calls give the same bits."""
    splits, split_len = _split_len(cuda_device, 7, 2, 70 * 16, 16)
    assert splits > 1
    lengths = [1, 16, 17, split_len, split_len + 1, 1056, -1]
    args, kw = _wide_paged_case(cuda_device, kv_dtype, lengths)
    kw.update(window=window, softcap=softcap)
    before = ops.launch_counts()["paged_decode_attention"]
    got = ops.paged_decode_attention(*args, **kw)
    again = ops.paged_decode_attention(*args, **kw)
    want = ops.paged_decode_attention(*args, impl="ref", **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_decode_attention"] == before + 2
    assert torch.equal(got, again)
    _check_decode(got, want)


@pytest.mark.cuda
def test_paged_decode_one_split_on_card(cuda_device):
    """A batch that fills the grid alone: one split, no merge pass."""
    props = torch.cuda.get_device_properties(cuda_device)
    from repro_torch.kernels.paged_attention import BLOCKS_PER_SM
    b = -(-BLOCKS_PER_SM * props.multi_processor_count // 2)
    assert _split_len(cuda_device, b, 2, 4 * 16, 16)[0] == 1
    rng = np.random.default_rng(5)
    lengths = [int(n) for n in rng.integers(1, 4 * 16 + 1, size=b)]
    args, kw = _wide_paged_case(cuda_device, torch.bfloat16, lengths,
                                nmax=4)
    got = ops.paged_decode_attention(*args)
    want = ops.paged_decode_attention(*args, impl="ref")
    _check_decode(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,softcap", [(None, None), (300, 5.0)])
def test_dense_decode_splits_on_card(cuda_device, dtype, window, softcap):
    """S = 1056 in splits, kv_len 1, 17, 300, 1056 (the last a dead
    slot's whole row).  Two calls give the same bits."""
    rng = np.random.default_rng(13)
    b, s, h, kvh, d = 4, 1056, 8, 2, 128
    assert _split_len(cuda_device, b, kvh, s, 16)[0] > 1
    q = _t(rng.normal(size=(b, h, d)).astype(np.float32)).to(cuda_device,
                                                              dtype)
    k = _t(rng.normal(size=(b, s, kvh, d)).astype(np.float32)).to(
        cuda_device, dtype)
    v = _t(rng.normal(size=(b, s, kvh, d)).astype(np.float32)).to(
        cuda_device, dtype)
    kv_len = _t(np.array([1, 17, 300, 1056], np.int32)).to(cuda_device)
    kw = dict(window=window, softcap=softcap)
    got = ops.decode_attention(q, k, v, kv_len, **kw)
    again = ops.decode_attention(q, k, v, kv_len, **kw)
    want = ops.decode_attention(q, k, v, kv_len, impl="ref", **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
        return
    wmean = ops.decode_attention(q.float(), k.float(), v.float().abs(),
                                 kv_len, impl="ref", **kw)
    err = np.abs(_np(got.float()) - _np(want.float()))
    assert (err <= _bf16_bound(_np(want.float()), _np(wmean))).all(), \
        float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("per_row,window,softcap", [
    (False, None, None), (True, None, None), (True, 70, 30.0),
    (False, 150, None)])
def test_flash_attention_large_tiles_on_card(cuda_device, d, per_row,
                                             window, softcap):
    """bf16 with a grid large enough for 128-row q tiles (two consumer
    warpgroups): Sq = 300 and Sk = 333 cross the 64- and 128-row tiles and
    the 128-key tiles; windows of 70 and 150 skip whole kv tiles.  Every
    row keeps a live key in its reach (a row with none is outside the
    kernel's contract: see csrc/flash_attention.cu)."""
    rng = np.random.default_rng(17)
    b, sq, sk, h, kvh = 4, 300, 333, 32, 8
    from repro_torch.kernels.flash_attention import launch_shape
    assert launch_shape(b, sq, h, d)["consumers"] == 2
    q, k, v = (_t(rng.normal(size=shape).astype(np.float32))
               .to(cuda_device, torch.bfloat16)
               for shape in ((b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d)))
    if per_row:
        off = np.array([0, 10, 33, 0], np.int32)
        kw = dict(q_offset=_t(off).to(cuda_device),
                  kv_len=_t(off + sq).to(cuda_device))
    else:
        kw = dict(q_offset=0, kv_len=_t(np.array([333, 300, 229, 164],
                                                 np.int32)).to(cuda_device))
    kw.update(causal=True, window=window, softcap=softcap)
    got = ops.flash_attention(q, k, v, **kw)
    want = ops.flash_attention(q, k, v, impl="ref", **kw)
    wmean = ops.flash_attention(q.float(), k.float(), v.float().abs(),
                                impl="ref", **kw)
    err = np.abs(_np(got.float()) - _np(want.float()))
    assert (err <= _bf16_bound(_np(want.float()), _np(wmean))).all(), \
        float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sq,offsets", [
    (1, (1023, 1008, 1000, 0)), (15, (1009, 1008, 1000, 0))])
def test_flash_attention_prefix_suffix_on_card(cuda_device, dtype, sq,
                                               offsets):
    """A prefix hit's suffix prefill: 1 or 15 query rows deep in a
    1024-key span, per-row offsets (the last row at 0), each row's kv_len
    its offset + Sq; llama3-8b's 32/8 heads x 128.  fp32 is the int8
    chunked prefill's path (fp32 dequantized K/V)."""
    rng = np.random.default_rng(23)
    b, sk, h, kvh, d = len(offsets), 1024, 32, 8, 128
    q, k, v = (_t(rng.normal(size=shape).astype(np.float32))
               .to(cuda_device, dtype)
               for shape in ((b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d)))
    off = np.array(offsets, np.int32)
    kw = dict(causal=True, q_offset=_t(off).to(cuda_device),
              kv_len=_t(off + sq).to(cuda_device))
    got = ops.flash_attention(q, k, v, **kw)
    want = ops.flash_attention(q, k, v, impl="ref", **kw)
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
        return
    wmean = ops.flash_attention(q.float(), k.float(), v.float().abs(),
                                impl="ref", **kw)
    err = np.abs(_np(got.float()) - _np(want.float()))
    assert (err <= _bf16_bound(_np(want.float()), _np(wmean))).all(), \
        float(err.max())


# ------------------------------------------------------ streaming top-k
TOPK_SCORE_TOL = 1e-4       # fp32 dot products of unit vectors
TIE_GAP = 1e-5              # ids must match where neighbours differ by more


def _unit_rows(seed, n, d):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _check_topk(got, want, n, k):
    """Scores to 1e-4; ids equal wherever the plain version's neighbours
    are more than 1e-5 apart; among the kernel's equal scores lower rows
    first; a (-1e30, -1) tail past n."""
    (gs, gi), (ws, wi) = [(_np(s), _np(i)) for s, i in (got, want)]
    assert gs.shape == gi.shape == ws.shape
    np.testing.assert_allclose(gs, ws, atol=TOPK_SCORE_TOL)
    w64 = ws.astype(np.float64)
    close = np.abs(np.diff(w64, axis=1)) <= TIE_GAP
    sep = np.ones(w64.shape, bool)
    sep[:, 1:] &= ~close
    sep[:, :-1] &= ~close
    assert ((gi == wi) | ~sep).all()
    tie = (gi[:, 1:] >= 0) & (gi[:, :-1] >= 0) & (gs[:, 1:] == gs[:, :-1])
    assert (~tie | (gi[:, 1:] > gi[:, :-1])).all()
    if n < k:
        assert (gi[:, n:] == -1).all() and (gs[:, n:] == -1e30).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 768])
@pytest.mark.parametrize("k", [1, 5, 64])
@pytest.mark.parametrize("n", [3, 127, 1037, 15580])
@pytest.mark.parametrize("q", [1, 8, 9, 33])
def test_topk_stream_on_card(cuda_device, q, n, k, d):
    """Q against the 8-query tile, N against the 32-row tiles and the
    grid (15580 rows: 128 blocks of 3-4 tiles), k against the two list
    registers, D = 768 at one bulk copy per tile."""
    db = _t(_unit_rows(n * 7 + d, n, d)).to(cuda_device)
    qs = _t(_unit_rows(q + 1, q, d)).to(cuda_device)
    before = ops.launch_counts()["retrieval_topk"]
    got = ops.retrieval_topk(qs, db, k)
    want = ops.retrieval_topk(qs, db, k, impl="ref")
    torch.cuda.synchronize()
    assert ops.launch_counts()["retrieval_topk"] == before + 1
    _check_topk(got, want, n, k)
    again = ops.retrieval_topk(qs, db, k)       # the tickets were left at 0
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [66, 1000, 1001])
def test_topk_other_widths_on_card(cuda_device, d):
    """Widths off the float4 grid (the wrapper pads them) and past the
    main path's 768; fp32 scores and ids as the plain version."""
    db = _t(_unit_rows(5, 3000, d)).to(cuda_device)
    qs = _t(_unit_rows(6, 9, d)).to(cuda_device)
    _check_topk(ops.retrieval_topk(qs, db, 5),
                ops.retrieval_topk(qs, db, 5, impl="ref"), 3000, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 64])
def test_topk_exact_ties_on_card(cuda_device, k):
    """Seven copies of one row in different tiles and blocks of a 15580-row
    partition, and queries 0 and 8 (two query tiles) equal to it: equal
    bits for every copy, the lowest rows first."""
    n, d = 15580, 768
    db = _unit_rows(3, n, d)
    copies = np.array([3, 40, 41, 1000, 7777, 12000, 15579])
    db[copies] = db[copies[0]]
    qs = _unit_rows(4, 9, d)
    qs[0] = qs[8] = db[copies[0]]
    db, qs = _t(db).to(cuda_device), _t(qs).to(cuda_device)
    got = ops.retrieval_topk(qs, db, k)
    _check_topk(got, ops.retrieval_topk(qs, db, k, impl="ref"), n, k)
    s, i = _np(got[0]), _np(got[1])
    top = min(k, len(copies))
    for row in (0, 8):
        np.testing.assert_array_equal(i[row, :top], copies[:top])
        assert (s[row, :top] == s[row, 0]).all()


# ------------------------------------------------------------ RMSNorm
def _norm_inputs(dev, dtype, rows, d, seed=21):
    rng = np.random.default_rng(seed)
    x, r = (_t(rng.normal(size=(rows, d)).astype(np.float32)).to(dev, dtype)
            for _ in range(2))
    w = _t((1 + 0.1 * rng.normal(size=(d,))).astype(np.float32))
    return x, r, w.to(dev, dtype)


def _assert_norm_close(got, want, dtype):
    """fp32 to 1e-5; bf16 to about one bf16 ulp twice (rsqrt and the sum
    order move the fp32 value before it rounds)."""
    got, want = got.double(), want.double()
    tol = (1e-5 if dtype == torch.float32
           else 1e-5 + 1.6e-2 * want.abs())
    assert bool(((got - want).abs() <= tol).all()), \
        float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_rmsnorm_on_card(cuda_device, dtype, rows):
    """One launch; s bit-equal to the eager x + r on the card; y within
    the rmsnorm tolerance of the plain norm of s."""
    x, r, w = _norm_inputs(cuda_device, dtype, rows, 4096)
    before = ops.launch_counts()["rmsnorm"]
    s, y = ops.add_rmsnorm(x, r, w, 1e-5)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rmsnorm"] == before + 1
    assert s.dtype == y.dtype == dtype and s.shape == y.shape == x.shape
    assert torch.equal(s, x + r)
    _assert_norm_close(y, ops.rmsnorm(s, w, 1e-5, impl="ref"), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype,wdtype,d", [
    (torch.bfloat16, torch.bfloat16, 64),     # the reduced model's width
    (torch.float32, torch.float32, 64),
    (torch.bfloat16, torch.float32, 4096),    # fp32 weight, bf16 rows
    (torch.float16, torch.float16, 4096),
    (torch.float32, torch.float32, 100),      # not a whole vector: scalar
    (torch.bfloat16, torch.bfloat16, 100)])
def test_rmsnorm_forms_on_card(cuda_device, fused, dtype, wdtype, d):
    """Both forms at every compiled (dtype, weight dtype, vector) variant,
    on a (2, 3, d) input."""
    x, r, w = _norm_inputs(cuda_device, dtype, 6, d, seed=d)
    x, r, w = x.reshape(2, 3, d), r.reshape(2, 3, d), w.to(wdtype)
    if fused:
        s, y = ops.add_rmsnorm(x, r, w, 1e-6)
        assert torch.equal(s, x + r)
    else:
        s, y = x, ops.rmsnorm(x, w, 1e-6)
    assert y.shape == x.shape
    _assert_norm_close(y.float(), ops.rmsnorm(s, w, 1e-6, impl="ref").float(),
                       torch.float32 if dtype == torch.float32 else dtype)


# ------------------------------------------------------- top-k merge
def _merge_inputs(q, p, k, seed):
    """(Q, P, k) sorted boards under a probe mask: row 0 all masked, row 1
    (when there is one) with one probed board short of k, and every third
    board a copy of board 0's scores, so equal scores sit in different
    partitions (lower flat position first)."""
    rng = np.random.default_rng(seed)
    s = -np.sort(-rng.normal(size=(q, p, k)).astype(np.float32), axis=-1)
    s[:, ::3] = s[:, :1]
    ids = rng.integers(0, 10 ** 6, size=(q, p, k)).astype(np.int32)
    mask = rng.uniform(size=(q, p)) < 0.6
    mask[0] = False
    if q > 1:
        mask[1] = False
        mask[1, p // 2] = True
        s[1, p // 2, 1:] = -1e30
        ids[1, p // 2, 1:] = -1
    return s, ids, mask


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 64])
@pytest.mark.parametrize("p", [1, 4, 64, 200])
@pytest.mark.parametrize("q", [1, 3, 8, 33])
def test_topk_merge_on_card(cuda_device, q, p, k):
    """Both selections (k rounds where the row fits one chunk, the warp
    list always) give the plain version's ids and scores exactly."""
    from repro_torch.kernels import topk_retrieval as tk
    s, ids, mask = (_t(a).to(cuda_device)
                    for a in _merge_inputs(q, p, k, seed=q * 1000 + p + k))
    want_s, want_i = ops.retrieval_topk_merge(s, ids, mask, k, impl="ref")
    calls = {"by shape": lambda: tk.topk_merge_cuda(s, ids, mask, k),
             "list": lambda: tk._merge_selection(s, ids, mask, k, False)}
    if p * k <= tk.MERGE_ROUNDS_MAX:
        calls["rounds"] = lambda: tk._merge_selection(s, ids, mask, k, True)
    for name, call in calls.items():
        got_s, got_i = call()
        torch.cuda.synchronize()
        np.testing.assert_array_equal(_np(got_i), _np(want_i), name)
        np.testing.assert_array_equal(_np(got_s), _np(want_s), name)
    assert (_np(got_i)[0] == -1).all()          # the all-masked row


@pytest.mark.cuda
def test_topk_merge_unaligned_rows_on_card(cuda_device):
    """Rows not 16-byte aligned (P * k odd) take the scalar loads."""
    from repro_torch.kernels import topk_retrieval as tk
    s, ids, mask = (_t(a).to(cuda_device)
                    for a in _merge_inputs(5, 7, 3, seed=5))
    want = ops.retrieval_topk_merge(s, ids, mask, 3, impl="ref")
    for rounds in (True, False):
        got = tk._merge_selection(s, ids, mask, 3, rounds)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), _np(w))


# ------------------------------------------- int8 pages on a serving path
def _reduced_model(device):
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = get_config("llama3-8b").reduced(num_layers=2)
    return cfg, Model(cfg, device=device)


@pytest.mark.cuda
def test_int8_model_on_card_matches_cpu(cuda_device):
    """A reduced llama's int8 chunked prefill and paged decode on the card
    against the same weights on the CPU, to the 0.025 logit bound of
    ``tests/test_quant_kv.py`` (the card's sums run in another order, so a
    K/V value on a rounding boundary can land one int8 code apart)."""
    from repro_torch.models.model import init_cache
    cfg, cpu = _reduced_model("cpu")
    gpu = _reduced_model("cuda")[1]
    params = cpu.init(seed=3, dtype=torch.float32)
    p_gpu = _to(params, cuda_device)
    ctx, chunk, page, steps = 48, 16, 8, 6
    nmax = -(-(ctx + steps) // page)
    rng = np.random.default_rng(4)
    prompts = _t(rng.integers(2, cfg.vocab_size, size=(2, ctx)).astype(
        np.int32))
    tab = _t(np.arange(1, 2 * nmax + 1, dtype=np.int32).reshape(2, nmax))
    out, feed = {}, []             # both devices decode the CPU's tokens
    for dev, model, prm in (("cpu", cpu, params), ("cuda", gpu, p_gpu)):
        cache = init_cache(cfg, 2 * nmax + 1, page, torch.float32, dev,
                           kv_format="int8")
        t = tab.to(dev)
        logits = []
        for slot in range(2):
            for off in range(0, ctx, chunk):
                last = model.chunk_prefill(
                    prm, prompts[slot:slot + 1, off:off + chunk].to(dev),
                    cache, torch.tensor([off], dtype=torch.int32,
                                        device=dev), t[slot:slot + 1],
                    kv_span=ctx)
            logits.append(last[0].float().cpu())
        cur = torch.stack([l.argmax() for l in logits]).to(torch.int32)
        for i in range(steps):
            if dev == "cpu":
                feed.append(cur)
            pos = torch.full((2,), ctx + i, dtype=torch.int32, device=dev)
            step = model.decode(prm, feed[i][:, None].to(dev), cache, pos,
                                t, kv_span=ctx + steps).float().cpu()
            logits.extend(step)
            cur = step.argmax(-1).to(torch.int32)
        out[dev] = torch.stack(logits)
    err = float((out["cuda"] - out["cpu"]).abs().max())
    assert err < 0.025, err


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _swap_run(cfg, params, preempt, overlap, max_swaps=None):
    """Six requests through three int8 slots on the card, a victim
    preempted every third tick (every other one partially; at most
    ``max_swaps`` times) and resumed two ticks later.  Returns the texts,
    the swap-outs and the steps in which a slot decoded while a swap-in
    was still in flight.

    A step that must wait for a swap-in to land applies it and returns
    (as the reference's does), so a copy slower than three ticks lets
    the resumed slot be parked again before it decodes: ``max_swaps``
    bounds that cycle."""
    from repro_torch.serving import ContinuousGenerator, GeneratorConfig
    g = GeneratorConfig(ctx_len=32, max_new_tokens=12, dtype=torch.bfloat16)
    prompts = [f"query {i} topic{i % 3} alpha beta" for i in range(6)]
    gen = ContinuousGenerator(cfg, params, g, num_slots=3, paged=True,
                              page_size=4, prefill_chunk=16,
                              kv_format="int8", overlap_swap=overlap,
                              device="cuda")
    pending = list(enumerate(prompts))[::-1]
    results, parked, tick, overlapped = [None] * len(prompts), [], 0, 0
    while pending or gen.active_slots or gen.parked_slots:
        for due, h in list(parked):
            if tick >= due and gen.resume(h) is not None:
                parked.remove((due, h))
        while pending and gen.admit_capacity > 0:
            key, prompt = pending.pop()
            assert gen.join(key, prompt) is not None
        if (preempt and tick % 3 == 2
                and (max_swaps is None or gen.swap_outs < max_swaps)):
            victim = gen.swap_victim()
            if victim is not None:
                held = len(gen.kv.pool.table(victim.index))
                h = gen.preempt(victim, pages=(held + 1) // 2
                                if tick % 2 else None)
                if h is not None:
                    parked.append((tick + 2, h))
        overlapped += 0 < len(gen.pending_resumes) < gen.active_slots
        gen.step()
        for key, text, _ in gen.harvest():
            results[key] = text
        tick += 1
        assert tick < 500
    gen.fence()
    assert gen.kv.pool.used_pages == 0 and gen.kv.host.used_pages == 0
    assert gen.kv.pool.inflight_pages == 0 and gen.kv.outstanding == 0
    return results, gen.swap_outs, overlapped


@pytest.mark.cuda
def test_overlapped_swap_on_card_matches_inline(cuda_device):
    """Preempt/resume round trips on an int8 pool on the card: copies on
    the side stream (overlap) give the tokens of inline copies and of no
    preemption at all, and every page and host page comes back."""
    cfg, model = _reduced_model("cuda")
    params = model.init(seed=5, dtype=torch.bfloat16)
    base, _, _ = _swap_run(cfg, params, False, False)
    inline, n_inline, _ = _swap_run(cfg, params, True, False)
    overlap, n_overlap, _ = _swap_run(cfg, params, True, True)
    assert n_inline > 0 and n_overlap > 0
    assert inline == base
    assert overlap == base


@pytest.mark.cuda
@pytest.mark.parametrize("cycles", [10**5, 10**6, 3 * 10**6, 10**7])
def test_delayed_swap_copies_overlap_decode_and_match_inline(
        cuda_device, monkeypatch, cycles):
    """The side stream spins before every swap copy, so resumed slots'
    pages and scales land while the other slots decode and prefill (the
    int8 writes of those steps must not put stale values back over them);
    the tokens equal those of inline copies."""
    from repro_torch.serving import kvpool
    cfg, model = _reduced_model("cuda")
    params = model.init(seed=5, dtype=torch.bfloat16)
    inline, n_inline, _ = _swap_run(cfg, params, True, False, max_swaps=6)
    for name in ("load", "store"):
        def slow(self, *args, _copy=getattr(kvpool.HostPagePool, name)):
            torch.cuda._sleep(cycles)          # on the side stream
            return _copy(self, *args)
        monkeypatch.setattr(kvpool.HostPagePool, name, slow)
    overlap, n_overlap, overlapped = _swap_run(cfg, params, True, True,
                                               max_swaps=6)
    assert n_inline > 0 and n_overlap > 0
    assert overlapped > 0
    assert overlap == inline


@pytest.mark.cuda
@pytest.mark.parametrize("lag", ["compute", "copy"])
@pytest.mark.parametrize("depth", [1, 2, 8])
def test_streamed_ring_orders_copies_and_reads(cuda_device, monkeypatch,
                                               depth, lag):
    """The streamed executor's ring of ``depth + 1`` slots on a 12-layer
    model, with one side made to lag by ``torch.cuda._sleep`` before each
    layer: the compute stream (a copy must wait for the last read of the
    slot it overwrites) or the copy stream (a layer must wait for its
    copy).  A prefill and four decode passes give the resident ``Model``'s
    logits bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.core.prefetch import PrefetchPolicy, StreamedExecutor
    from repro_torch.models import transformer
    from repro_torch.models.model import Model, init_cache
    cfg = get_config("llama3-8b").reduced(num_layers=12)
    model = Model(cfg, device=cuda_device)
    params = model.init(seed=6, dtype=torch.float32)
    # each spin (about 5 ms) outlasts the host's launches of a layer, so
    # the lagging stream falls behind the other by several layers a pass
    b, ctx, steps = 2, 16, 4
    gen = torch.Generator().manual_seed(7)
    toks = torch.randint(2, cfg.vocab_size, (b, ctx), generator=gen,
                         dtype=torch.int32).to(cuda_device)
    cache = init_cache(cfg, b, ctx + steps, torch.float32, cuda_device)
    want, curs = [model.prefill(params, toks, cache)], []
    for t in range(steps):
        curs.append(want[-1].argmax(-1)[:, None].to(torch.int32))
        pos = torch.full((b,), ctx + t, dtype=torch.int32, device=cuda_device)
        want.append(model.decode(params, curs[-1], cache, pos))
    ex = StreamedExecutor(cfg, params, PrefetchPolicy(max_depth=depth,
                                                      prefill_depth=depth),
                          device=cuda_device)
    assert ex.ring_slots == depth + 1
    if lag == "compute":
        apply_layer = transformer.apply_layer

        def slow(*a, **kw):
            torch.cuda._sleep(10**7)           # on the compute stream
            return apply_layer(*a, **kw)

        monkeypatch.setattr(transformer, "apply_layer", slow)
    else:
        stage = StreamedExecutor._stage

        def slow(self, i):
            with torch.cuda.stream(self._copy):
                torch.cuda._sleep(10**7)       # on the copy stream
            return stage(self, i)

        monkeypatch.setattr(StreamedExecutor, "_stage", slow)
    cache = init_cache(cfg, b, ctx + steps, torch.float32, cuda_device)
    got = [ex.prefill(toks, cache)]
    for t in range(steps):
        pos = torch.full((b,), ctx + t, dtype=torch.int32, device=cuda_device)
        got.append(ex.decode(curs[t], cache, pos))
    assert ex.passes == steps + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
