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


def _flash_kernel(dtype):
    """The launch count a flash call of ``dtype`` adds to: the bf16 and
    the fp32 kernels count apart."""
    return "flash_attention_fp32" if dtype == torch.float32 else \
        "flash_attention"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("h,d", [(4, 16), (8, 16), (16, 16), (4, 128),
                                 (8, 128), (16, 128)])
def test_paged_decode_kernel_on_card(cuda_device, quant, h, d):
    """Every (query heads per kv head, head_dim) variant the kernel builds
    at head dims 16 and 128: G = 2, 4 and 8 (two kv heads)."""
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
    before = ops.launch_counts()[_flash_kernel(dtype)]
    got = ops.flash_attention(q, k, v, **kw)
    want = ops.flash_attention(q, k, v, impl="ref", **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()[_flash_kernel(dtype)] == before + 1
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
@pytest.mark.parametrize("h,d", [(4, 16), (8, 16), (16, 16), (4, 128),
                                 (8, 128), (16, 128)])
@pytest.mark.parametrize("window,softcap", [(None, None), (50, 5.0)])
def test_dense_decode_kernel_on_card(cuda_device, dtype, h, d, window,
                                     softcap):
    """Every compiled (query heads per kv head, head_dim) variant at head
    dims 16 and 128 (G = 2, 4 and 8), fp32 (2e-5) and bf16 caches."""
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


# ------------------------------------------ the attention families' shapes
# (query heads, kv heads, head dim): gemma2-2b, gemma-7b, chatglm3-6b,
# granite-moe-1b-a400m, llama3-70b's and jamba's attention (G = 8), and
# seamless-m4t-medium's self and cross attention (G = 1 at head dim 64)
FAMILY_SHAPES = [(8, 4, 256), (16, 16, 256), (32, 2, 128), (16, 8, 64),
                 (64, 8, 128), (16, 16, 64)]
FAMILY_IDS = ["gemma2", "gemma7b", "chatglm3", "granite", "llama70b",
              "seamless"]


@pytest.mark.cuda
@pytest.mark.parametrize("h,kvh,d", FAMILY_SHAPES, ids=FAMILY_IDS)
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float32,
                                      torch.int8])
@pytest.mark.parametrize("window,softcap", [(None, None), (100, 50.0)])
def test_paged_decode_family_shapes_on_card(cuda_device, h, kvh, d,
                                            kv_dtype, window, softcap):
    """Pages of 16 over 40 pages a slot, in splits: G = 1, 2, 8 and 16 query
    heads a kv head at head dims 64, 128 and 256, bf16, fp32 and int8
    pages, with and without window and softcap; a dead slot on page 0."""
    lengths = [1, 17, 300, 640, -1]
    args, kw = _wide_paged_case(cuda_device, kv_dtype, lengths, nmax=40,
                                h=h, kvh=kvh, d=d)
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
@pytest.mark.parametrize("h,kvh,d", FAMILY_SHAPES, ids=FAMILY_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,softcap", [(None, None), (300, 50.0)])
def test_dense_decode_family_shapes_on_card(cuda_device, h, kvh, d, dtype,
                                            window, softcap):
    """S = 700 in splits, kv_len 1, 17, 450, 700; the family shapes."""
    rng = np.random.default_rng(29)
    b, s = 4, 700
    q = _t(rng.normal(size=(b, h, d)).astype(np.float32)).to(cuda_device,
                                                              dtype)
    k, v = (_t(rng.normal(size=(b, s, kvh, d)).astype(np.float32))
            .to(cuda_device, dtype) for _ in range(2))
    kv_len = _t(np.array([1, 17, 450, 700], np.int32)).to(cuda_device)
    kw = dict(window=window, softcap=softcap)
    got = ops.decode_attention(q, k, v, kv_len, **kw)
    want = ops.decode_attention(q, k, v, kv_len, impl="ref", **kw)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
        return
    wmean = ops.decode_attention(q.float(), k.float(), v.float().abs(),
                                 kv_len, impl="ref", **kw)
    err = np.abs(_np(got.float()) - _np(want.float()))
    assert (err <= _bf16_bound(_np(want.float()), _np(wmean))).all(), \
        float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("h,kvh,d", FAMILY_SHAPES, ids=FAMILY_IDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,sq,per_row,window,softcap", [
    (2, 300, False, None, None), (2, 300, False, 70, 50.0),
    (3, 70, True, None, None), (3, 70, True, 40, 50.0),
    (8, 600, False, 150, 50.0)])
def test_flash_attention_family_shapes_on_card(cuda_device, h, kvh, d, dtype,
                                               b, sq, per_row, window,
                                               softcap):
    """The family shapes, bf16 (one and two consumer warpgroups: b = 8
    and Sq = 600 takes two at every shape) and fp32 (the int8 chunked prefill's path),
    scalar and per-row q_offset, ragged Sq and Sk = Sq + 33 against the
    64-key tiles of head dim 256 and the 128-key tiles below it; windows
    skip whole kv tiles."""
    rng = np.random.default_rng(31)
    sk = sq + 33
    q, k, v = (_t(rng.normal(size=shape).astype(np.float32))
               .to(cuda_device, dtype)
               for shape in ((b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d)))
    if per_row:
        off = rng.integers(0, 34, size=b).astype(np.int32)
        kw = dict(q_offset=_t(off).to(cuda_device),
                  kv_len=_t(off + sq).to(cuda_device))
    else:
        lens = np.linspace(sk, sq, b).astype(np.int32)
        kw = dict(q_offset=0, kv_len=_t(lens).to(cuda_device))
    kw.update(causal=True, window=window, softcap=softcap)
    if dtype == torch.bfloat16 and b == 8:
        from repro_torch.kernels.flash_attention import launch_shape
        assert launch_shape(b, sq, h, d)["consumers"] == 2
    got = ops.flash_attention(q, k, v, **kw)
    want = ops.flash_attention(q, k, v, impl="ref", **kw)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
        return
    wmean = ops.flash_attention(q.float(), k.float(), v.float().abs(),
                                impl="ref", **kw)
    err = np.abs(_np(got.float()) - _np(want.float()))
    assert (err <= _bf16_bound(_np(want.float()), _np(wmean))).all(), \
        float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,sq,per_row", [(2, 300, False), (8, 600, False),
                                          (3, 70, True)])
def test_flash_attention_mla_shape_on_card(cuda_device, dtype, b, sq,
                                           per_row):
    """deepseek-v2-lite's MLA prefill: 16/16 heads, q and k of 192 columns,
    v of 128, scale 192**-0.5; the output is (B, Sq, H, 128).  bf16 with
    one and two consumer warpgroups (b = 8, Sq = 600 takes two), fp32;
    ragged Sq and Sk = Sq + 33, scalar and per-row offsets."""
    rng = np.random.default_rng(37)
    h, d, dv, sk = 16, 192, 128, sq + 33
    q, k, v = (_t(rng.normal(size=shape).astype(np.float32))
               .to(cuda_device, dtype)
               for shape in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, dv)))
    if per_row:
        off = rng.integers(0, 34, size=b).astype(np.int32)
        kw = dict(q_offset=_t(off).to(cuda_device),
                  kv_len=_t(off + sq).to(cuda_device))
    else:
        kw = dict(q_offset=0, kv_len=_t(np.full(b, sk, np.int32)).to(
            cuda_device))
    kw.update(causal=True, scale=d ** -0.5)
    if dtype == torch.bfloat16 and b == 8:
        from repro_torch.kernels.flash_attention import launch_shape
        shape = launch_shape(b, sq, h, d, dv)
        assert shape["consumers"] == 2 and shape["stages"] == 2
    before = ops.launch_counts()[_flash_kernel(dtype)]
    got = ops.flash_attention(q, k, v, **kw)
    want = ops.flash_attention(q, k, v, impl="ref", **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()[_flash_kernel(dtype)] == before + 1
    assert got.shape == want.shape == (b, sq, h, dv)
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
        return
    wmean = ops.flash_attention(q.float(), k.float(), v.float().abs(),
                                impl="ref", **kw)
    err = np.abs(_np(got.float()) - _np(want.float()))
    assert (err <= _bf16_bound(_np(want.float()), _np(wmean))).all(), \
        float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,kvh", [(16, 16), (4, 2)])
@pytest.mark.parametrize("b,sq,sk", [(2, 16, 1024), (8, 128, 1024),
                                     (2, 300, 1000), (1, 1000, 1000),
                                     (3, 70, 333)])
def test_flash_attention_non_causal_on_card(cuda_device, dtype, h, kvh, b,
                                            sq, sk):
    """seamless's encoder (Sq = Sk, bidirectional) and cross attention
    (a short decoder Sq against the encoder's Sk) at head dim 64: never
    causal, Sq != Sk, Sk ragged against the 128-key tiles (1000, 333) and
    Sq against the 64-row warpgroups; bf16 and the fp32 path."""
    rng = np.random.default_rng(sq + sk)
    q, k, v = (_t(rng.normal(size=shape).astype(np.float32))
               .to(cuda_device, dtype)
               for shape in ((b, sq, h, 64), (b, sk, kvh, 64),
                             (b, sk, kvh, 64)))
    before = ops.launch_counts()[_flash_kernel(dtype)]
    got = ops.flash_attention(q, k, v, causal=False)
    want = ops.flash_attention(q, k, v, causal=False, impl="ref")
    torch.cuda.synchronize()
    assert ops.launch_counts()[_flash_kernel(dtype)] == before + 1
    assert got.shape == (b, sq, h, 64)
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
        return
    wmean = ops.flash_attention(q.float(), k.float(), v.float().abs(),
                                causal=False, impl="ref")
    err = np.abs(_np(got.float()) - _np(want.float()))
    assert (err <= _bf16_bound(_np(want.float()), _np(wmean))).all(), \
        float(err.max())


# the fp32 flash kernel (3xTF32): every (q/k, v) head-dim pair the fp32
# path serves or trains at, and per pair these cases: (name, b, sq, sk,
# heads, kv heads, causal, window, softcap, per-row q_offset or None)
FP32_FLASH_PAIRS = [(16, 16), (64, 64), (128, 128), (256, 256), (192, 128)]
# pairs no config reaches, which take the runtime-dims build: one in each
# of its n-tile counts (DV up to 16, 32, 64, 128 and 256)
FP32_FLASH_UNSERVED = [(32, 16), (64, 32), (128, 64), (96, 96), (256, 160)]
FP32_FLASH_CASES = [
    ("causal G4 ragged", 2, 300, 300, 8, 2, True, None, None, None),
    ("never causal G1 sq!=sk", 2, 70, 333, 4, 4, False, None, None, None),
    ("window 300 softcap 50 G8 chunk", 1, 256, 1024, 8, 1, True, 300, 50.0,
     (768,)),
    ("per-row offsets G8 ragged", 3, 70, 600, 8, 1, True, None, None,
     (0, 200, 530)),
    ("deep chunk G2 splits", 1, 256, 4096, 2, 1, True, None, None, (3840,)),
    ("window 300 never causal G4 splits", 1, 256, 4096, 8, 2, False, 300,
     None, None),
]


def _fp32_flash_inputs(device, d, dv, case):
    _, b, sq, sk, h, kvh, causal, window, cap, off = case
    rng = np.random.default_rng(sq + sk + d)
    q, k = (_t(rng.normal(size=s).astype(np.float32)).to(device)
            for s in ((b, sq, h, d), (b, sk, kvh, d)))
    v = _t(rng.normal(size=(b, sk, kvh, dv)).astype(np.float32)).to(device)
    kw = dict(causal=causal, window=window, softcap=cap, scale=d ** -0.5)
    if off is not None:
        off = np.asarray(off, np.int32)
        kw.update(q_offset=_t(off).to(device),
                  kv_len=_t(np.minimum(off + sq, sk).astype(np.int32))
                  .to(device))
    return q, k, v, kw


def _lse_plain(q, k, *, causal, window, softcap, scale, kv_len=None,
               q_offset=0):
    """Each row's log-sum-exp of its capped, masked scores (B, H, Sq), in
    float64, per-row offsets too."""
    b, sq, h, _ = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    kk = k.double().repeat_interleave(h // kvh, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double() * scale, kk)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    off = (q_offset.long() if torch.is_tensor(q_offset)
           else torch.full((b,), q_offset, device=q.device))
    q_pos = off[:, None] + torch.arange(sq, device=q.device)      # (B, Sq)
    k_pos = torch.arange(sk, device=q.device)
    lens = (kv_len.long() if kv_len is not None
            else torch.full((b,), sk, device=q.device))
    ok = (k_pos[None, None, :] < lens[:, None, None]).expand(b, sq, sk)
    if causal:
        ok = ok & (k_pos[None, None, :] <= q_pos[:, :, None])
    if window:
        ok = ok & (k_pos[None, None, :] > q_pos[:, :, None] - window)
    return torch.logsumexp(s.masked_fill(~ok[:, None], float("-inf")), -1)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv", FP32_FLASH_PAIRS + FP32_FLASH_UNSERVED)
@pytest.mark.parametrize("case", FP32_FLASH_CASES,
                         ids=[c[0] for c in FP32_FLASH_CASES])
def test_fp32_flash_kernel_on_card(cuda_device, d, dv, case):
    """The fp32 kernel (3xTF32 on mma.sync, split over the keys), in its
    fixed-dims and runtime-dims builds, against the plain version at 2e-5,
    output and log-sum-exp; one launch on the fp32 count and none on the
    bf16 one; two calls bit-equal."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, kw = _fp32_flash_inputs(cuda_device, d, dv, case)
    before = ops.launch_counts()
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["flash_attention_fp32"] == before["flash_attention_fp32"] + 1
    assert after["flash_attention"] == before["flash_attention"]
    want = ops.flash_attention(q, k, v, impl="ref", **kw)
    assert got.shape == want.shape == (q.shape[0], q.shape[1], q.shape[2],
                                       dv)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
    out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    again, lse2 = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, got) and torch.equal(again, out)
    assert torch.equal(lse, lse2)
    np.testing.assert_allclose(_np(lse), _np(_lse_plain(q, k, **kw)),
                               atol=2e-5)


@pytest.mark.cuda
def test_fp32_flash_splits_the_deep_chunk(cuda_device):
    """The deep chunk and the never-causal window of ``FP32_FLASH_CASES``
    run in more than one split on the card, so their cases above hold the
    merge kernel too."""
    from repro_torch.kernels import flash_attention as fa
    shape = fa.fp32_shape(128, 128)
    assert shape["per_sm"] >= 1 and shape["keys"] == 32 and \
        shape["rows"] == 64
    slots = shape["per_sm"] * torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    assert fa.fp32_splits(1, 256, 2, 4096, True, None, 64, 32, slots)[0] > 1
    assert fa.fp32_splits(1, 256, 8, 4096, False, 300, 64, 32, slots)[0] > 1


@pytest.mark.cuda
def test_decode_library_builds_g1_at_d64(cuda_device):
    """The decode libraries report (G = 1, EPL = 2) among their built
    pairs, and ``BUILT_SHAPES`` equals their ``kBuilt`` (held when each
    loads)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_attention as pa
    for lib in (pa._lib(), da._lib()):
        pa._check_built(lib)
    assert 64 in pa.BUILT_SHAPES[1]
    pa.check_decode_shape(16, 16, 64)


@pytest.mark.cuda
def test_flash_attention_refuses_unbuilt_head_dims(cuda_device):
    """bf16 pairs other than the built ones raise, naming them; fp32 takes
    a value dim up to the query/key dim."""
    q = torch.zeros((1, 8, 2, 192), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"\(192, 128\)"):
        ops.flash_attention(q, q, q[..., :64])
    qf = q.float()
    with pytest.raises(ValueError, match="v <= q/k"):
        ops.flash_attention(qf[..., :64], qf[..., :64], qf[..., :128])


# ------------------------------------------------- the MoE's exact products
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("tokens", [1, 8])
def test_grouped_ffn_products_in_fp32_on_card(cuda_device, arch, tokens):
    """The exact MoE path's three products (``moe._mm_f32``) take bf16
    operands to an fp32 result on the card, as the reference's
    ``ragged_dot``: each within 1e-5 of the largest |product| of the same
    product on fp32 copies of the operands, where the product rounded to
    bf16 is over 1e-4 off.  Operands as ``_grouped_ffn`` builds them at the
    arch's full expert shapes, the upper half of the experts empty.  The
    whole ``_grouped_ffn`` within 1e-5 of the down product of fp32 copies
    of the hidden rows these products give (against fp32 products
    throughout, the hidden rows, rounded to bf16, would differ by an ulp
    wherever a product's last bits tip them)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config(arch)
    m, d = cfg.moe, cfg.d_model
    e, f, tk = m.num_experts, m.d_ff_expert, tokens * m.top_k
    gen = torch.Generator(device=cuda_device).manual_seed(41)

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=cuda_device)
                * shape[-2] ** -0.5).to(torch.bfloat16)

    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max())

    p = {"w_gate": w(e, d, f), "w_up": w(e, d, f), "w_down": w(e, f, d)}
    xs = torch.randn((tk, d), generator=gen,
                     device=cuda_device).to(torch.bfloat16)
    gs = torch.bincount(torch.randint(0, e // 2, (tk,), generator=gen,
                                      device=cuda_device), minlength=e)
    expert, at = moe._group_index(gs, tk)
    buf = xs.new_zeros((e, tk, d))
    buf[expert, at] = xs

    def product(a, b):
        got = moe._mm_f32(a, b)
        want = torch.bmm(a.float(), b.float())
        assert got.dtype == torch.float32
        assert rel(got, want) <= 1e-5
        assert rel(torch.bmm(a, b).float(), want) > 1e-4
        return got

    g = product(buf, p["w_gate"])
    u = product(buf, p["w_up"])
    h = (moe._act(g, cfg.mlp_kind) * u).to(torch.bfloat16)
    product(h, p["w_down"])
    y = moe._grouped_ffn(p, xs, gs, cfg.mlp_kind)
    assert rel(y, torch.bmm(h.float(), p["w_down"].float())[expert, at]) \
        <= 1e-5


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


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("rows,d", [(8, 512), (8, 2048), (8192, 2048)])
def test_rmsnorm_dense_family_widths_on_card(cuda_device, fused, rows, d):
    """bf16 at MLA's latent width (deepseek's ``norm_kv``: 512) and at
    2048 (mamba2's gate norm, decode and a whole-batch prefill's rows;
    deepseek's d_model)."""
    x, r, _ = _norm_inputs(cuda_device, torch.bfloat16, rows, d, seed=d)
    w = _norm_inputs(cuda_device, torch.bfloat16, 1, d, seed=d + 1)[2]
    if fused:
        s, y = ops.add_rmsnorm(x, r, w, 1e-5)
        assert torch.equal(s, x + r)
    else:
        s, y = x, ops.rmsnorm(x, w, 1e-5)
    _assert_norm_close(y, ops.rmsnorm(s, w, 1e-5, impl="ref"),
                       torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(8, 8192), (8, 16384), (300, 16384)])
def test_rmsnorm_hybrid_widths_on_card(cuda_device, fused, dtype, rows, d):
    """jamba's widths: d_model 8192 and its Mamba gate norm over d_inner
    16384, in bf16 and fp32 (fp32 at 16384 holds 4 vectors a thread, the
    variant no narrower row takes)."""
    x, r, _ = _norm_inputs(cuda_device, dtype, rows, d, seed=d)
    w = _norm_inputs(cuda_device, dtype, 1, d, seed=d + 1)[2]
    if fused:
        s, y = ops.add_rmsnorm(x, r, w, 1e-5)
        assert torch.equal(s, x + r)
    else:
        s, y = x, ops.rmsnorm(x, w, 1e-5)
    _assert_norm_close(y, ops.rmsnorm(s, w, 1e-5, impl="ref"), dtype)


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


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_store_on_card(cuda_device, tmp_path, shards):
    """The cross-shard merge at (Q, S, k) under an all-true mask (rows of
    S * k = 10 or 20 entries, unaligned for S = 2) equals the plain
    version's, and ``ShardedIVFStore.search`` on the card equals the
    single-host search bit for bit, exact and probed, with each shard's
    hot tier funded."""
    from repro_torch.retrieval import ShardedIVFStore, VectorStore
    from repro_torch.retrieval.synthetic import (ArrayEmbedder, blob_corpus,
                                                 perturb_queries)
    s, ids, _ = (_t(a).to(cuda_device)
                 for a in _merge_inputs(8, shards, 5, seed=shards))
    full = torch.ones(s.shape[:2], dtype=torch.bool, device=cuda_device)
    got = ops.retrieval_topk_merge(s, ids, full, 5)
    want = ops.retrieval_topk_merge(s, ids, full, 5, impl="ref")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))
    vecs = blob_corpus(n=4000, dim=64, clusters=8, seed=3)
    store = VectorStore.build([str(i) for i in range(4000)],
                              ArrayEmbedder(vecs), num_partitions=8, seed=3,
                              root=str(tmp_path), device=cuda_device)
    for pid in (6, 7):
        store.spill(pid)
    q = perturb_queries(vecs, 8, seed=4)
    sharded = ShardedIVFStore(store, shards)
    try:
        for nprobe in (None, 3):
            want = store.search(q, 5, nprobe=nprobe)
            got = sharded.search(q, 5, nprobe=nprobe)
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[0], want[0])
        sharded.set_hot_budgets([2 * store.partition_bytes()] * shards,
                                list(range(8)))
        for shard in sharded.shards:
            assert shard.hot.pids() and set(shard.hot.pids()) <= shard.pid_set
        got = sharded.search(q, 5, nprobe=3)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
    finally:
        sharded.close()


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


@pytest.mark.cuda
def test_streamed_ring_over_uneven_layers(cuda_device):
    """jamba reduced (Mamba + dense, Mamba + MoE and attention + MoE
    layers, three sizes) at ``max_depth=1``: the depth comes from the mean
    layer, each of the two ring slots is the largest layer's size, the
    ring is allocated at the first pass, not before, so the caller can
    drop its weights first: after that, the device holds ``top`` and the
    ring and nothing else of the weights.  A prefill and three decode
    passes give the resident ``Model``'s logits bit for bit."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.core.prefetch import (PrefetchPolicy, StreamedExecutor,
                                           _pack_layout)
    from repro_torch.models.model import Model, init_cache
    cfg = get_config("jamba-1.5-large-398b").reduced()
    model = Model(cfg, device=cuda_device)
    params = model.init(seed=3, dtype=torch.float32)
    sizes = [_pack_layout(lp)[1] for lp in params["blocks"]]
    assert len(set(sizes)) == 3
    b, ctx, steps = 2, 16, 3
    gen = torch.Generator().manual_seed(4)
    toks = torch.randint(2, cfg.vocab_size, (b, ctx), generator=gen,
                         dtype=torch.int32).to(cuda_device)
    cache = init_cache(cfg, b, ctx + steps, torch.float32, cuda_device)
    want, curs = [model.prefill(params, toks, cache)], []
    for t in range(steps):
        curs.append(want[-1].argmax(-1)[:, None].to(torch.int32))
        pos = torch.full((b,), ctx + t, dtype=torch.int32, device=cuda_device)
        want.append(model.decode(params, curs[-1], cache, pos))
    ex = StreamedExecutor(cfg, params, PrefetchPolicy(max_depth=1),
                          device=cuda_device)
    assert ex.ring_slots == 2 and ex.slot_bytes == max(sizes)
    assert ex.ring_nbytes == 2 * max(sizes)
    top = sum(t.numel() * t.element_size()
              for k, v in params.items() if k != "blocks"
              for t in ([v] if torch.is_tensor(v) else v.values()))
    assert ex.device_nbytes == top + ex.ring_nbytes
    assert ex._ring is None
    params["blocks"].clear()              # the caller drops its layers
    del params
    gc.collect()
    cache = init_cache(cfg, b, ctx + steps, torch.float32, cuda_device)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda_device)
    got = [ex.prefill(toks, cache)]
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated(cuda_device) - before
    # the ring, and the logits the pass returned (allocations round to
    # 512 bytes)
    logits = got[0].numel() * got[0].element_size()
    assert ex.ring_nbytes <= grown <= ex.ring_nbytes + logits + 4096
    for t in range(steps):
        pos = torch.full((b,), ctx + t, dtype=torch.int32, device=cuda_device)
        got.append(ex.decode(curs[t], cache, pos))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ------------------------------------------------------- training kernels
# (B, Sq, Sk, H, KV, D, DV, causal, window, softcap, kv_len, q_offset):
# llama's heads and GQA, D = 64 (granite, seamless), bidirectional, a
# window with a softcap, ragged lengths that divide no tile, kv_len
# padding; then every built pair: D = 16 (the reduced configs) with a
# window and a softcap, D = 256 (gemma2's window and softcap with kv_len;
# gemma-7b's G = 1, ragged), (192, 128) (MLA: causal with kv_len; ragged
# with a softcap) and G = 8 at D = 64; then the fp32 kernels' tile edges:
# Sq and Sk that are multiples of none of 16, 32 and 64, an int q_offset
# with a window, causal key blocks whose first q rows see none of their
# keys (q_offset 40 against 64-key blocks and 16-, 32- or 64-row q tiles),
# G = 8 at D = 256 and at (192, 128), and chip_smoke.py's G = 8 case at
# (1, 4096), whose dK sums 32768 rows (a sum carried that long in the
# tensor core's own accumulator was off by 1.9e-3 where the largest |dk|
# is 7.7, on an H100)
BWD_CASES = [
    (2, 256, 256, 8, 2, 128, 128, True, None, None, None, 0),
    (1, 200, 200, 4, 4, 64, 64, True, None, None, None, 0),
    (2, 192, 320, 4, 2, 64, 64, False, None, None, (320, 250), 0),
    (1, 384, 384, 4, 2, 128, 128, True, 100, 50.0, None, 0),
    (2, 130, 130, 8, 1, 128, 128, False, None, 30.0, (130, 77), 0),
    (1, 200, 200, 4, 2, 16, 16, True, 16, 50.0, None, 0),
    (2, 256, 300, 8, 4, 256, 256, True, 100, 50.0, (300, 270), 0),
    (1, 130, 130, 4, 4, 256, 256, False, None, None, None, 0),
    (2, 256, 256, 4, 4, 192, 128, True, None, None, (256, 200), 0),
    (1, 200, 200, 8, 2, 192, 128, True, None, 30.0, None, 0),
    (1, 256, 256, 8, 1, 64, 64, True, None, None, None, 0),
    (2, 141, 211, 8, 2, 128, 128, True, None, None, None, 70),
    (1, 150, 253, 4, 2, 64, 64, True, 48, None, (253,), 103),
    (2, 100, 140, 4, 2, 16, 16, True, None, None, None, 40),
    (1, 77, 117, 4, 4, 256, 256, True, None, 50.0, None, 40),
    (1, 93, 133, 4, 2, 192, 128, True, None, None, None, 40),
    (1, 130, 130, 16, 2, 256, 256, True, None, None, None, 0),
    (1, 130, 130, 16, 2, 192, 128, True, None, None, None, 0),
    (1, 4096, 4096, 64, 8, 128, 128, True, None, None, None, 0),
]
BWD_IDS = ["llama", "d64-ragged", "bidir-kvlen", "window-softcap",
           "g8-ragged-softcap", "d16-window-softcap", "d256-window-kvlen",
           "d256-g1-ragged", "mla-kvlen", "mla-ragged-softcap", "d64-g8",
           "odd-lengths-qoff", "qoff-window-kvlen", "d16-block-start",
           "d256-block-start-softcap", "mla-block-start", "d256-g8",
           "mla-g8", "g8-long"]


def _bwd_inputs(case, dtype, device):
    b, sq, sk, h, kvh, d, dv, causal, window, softcap, lens, off = case
    gen = torch.Generator(device=device).manual_seed(7)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    q, k, v = rnd(b, sq, h, d), rnd(b, sk, kvh, d), rnd(b, sk, kvh, dv)
    dout = rnd(b, sq, h, dv)
    kv_len = (None if lens is None else
              torch.tensor(lens, dtype=torch.int32, device=device))
    kw = dict(causal=causal, window=window, softcap=softcap, kv_len=kv_len,
              q_offset=off)
    return q, k, v, dout, kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BWD_CASES, ids=BWD_IDS)
def test_flash_lse_and_backward_on_card(cuda_device, case, dtype):
    """The forward's log-sum-exp and the backward kernel against the plain
    ``flash_vjp`` passes: fp32 gradients within 1e-4 of the largest
    |gradient| of the plain fp32 ones, bf16 gradients within 2e-2 of the
    plain fp32 gradients of the same bf16 inputs; lse within 1e-4 (fp32)
    or 2e-3 (bf16, whose scores the kernel scales after the product)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_vjp
    q, k, v, dout, kw = _bwd_inputs(case, dtype, cuda_device)
    out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    f32 = [t.float() for t in (q, k, v, dout)]
    out_p, lse_p = flash_vjp.attention_fwd_lse(*f32[:3], **kw)
    live = lse_p > -1e29
    err = float((lse - lse_p).abs()[live].max())
    assert err <= (1e-4 if dtype == torch.float32 else 2e-3), err
    # each backward from its own forward: the kernel's out and lse, the
    # plain fp32 out and lse
    got = fa.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
    want = flash_vjp.attention_bwd(*f32[:3], out_p, f32[3], lse_p, **kw)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape
        rel = float((g.float() - w).abs().max() / w.abs().max())
        assert rel <= tol, (name, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BWD_CASES, ids=BWD_IDS)
def test_flash_backward_bit_equal_across_calls(cuda_device, case, dtype):
    """Every sum of the backward has one fixed order: two calls on the
    same inputs give bit-equal dq, dk and dv (what a checkpoint resume's
    exact replay rests on)."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, dout, kw = _bwd_inputs(case, dtype, cuda_device)
    out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    first = fa.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
    again = fa.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
    for g, h in zip(first, again):
        assert torch.equal(g, h)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BWD_CASES, ids=BWD_IDS)
def test_flash_backward_bf16_near_fp32_kernel(cuda_device, case):
    """The bf16 kernel (wgmma) against the fp32 kernel (3xTF32) on the
    same inputs upcast, with the bf16 forward's out and lse: within 2e-2
    of the largest |gradient| (P and dS enter the bf16 products
    rounded)."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, dout, kw = _bwd_inputs(case, torch.bfloat16, cuda_device)
    out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    got = fa.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
    want = fa.flash_attention_bwd_cuda(
        *(t.float() for t in (q, k, v, out, dout)), lse, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        rel = float((g.float() - w).abs().max() / w.abs().max())
        assert rel <= 2e-2, (name, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv", [(96, 96), (24, 16), (128, 64)])
def test_flash_backward_unbuilt_shape_raises(cuda_device, d, dv):
    """A pair outside the forward's built set raises, in the kernel's
    wrapper and under autograd, before any launch."""
    from repro_torch.kernels import flash_attention as fa
    q = torch.randn(1, 32, 2, d, device=cuda_device)
    k = torch.randn(1, 32, 2, d, device=cuda_device)
    v = torch.randn(1, 32, 2, dv, device=cuda_device)
    with pytest.raises(NotImplementedError, match=f"{d}"):
        fa.flash_attention_bwd_cuda(q, k, v, q[..., :dv], q[..., :dv],
                                    torch.zeros(1, 2, 32, device=cuda_device))
    with pytest.raises(NotImplementedError):
        ops.flash_attention(q.requires_grad_(True), k, v)


@pytest.mark.cuda
def test_launcher_trains_reduced_llama_on_card(cuda_device):
    """``launch/train.py``'s default reduced llama (head dim 16, fp32) on
    the card: every step's loss finite, the fp32 flash backward launched
    on every step, the loss down over 20 steps."""
    from repro_torch.launch import train
    ops.reset_launch_counts()
    losses = train.main(["--steps", "20", "--log-every", "5"])
    c = ops.launch_counts()
    assert len(losses) == 20 and all(np.isfinite(losses)), losses
    assert c["flash_attention_bwd_fp32"] >= 20, c
    assert losses[-1] < losses[0], losses


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(8192, 4096), (37, 1024), (5, 16384),
                                    (3, 100)])
def test_rmsnorm_backward_on_card(cuda_device, fused, dtype, rows, d):
    """The backward kernel in fp32 against autograd of the plain version
    in fp32 on the same inputs, within 1e-5 of the largest |dx| and |dw|;
    in bf16 against the fp32 kernel on the same (upcast) inputs: dx within
    one bf16 ulp of the fp32 result (the same fp32 arithmetic, rounded
    once), dw (fp32 for either) within 1e-3 of the largest |dw|."""
    from repro_torch.kernels import rmsnorm as rn
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    s, dy = (torch.randn((rows, d), generator=gen, device=cuda_device)
             .to(dtype) for _ in range(2))
    w = (1 + 0.1 * torch.randn((d,), generator=gen,
                               device=cuda_device)).to(dtype)
    ds = (torch.randn((rows, d), generator=gen, device=cuda_device).to(dtype)
          if fused else None)
    dx, dw = rn.rmsnorm_bwd_cuda(s, dy, w, 1e-6, ds=ds)
    assert dx.dtype == dtype and dw.dtype == torch.float32
    f32 = [None if t is None else t.float() for t in (s, dy, w, ds)]
    if dtype == torch.float32:
        want_dx, want_dw = rn.rmsnorm_bwd_plain(*f32[:3], 1e-6, ds=f32[3])
        assert float((dx - want_dx).abs().max()) <= 1e-5 * float(
            want_dx.abs().max())
        tol = 1e-5
    else:
        want_dx, want_dw = rn.rmsnorm_bwd_cuda(*f32[:3], 1e-6, ds=f32[3])
        ulp = torch.finfo(torch.bfloat16).eps * want_dx.abs().clamp(
            min=torch.finfo(torch.bfloat16).tiny)
        err = (dx.float() - want_dx).abs()
        assert bool((err <= ulp).all()), float((err / ulp).max())
        tol = 1e-3
    rel = float((dw - want_dw).abs().max() / want_dw.abs().max())
    assert rel <= tol, rel


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype,w_fp32", [(torch.float32, True),
                                          (torch.bfloat16, True),
                                          (torch.bfloat16, False),
                                          (torch.float16, False)])
@pytest.mark.parametrize("d", [512, 2048, 4096, 8192, 16384, 32768])
def test_rmsnorm_backward_widths_on_card(cuda_device, fused, dtype, w_fp32,
                                         d):
    """Every width class of the one-pass backward (512-32768: two vectors
    a thread, and 1024 threads of four with dw in shared memory), both
    forms, fp32, bf16 and fp16, w in fp32 or x's type, at 300 rows, fewer
    than the blocks the card holds: fp32 within 1e-5 of autograd of the
    plain fp32 version (largest |dx|, |dw|), bf16 and fp16 within one ulp
    of the fp32 kernel on the same inputs upcast (dw within 1e-3); two
    calls bit-equal."""
    from repro_torch.kernels import rmsnorm as rn
    rows = 300
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    s, dy = (torch.randn((rows, d), generator=gen, device=cuda_device)
             .to(dtype) for _ in range(2))
    w = 1 + 0.1 * torch.randn((d,), generator=gen, device=cuda_device)
    w = w if w_fp32 else w.to(dtype)
    ds = (torch.randn((rows, d), generator=gen, device=cuda_device).to(dtype)
          if fused else None)
    dx, dw = rn.rmsnorm_bwd_cuda(s, dy, w, 1e-6, ds=ds)
    dx2, dw2 = rn.rmsnorm_bwd_cuda(s, dy, w, 1e-6, ds=ds)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    f32 = [None if t is None else t.float() for t in (s, dy, w, ds)]
    if dtype == torch.float32:
        want_dx, want_dw = rn.rmsnorm_bwd_plain(*f32[:3], 1e-6, ds=f32[3])
        assert float((dx - want_dx).abs().max()) <= 1e-5 * float(
            want_dx.abs().max())
        tol = 1e-5
    else:
        want_dx, want_dw = rn.rmsnorm_bwd_cuda(*f32[:3], 1e-6, ds=f32[3])
        ulp = torch.finfo(dtype).eps * want_dx.abs().clamp(
            min=torch.finfo(dtype).tiny)
        err = (dx.float() - want_dx).abs()
        assert bool((err <= ulp).all()), float((err / ulp).max())
        tol = 1e-3
    rel = float((dw - want_dw).abs().max() / want_dw.abs().max())
    assert rel <= tol, rel


@pytest.mark.cuda
def test_serving_forward_launches_unchanged_without_grad(cuda_device):
    """A prefill whose weights require grad, under ``no_grad``, launches
    the forward kernels exactly as one whose weights do not, and no
    backward; with grad, the model's loss launches both backward
    kernels."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, init_cache
    cfg = get_config("llama3-8b").reduced(num_layers=2, head_dim=64)
    model = Model(cfg, device=cuda_device)
    params = model.init(seed=0, dtype=torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda_device)

    def counts(requires_grad):
        for t in _leaves(params):
            t.requires_grad_(requires_grad)
        ops.reset_launch_counts()
        with torch.no_grad():
            model.prefill(params, toks, init_cache(cfg, 2, 64,
                                                   device=cuda_device))
        torch.cuda.synchronize()
        return ops.launch_counts()

    plain, with_grad = counts(False), counts(True)
    assert plain == with_grad
    assert plain["flash_attention_bwd"] == plain["rmsnorm_bwd"] == 0
    ops.reset_launch_counts()
    loss, _ = model.loss_fn(params, {"inputs": toks, "labels": toks})
    loss.backward()
    c = ops.launch_counts()
    assert c["flash_attention_bwd"] == 2 and c["rmsnorm_bwd"] == 5, c
    assert all(t.grad is not None and bool(t.grad.isfinite().all())
               for t in _leaves(params))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.cuda
def test_moe_exact_path_differentiable_on_card(cuda_device):
    """granite's reduced MoE on its exact path in bf16 on the card: its
    gradients (``_MmF32``'s backward) within 2e-2 of the largest |gradient|
    of the same bf16 weights and input in fp32 on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("granite-moe-1b-a400m").reduced()
    gen = torch.Generator(device="cpu").manual_seed(5)
    p = moe.init_moe(gen, cfg, torch.bfloat16, "cpu")
    x = torch.randn((2, 16, cfg.d_model), generator=gen).to(torch.bfloat16)

    def grads(p, x):
        p = {k: v.detach().requires_grad_(True) for k, v in p.items()
             if torch.is_tensor(v)}
        x = x.detach().requires_grad_(True)
        out, aux = moe.moe_forward(p, x, cfg)
        (out.float().square().sum() + aux).backward()
        return {"x": x.grad, **{k: v.grad for k, v in p.items()}}

    got = grads({k: v.to(cuda_device) for k, v in p.items()},
                x.to(cuda_device))
    want = grads({k: v.float() for k, v in p.items()}, x.float())
    for name, w in want.items():
        rel = float((got[name].float().cpu() - w).abs().max()
                    / w.abs().max())
        assert rel <= 2e-2, (name, rel)
