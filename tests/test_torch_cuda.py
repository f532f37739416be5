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
