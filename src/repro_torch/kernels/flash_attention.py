"""Flash attention (prefill): a CUDA C++ kernel for Hopper, its launch
count and its plain version.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention_pallas``:
causal GQA attention of q ``(B, Sq, H, D)`` against k ``(B, Sk, KV, D)``
and v ``(B, Sk, KV, DV)`` with a per-batch ``kv_len``, a sliding window
and a tanh softcap, in an fp32 online softmax; the output is
``(B, Sq, H, DV)``.  DV differs from D for MLA (deepseek-v2-lite: q and
k of 192 columns, v of 128).  ``q_offset`` places query row ``i`` of
batch ``b`` at ``q_offset + i``; it is an int (one-shot prefill: 0) or a
``(B,)`` tensor (chunked prefill: each row's chunk start), which the
Pallas kernel did not take.

What bounds it on the H100: operations (about 400 flops a byte at the
one-shot llama3-8b prefill), which only ``wgmma`` reaches at the tensor
cores' full rate.  The design, in ``csrc/flash_attention.cu``: each (q
head, batch, q tile) loops over the kv tiles its causal and window reach
can touch, with the softmax state in registers.  bf16 is a persistent,
warp-specialised kernel (one block an SM over the q tiles, heaviest causal
tiles first): a producer thread issues TMA loads of the q rows and of
128-key K and V tiles into a ring of 3 stages (64 keys and 2 stages at
head dim 256, whose tiles are twice as wide; mbarrier completion),
and one or two consumer warpgroups of 64 q rows run S = QK^T and O += PV
as ``wgmma`` (P from registers), the softmax of one tile under the PV of
the one before and under the other warpgroup's products.  At (192, 128)
S reduces over 192 columns and PV is the D = 128 case's; two 128-key
stages fit beside the wider q rows.  fp32 (``flash_attention_fp32_cuda``,
counted apart) keeps the JAX order of operations with fp32-exact products
on the tensor cores: each operand split into two TF32 halves, three
``mma.sync`` a product (3xTF32), the keys of each 64-row q tile cut into
splits (``fp32_splits``) that a second kernel merges in a fixed order.

The backward (``flash_attention_bwd_cuda``, ``csrc/flash_attention_bwd.cu``)
is built at the same head-dim pairs, bf16 and fp32, as two kernels with no
atomics (dK/dV a block a 64 keys, dQ a block of q rows), so two calls give
bit-equal gradients: in bf16 on ``wgmma``; in fp32
(``flash_attention_bwd_fp32_cuda``, counted apart) on ``mma.sync`` with
3xTF32 products, exact to fp32 in the JAX order.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import NEG_INF, _softcap

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# (q/k, v) head dims the bf16 kernel is built for: csrc/flash_attention.cu's
# kBf16Pairs, which ``_lib`` holds this list to when it loads the kernel;
# the fp32 path takes any q/k dim up to 256 and any v dim up to it,
# multiples of 16
BF16_HEAD_DIMS = ((16, 16), (64, 64), (128, 128), (256, 256), (192, 128))
# the fp32 kernel's splits: at least this many kv tiles each
MIN_SPLIT_TILES = 4
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    fn = lib.flash_attention
    if fn.argtypes is None:
        lib.flash_attention_bf16_pairs.argtypes = [ctypes.POINTER(_I), _I]
        lib.flash_attention_bf16_pairs.restype = _I
        buf = (_I * (2 * len(BF16_HEAD_DIMS)))()
        n = lib.flash_attention_bf16_pairs(buf, len(BF16_HEAD_DIMS))
        built = tuple(zip(buf[0:2 * n:2], buf[1:2 * n:2]))
        if n != len(BF16_HEAD_DIMS) or set(built) != set(BF16_HEAD_DIMS):
            raise RuntimeError(f"BF16_HEAD_DIMS {BF16_HEAD_DIMS} is not the "
                               f"kernel's built pairs ({n} pairs: {built})")
        lib.flash_attention_shape.argtypes = [_I] * 5 + [ctypes.POINTER(_I)]
        lib.flash_attention_shape.restype = None
        lib.flash_attention_fp32_shape.argtypes = [_I, _I,
                                                   ctypes.POINTER(_I)]
        lib.flash_attention_fp32_shape.restype = _I
        fn.argtypes = [_P] * 8 + [_I] * 8 + [_F, _I, _I, _F, _I, _I, _I, _P]
        fn.restype = _I
    return lib


def launch_shape(b: int, sq: int, h: int, d: int,
                 dv: Optional[int] = None) -> Dict[str, int]:
    """The bf16 kernel's launch for these sizes (no launch; ``dv``
    defaults to ``d``): consumer warpgroups, q rows a work item, ring
    stages, threads and dynamic shared bytes a block, work items (q tiles
    x heads x batch) and blocks (one an SM at most: the kernel is
    persistent)."""
    info = (_I * 7)()
    _lib().flash_attention_shape(b, sq, h, d, d if dv is None else dv, info)
    keys = ("consumers", "rows", "stages", "threads", "smem", "items",
            "blocks")
    return dict(zip(keys, info))


@functools.lru_cache(maxsize=None)
def fp32_shape(d: int, dv: int) -> Dict[str, int]:
    """The fp32 kernel's launch at head dims (d, dv): keys a kv tile, q
    rows a block, threads and dynamic shared bytes a block, and the blocks
    an SM holds (the card's occupancy for that kernel)."""
    info = (_I * 5)()
    if not _lib().flash_attention_fp32_shape(d, dv, info):
        raise ValueError(f"the fp32 kernel takes no head dims ({d}, {dv})")
    return dict(zip(("keys", "rows", "threads", "smem", "per_sm"), info))


def fp32_splits(b: int, sq: int, h: int, sk: int, causal: bool,
                window: Optional[int], rows: int, keys: int,
                slots: int) -> Tuple[int, int]:
    """``(splits, keys a split)`` for the fp32 kernel, from shapes alone.

    A work item is ``rows`` q rows of one head and batch row; its keys
    (at most ``sk``; a causal window's reach, which causality bounds from
    above, when both are set) are cut into splits of whole
    ``keys``-key tiles, as many as bring ``items * splits`` blocks up to
    the ``slots`` the card holds at once (SMs x blocks an SM), each split
    at least ``MIN_SPLIT_TILES`` tiles: a prefill chunk of 256 rows gives
    32-128 items where 132-264 fit.  With one split a split is the whole
    reach (``sk`` rounded up to a tile)."""
    items = -(-sq // rows) * h * b
    span = min(sk, window + rows + keys - 2) if causal and window else sk
    tiles = max(1, -(-span // keys))
    want = min(max(1, slots // items), max(1, tiles // MIN_SPLIT_TILES))
    if want == 1:
        return 1, -(-sk // keys) * keys
    per = -(-tiles // want)
    return -(-tiles // per), per * keys


def flash_attention_cuda(
    q: torch.Tensor,                # (B, Sq, H, D) bf16
    k: torch.Tensor,                # (B, Sk, KV, D), q's dtype
    v: torch.Tensor,                # (B, Sk, KV, DV), q's dtype
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    kv_len: Optional[torch.Tensor] = None,       # (B,)
    q_offset: Union[int, torch.Tensor] = 0,      # int or (B,)
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Launch the kernel on CUDA tensors; raises on anything it cannot take.
    fp32 goes to ``flash_attention_fp32_cuda`` (its own kernel and launch
    count), bf16 launches the wgmma kernel here.  ``return_lse``: return
    ``(out, lse)`` with each row's fp32 log-sum-exp ``(B, H, Sq)`` for the
    backward pass (training); the serving paths ask for none and launch
    what they did before."""
    kw = dict(causal=causal, window=window, softcap=softcap, kv_len=kv_len,
              q_offset=q_offset, scale=scale, return_lse=return_lse)
    if q.dtype == torch.float32:
        return flash_attention_fp32_cuda(q, k, v, **kw)
    out = _launch(q, k, v, torch.bfloat16, **kw)
    flash_attention_cuda.launches += 1
    return out


def flash_attention_fp32_cuda(q, k, v, **kw):
    """The fp32 kernel (3xTF32 on the tensor cores, split over the keys)
    on CUDA tensors; the same arguments as ``flash_attention_cuda``."""
    out = _launch(q, k, v, torch.float32, **kw)
    flash_attention_fp32_cuda.launches += 1
    return out


def _launch(q, k, v, dtype, *, causal=True, window=None, softcap=None,
            kv_len=None, q_offset=0, scale=None, return_lse=False):
    """Checks, then one launch of the ``dtype`` kernel."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    per_row = torch.is_tensor(q_offset)
    tensors = [q, k, v] + [t for t in (kv_len, q_offset) if torch.is_tensor(t)]
    if not all(t.is_cuda for t in tensors):
        raise ValueError("flash_attention_cuda takes CUDA tensors")
    if (k.shape != (b, sk, kvh, d) or v.shape != (b, sk, kvh, dv)
            or h % kvh):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if q.dtype != dtype or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the kernel takes {dtype} q, k, v, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if dtype == torch.bfloat16 and (d, dv) not in BF16_HEAD_DIMS:
        raise ValueError(f"head dims (q/k {d}, v {dv}) are not built for "
                         f"bf16 (built: {BF16_HEAD_DIMS})")
    if dtype == torch.float32 and not (d % 16 == 0 and dv % 16 == 0
                                       and 0 < dv <= d <= 256):
        raise ValueError(f"head dims (q/k {d}, v {dv}): the fp32 path takes "
                         "multiples of 16 with v <= q/k <= 256")
    if kv_len is not None and kv_len.shape != (b,):
        raise ValueError("kv_len must be (B,)")
    if per_row and q_offset.shape != (b,):
        raise ValueError("a q_offset tensor must be (B,)")
    lib = _lib()
    q, k, v = (_build.aligned16(x) for x in (q, k, v))
    lens = None if kv_len is None else kv_len.to(torch.int32).contiguous()
    offs = q_offset.to(torch.int32).contiguous() if per_row else None
    out = q.new_empty((b, sq, h, dv))
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    scale = scale if scale is not None else d ** -0.5
    splits, split_len, part = 1, 0, None
    if dtype == torch.float32:
        shape = fp32_shape(d, dv)
        splits, split_len = fp32_splits(
            b, sq, h, sk, causal, window, shape["rows"], shape["keys"],
            shape["per_sm"] * _build.sm_count(q.device.index or 0))
        if splits > 1:
            part = torch.empty(b * h * splits * sq * (dv + 2),
                               dtype=torch.float32, device=q.device)
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if lens is None else lens.data_ptr(),
        None if offs is None else offs.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        None if part is None else part.data_ptr(),
        b, sq, sk, h, kvh, d, dv, 0 if per_row else int(q_offset),
        float(scale),
        int(causal), 0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), splits, split_len,
        _DTYPE_CODE[q.dtype], _build.current_stream(q.device))
    _build.check(lib, err, "flash_attention")
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0
flash_attention_fp32_cuda.launches = 0

# (q/k, v) head dims the backward kernel is built for, bf16 and fp32: the
# forward's pairs (csrc/flash_attention_bwd.cu's kPairs), which ``_bwd_lib``
# holds this list to when it loads the kernel
BWD_HEAD_DIMS = BF16_HEAD_DIMS


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.library("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    if fn.argtypes is None:
        lib.flash_attention_bwd_pairs.argtypes = [ctypes.POINTER(_I), _I]
        lib.flash_attention_bwd_pairs.restype = _I
        buf = (_I * (2 * len(BWD_HEAD_DIMS)))()
        n = lib.flash_attention_bwd_pairs(buf, len(BWD_HEAD_DIMS))
        built = tuple(zip(buf[0:2 * n:2], buf[1:2 * n:2]))
        if n != len(BWD_HEAD_DIMS) or set(built) != set(BWD_HEAD_DIMS):
            raise RuntimeError(f"BWD_HEAD_DIMS {BWD_HEAD_DIMS} is not the "
                               f"backward kernel's built pairs ({n} pairs: "
                               f"{built})")
        fn.argtypes = [_P] * 11 + [_I] * 8 + [_F, _I, _I, _F, _I, _P]
        fn.restype = _I
    return lib


def check_bwd_shape(d: int, dv: int, dtype) -> None:
    """Raise ``NotImplementedError`` naming a shape the backward kernel is
    not built for: a (q/k, v) head-dim pair of ``BWD_HEAD_DIMS``, fp32 or
    bf16."""
    if (d, dv) not in BWD_HEAD_DIMS or dtype not in _DTYPE_CODE:
        raise NotImplementedError(
            f"the flash backward kernel is not built for head dims (q/k {d}, "
            f"v {dv}) in {dtype} (built: (q/k, v) in {BWD_HEAD_DIMS}, fp32 "
            "or bf16)")


def flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw):
    """``(dq, dk, dv)`` of flash attention from the kernel
    (``csrc/flash_attention_bwd.cu``), in q's dtype; one launch of the
    backward counts once (it runs three kernels).  fp32 goes to
    ``flash_attention_bwd_fp32_cuda`` (its own kernels, 3xTF32, and launch
    count); bf16 launches the ``wgmma`` kernels here.  Raises on what it
    cannot take, ``NotImplementedError`` on a head-dim pair it is not built
    for."""
    if q.dtype == torch.float32:
        return flash_attention_bwd_fp32_cuda(q, k, v, out, dout, lse, **kw)
    grads = _bwd_launch(q, k, v, out, dout, lse, **kw)
    flash_attention_bwd_cuda.launches += 1
    return grads


def flash_attention_bwd_fp32_cuda(q, k, v, out, dout, lse, **kw):
    """The fp32 backward (3xTF32 on the tensor cores, no atomics) on CUDA
    tensors; the same arguments as ``flash_attention_bwd_cuda``."""
    grads = _bwd_launch(q, k, v, out, dout, lse, **kw)
    flash_attention_bwd_fp32_cuda.launches += 1
    return grads


def _bwd_launch(
    q: torch.Tensor,                # (B, Sq, H, D)
    k: torch.Tensor,                # (B, Sk, KV, D)
    v: torch.Tensor,                # (B, Sk, KV, DV)
    out: torch.Tensor,              # (B, Sq, H, DV): the forward's output
    dout: torch.Tensor,             # (B, Sq, H, DV)
    lse: torch.Tensor,              # (B, H, Sq) fp32: the forward's
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    kv_len: Optional[torch.Tensor] = None,
    q_offset: int = 0,
    scale: Optional[float] = None,
):
    """Checks, then one launch of the backward (three kernels)."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    tensors = [q, k, v, out, dout, lse] + (
        [kv_len] if kv_len is not None else [])
    if not all(t.is_cuda for t in tensors):
        raise ValueError("flash_attention_bwd_cuda takes CUDA tensors")
    check_bwd_shape(d, dv, q.dtype)
    if (k.shape != (b, sk, kvh, d) or v.shape != (b, sk, kvh, dv)
            or out.shape != (b, sq, h, dv) or dout.shape != out.shape
            or lse.shape != (b, h, sq) or h % kvh):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} out {tuple(out.shape)} dout "
                         f"{tuple(dout.shape)} lse {tuple(lse.shape)}")
    if any(t.dtype != q.dtype for t in (k, v, out, dout)) or \
            lse.dtype != torch.float32:
        raise ValueError("q, k, v, out, dout of one dtype and an fp32 lse")
    if kv_len is not None and kv_len.shape != (b,):
        raise ValueError("kv_len must be (B,)")
    if torch.is_tensor(q_offset):
        raise NotImplementedError("the flash backward takes an int q_offset")
    lib = _bwd_lib()
    q, k, v, out, dout = (_build.aligned16(x) for x in (q, k, v, out, dout))
    lse = lse.contiguous()
    lens = None if kv_len is None else kv_len.to(torch.int32).contiguous()
    delta = torch.empty_like(lse)
    dq, dk, dvv = (torch.empty_like(x) for x in (q, k, v))
    scale = scale if scale is not None else d ** -0.5
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        None if lens is None else lens.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dvv.data_ptr(), b, sq, sk, h, kvh, d, dv,
        int(q_offset), float(scale), int(causal),
        0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), _DTYPE_CODE[q.dtype],
        _build.current_stream(q.device))
    _build.check(lib, err, "flash_attention_bwd")
    return dq, dk, dvv


flash_attention_bwd_cuda.launches = 0
flash_attention_bwd_fp32_cuda.launches = 0


def flash_attention_plain(q, k, v, *, causal=True, window=None, softcap=None,
                          kv_len=None, q_offset=0, scale=None, block_kv=256):
    """Online-softmax attention over KV blocks (``repro``'s ``kv_scan``):
    memory O(Sq + block), fp32 accumulation, GQA without repeating KV."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // kvh
    dev = q.device
    scale = scale if scale is not None else d ** -0.5
    block_kv = min(block_kv, sk)
    q32 = q.float().reshape(b, sq, kvh, g, d).permute(0, 2, 3, 1, 4) * scale
    if torch.is_tensor(q_offset):                        # per-row (B,)
        q_pos = q_offset[:, None] + torch.arange(sq, device=dev)
    else:
        q_pos = (torch.arange(sq, device=dev) + q_offset)[None].expand(b, sq)
    valid = kv_len if kv_len is not None else torch.full(
        (b,), sk, dtype=torch.int64, device=dev)
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kvh, g, sq, dv), dtype=torch.float32, device=dev)
    for start in range(0, sk, block_kv):
        stop = min(start + block_kv, sk)
        kb = k[:, start:stop].float().permute(0, 2, 1, 3)   # (B,KV,bk,D)
        vb = v[:, start:stop].float().permute(0, 2, 1, 3)
        s = torch.einsum("bkgqd,bksd->bkgqs", q32, kb)
        s = _softcap(s, softcap)
        k_pos = torch.arange(start, stop, device=dev)
        mask = (k_pos[None, :] < valid[:, None])[:, None, :]  # (B,1,bk)
        if causal:
            mask = mask & (k_pos[None, None, :] <= q_pos[:, :, None])
        if window is not None:
            mask = mask & (k_pos[None, None, :] > q_pos[:, :, None] - window)
        s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqs,bksd->bkgqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(q.dtype)


__all__ = ["flash_attention_cuda", "flash_attention_fp32_cuda",
           "flash_attention_bwd_cuda", "flash_attention_bwd_fp32_cuda",
           "flash_attention_plain"]
