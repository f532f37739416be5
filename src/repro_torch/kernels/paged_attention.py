"""Paged decode attention: a CUDA C++ kernel for Hopper, its launch count
and its plain version.

Replaces ``src/repro/kernels/paged_attention.py::paged_decode_attention_pallas``:
one new token per sequence attends over a KV cache stored as pooled
``(P, page, KV, D)`` pages, routed through a ``(B, nmax)`` block table,
with an optional sliding window and tanh softcap, in an fp32 online
softmax.  Int8 pools carry ``(P, KV)`` fp32 scales and are dequantized
inside the kernel.

What bounds it on the H100: bytes (every live K/V row is read once, at
about 4 flops a byte in bf16), so the kernel has to keep enough of them
in flight on every SM.  The design, in ``csrc/decode_tiles.cuh``
(split-K, "flash-decoding"): blocks over (kv head, slot, split), each
covering the G query heads that share the kv head and a split of whole
pages of the slot's live tokens; a block stages its pages' K and V rows
into shared memory with 16-byte ``cp.async`` copies through a ring of 3
stages, its warps reduce a tile's (token, head) scores in one scattering
warp butterfly and keep their own fp32 online softmax, and the block
writes its state to fp32 scratch; a second kernel merges the splits in
a fixed order.  :func:`decode_splits` picks the split count on the host
from shapes alone, so a decode step never reads ``kv_len`` back.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import \
    paged_decode_attention_reference as paged_decode_attention_plain

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# split-K grid: aim at this many blocks for every SM (a bf16 block stages
# 53 KB, so four fit an SM), and give no split fewer than this many tokens
BLOCKS_PER_SM = 4
MIN_SPLIT_TOKENS = 64


def decode_splits(batch: int, kv_heads: int, span: int, granule: int,
                  num_sms: int) -> Tuple[int, int]:
    """``(splits, tokens a split)`` for a decode step, from shapes alone.

    ``span`` is the most tokens a sequence can have live (the table's
    ``nmax * page``, or less under a window), ``granule`` the unit a split
    is made of (the page; 16 for a dense cache).  Splits are whole
    granules, at least one and at most one a granule, no shorter than
    ``MIN_SPLIT_TOKENS``, and as many as bring the grid of ``batch *
    kv_heads * splits`` blocks to ``BLOCKS_PER_SM`` an SM; a batch that
    fills that on its own gets one split (no merge)."""
    units = max(1, -(-span // granule))
    want = max(1, -(-BLOCKS_PER_SM * num_sms // max(1, batch * kv_heads)))
    per = max(-(-units // min(want, units)), -(-MIN_SPLIT_TOKENS // granule))
    per = min(per, units)
    return -(-units // per), per * granule


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(q: torch.Tensor, kv_heads: int, span: int,
               granule: int) -> Tuple[int, int, Optional[torch.Tensor]]:
    """Splits, tokens a split and, with more than one split, the fp32
    scratch for the splits' (m, l, acc): ``B * KV * splits * G * (D + 2)``
    floats."""
    b, h, d = q.shape
    splits, split_len = decode_splits(b, kv_heads, span, granule,
                                      sm_count(q.device.index or 0))
    scratch = None
    if splits > 1:
        scratch = torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                              device=q.device)
    return splits, split_len, scratch


def launch_shape() -> Tuple[int, int, int]:
    """(warps a block, ring stages, tokens a stage) of the decode kernels."""
    lib = _lib()
    info = (ctypes.c_int * 3)()
    lib.decode_launch_shape(info)
    return tuple(info)


def _lib() -> ctypes.CDLL:
    lib = _build.library("paged_attention")
    fn = lib.paged_decode_attention
    if fn.argtypes is None:
        fn.argtypes = [_P] * 9 + [_I] * 7 + [_F, _I, _F, _I, _I, _I, _I, _P]
        fn.restype = _I
        lib.decode_launch_shape.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.decode_launch_shape.restype = None
    return lib


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def paged_decode_attention_cuda(
    q: torch.Tensor,          # (B, H, D) fp32 or bf16
    k_pool: torch.Tensor,     # (P, page, KV, D) fp32, bf16 or int8
    v_pool: torch.Tensor,
    block_tab: torch.Tensor,  # (B, nmax) int32
    kv_len: torch.Tensor,     # (B,) int32
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,   # (P, KV) fp32, int8 pools
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; raises on anything it cannot take."""
    b, h, d = q.shape
    p_pages, page, kvh, dk = k_pool.shape
    tensors = [q, k_pool, v_pool, block_tab, kv_len]
    quant = k_scale is not None
    if (v_scale is not None) != quant:
        raise ValueError("k_scale/v_scale come as a pair")
    if quant:
        tensors += [k_scale, v_scale]
    if not all(t.is_cuda for t in tensors):
        raise ValueError("paged_decode_attention_cuda takes CUDA tensors")
    if dk != d or v_pool.shape != k_pool.shape or h % kvh:
        raise ValueError(f"shapes q {tuple(q.shape)} pool {tuple(k_pool.shape)}")
    if h // kvh not in (2, 4) or d > 128:
        raise ValueError(f"the kernel takes 2 or 4 query heads per kv head "
                         f"and head_dim <= 128, got {h}/{kvh} x {d}")
    if block_tab.shape[0] != b or kv_len.shape != (b,):
        raise ValueError("block_tab / kv_len rows must match the batch")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported query dtype {q.dtype}")
    if k_pool.dtype not in _DTYPE_CODE or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"unsupported pool dtype {k_pool.dtype}")
    if (k_pool.dtype == torch.int8) != quant:
        raise ValueError("int8 pools need k_scale/v_scale, others take none")
    if d * k_pool.element_size() % 16:
        raise ValueError(f"a pool row must be a multiple of 16 bytes, got "
                         f"{d} x {k_pool.element_size()}")
    lib = _lib()
    q = q.contiguous()
    k_pool = _build.aligned16(k_pool)
    v_pool = _build.aligned16(v_pool)
    tab = block_tab.to(torch.int32).contiguous()
    lens = kv_len.to(torch.int32).contiguous()
    if quant:
        k_scale = k_scale.float().contiguous()
        v_scale = v_scale.float().contiguous()
    out = torch.empty_like(q)
    scale = scale if scale is not None else d ** -0.5
    nmax = tab.shape[1]
    span = nmax * page if window is None else min(nmax * page,
                                                  int(window) + page - 1)
    splits, split_len, scratch = split_plan(q, kvh, span, page)
    err = lib.paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tab.data_ptr(),
        lens.data_ptr(), _ptr(k_scale), _ptr(v_scale), out.data_ptr(),
        _ptr(scratch), b, h, kvh, d, page, nmax, p_pages, float(scale),
        0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), splits, split_len,
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pool.dtype],
        _build.current_stream(q.device))
    _build.check(lib, err, "paged_decode_attention")
    paged_decode_attention_cuda.launches += 1
    return out


paged_decode_attention_cuda.launches = 0

__all__ = ["decode_splits", "paged_decode_attention_cuda",
           "paged_decode_attention_plain"]
