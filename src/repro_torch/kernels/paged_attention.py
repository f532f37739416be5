"""Paged decode attention: a CUDA C++ kernel for Hopper, its launch count
and its plain version.

Replaces ``src/repro/kernels/paged_attention.py::paged_decode_attention_pallas``:
one new token per sequence attends over a KV cache stored as pooled
``(P, page, KV, D)`` pages, routed through a ``(B, nmax)`` block table,
with an optional sliding window and tanh softcap, in an fp32 online
softmax.  Int8 pools carry ``(P, KV)`` fp32 scales and are dequantized
inside the kernel.

What bounds it on the H100: bytes (every live K/V row is read once, at
about 4 flops a byte in bf16).  The design, in
``csrc/paged_attention.cu``: one block per (kv head, slot) covering the
G query heads that share the kv head; its warps take tiles of the
slot's live tokens in turn, reduce a tile's (token, head) scores in one
scattering warp butterfly, keep their own fp32 online softmax in
registers, and merge their states once through shared memory.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import \
    paged_decode_attention_reference as paged_decode_attention_plain

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.library("paged_attention")
    fn = lib.paged_decode_attention
    if fn.argtypes is None:
        fn.argtypes = [_P] * 8 + [_I] * 7 + [_F, _I, _F, _I, _I, _P]
        fn.restype = _I
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
    lib = _lib()
    q = q.contiguous()
    k_pool = k_pool.contiguous()
    v_pool = v_pool.contiguous()
    tab = block_tab.to(torch.int32).contiguous()
    lens = kv_len.to(torch.int32).contiguous()
    if quant:
        k_scale = k_scale.float().contiguous()
        v_scale = v_scale.float().contiguous()
    out = torch.empty_like(q)
    scale = scale if scale is not None else d ** -0.5
    err = lib.paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tab.data_ptr(),
        lens.data_ptr(), _ptr(k_scale), _ptr(v_scale), out.data_ptr(),
        b, h, kvh, d, page, tab.shape[1], p_pages, float(scale),
        0 if window is None else int(window),
        0.0 if softcap is None else float(softcap),
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pool.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "paged_decode_attention")
    paged_decode_attention_cuda.launches += 1
    return out


paged_decode_attention_cuda.launches = 0

__all__ = ["paged_decode_attention_cuda", "paged_decode_attention_plain"]
