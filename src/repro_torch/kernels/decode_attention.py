"""Dense decode attention: a CUDA C++ kernel for Hopper, its launch count
and its plain version.

Replaces ``src/repro/kernels/decode_attention.py::decode_attention_pallas``:
one new token per sequence, q ``(B, H, D)``, attends over a dense
``(B, S, KV, D)`` cache masked to ``k_pos < kv_len`` and, with a window,
``k_pos >= kv_len - window``, with a tanh softcap, in an fp32 online
softmax.

What bounds it on the H100: bytes (each live K/V row read once, about 4
flops a byte in bf16).  The design, in ``csrc/decode_attention.cu``: the
paged kernel's split-K device code (``csrc/decode_tiles.cuh``) with the
row address ``b * S + t`` in place of the block-table lookup: blocks over
(kv head, sequence, split) stage the live rows of their split through a
``cp.async`` ring, and a second kernel merges the splits in a fixed
order.  The split count comes from ``S`` (and the window), on the host.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import split_plan
from repro_torch.kernels.ref import NEG_INF, _softcap

# a dense cache's splits are made of this many tokens (two per stage unit)
DENSE_GRANULE = 16

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.library("decode_attention")
    fn = lib.decode_attention
    if fn.argtypes is None:
        fn.argtypes = [_P] * 6 + [_I] * 5 + [_F, _I, _F, _I, _I, _I, _I, _P]
        fn.restype = _I
    return lib


def decode_attention_cuda(
    q: torch.Tensor,          # (B, H, D) fp32 or bf16
    k_cache: torch.Tensor,    # (B, S, KV, D) fp32 or bf16
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,     # (B,)
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; raises on anything it cannot take."""
    b, h, d = q.shape
    bk, s, kvh, dk = k_cache.shape
    if not all(t.is_cuda for t in (q, k_cache, v_cache, kv_len)):
        raise ValueError("decode_attention_cuda takes CUDA tensors")
    if bk != b or dk != d or v_cache.shape != k_cache.shape or h % kvh:
        raise ValueError(f"shapes q {tuple(q.shape)} cache "
                         f"{tuple(k_cache.shape)}")
    if h // kvh not in (2, 4) or d > 128:
        raise ValueError(f"the kernel takes 2 or 4 query heads per kv head "
                         f"and head_dim <= 128, got {h}/{kvh} x {d}")
    if kv_len.shape != (b,):
        raise ValueError("kv_len must be (B,)")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported query dtype {q.dtype}")
    if k_cache.dtype not in _DTYPE_CODE or v_cache.dtype != k_cache.dtype:
        raise ValueError(f"unsupported cache dtype {k_cache.dtype}")
    if d * k_cache.element_size() % 16:
        raise ValueError(f"a cache row must be a multiple of 16 bytes, got "
                         f"{d} x {k_cache.element_size()}")
    lib = _lib()
    q = q.contiguous()
    k_cache = _build.aligned16(k_cache)
    v_cache = _build.aligned16(v_cache)
    lens = kv_len.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    scale = scale if scale is not None else d ** -0.5
    span = s if window is None else min(s, int(window))
    splits, split_len, scratch = split_plan(q, kvh, span, DENSE_GRANULE)
    err = lib.decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        b, s, h, kvh, d, float(scale),
        0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), splits, split_len,
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_cache.dtype],
        _build.current_stream(q.device))
    _build.check(lib, err, "decode_attention")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0


def decode_attention_plain(q, k_cache, v_cache, kv_len, *, window=None,
                           softcap=None, scale=None):
    """``repro``'s ``_decode_einsum``.  A bf16 cache stays bf16 into both
    products with fp32 accumulation, and the probabilities are cast to
    bf16 before PV (the JAX package's rule: without it, bf16 tokens can
    differ from the reference's); other caches compute in fp32."""
    b, s, kvh, d = k_cache.shape
    dv = v_cache.shape[-1]
    h = q.shape[1]
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    lowp = k_cache.dtype == torch.bfloat16
    q_ = q.reshape(b, kvh, g, d)
    if lowp:
        # bf16 operands, fp32 sums: a bf16 product rounds its sums to bf16
        # on the CPU, so the operands are widened exactly instead
        q_ = q_.to(torch.bfloat16).float()
        kc, vc = k_cache.float(), v_cache.float()
    else:
        q_, kc, vc = q_.float(), k_cache.float(), v_cache.float()
    scores = torch.einsum("bkgd,bskd->bkgs", q_, kc) * scale
    scores = _softcap(scores, softcap)
    k_pos = torch.arange(s, device=q.device)[None, :]
    mask = k_pos < kv_len[:, None]
    if window is not None:
        mask = mask & (k_pos >= kv_len[:, None] - window)
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    probs = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    if lowp:
        probs = probs.to(torch.bfloat16).float()
    out = torch.einsum("bkgs,bskd->bkgd", probs, vc)
    return out.reshape(b, h, dv).to(q.dtype)


__all__ = ["decode_attention_cuda", "decode_attention_plain"]
