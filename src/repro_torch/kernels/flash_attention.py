"""Flash attention (prefill): a CUDA C++ kernel for Hopper, its launch
count and its plain version.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention_pallas``:
causal GQA attention of q ``(B, Sq, H, D)`` against k, v ``(B, Sk, KV, D)``
with a per-batch ``kv_len``, a sliding window and a tanh softcap, in an
fp32 online softmax.  ``q_offset`` places query row ``i`` of batch ``b``
at ``q_offset + i``; it is an int (one-shot prefill: 0) or a ``(B,)``
tensor (chunked prefill: each row's chunk start), which the Pallas kernel
did not take.

What bounds it on the H100: operations (about 400 flops a byte at the
one-shot llama3-8b prefill), which only ``wgmma`` reaches at the tensor
cores' full rate.  The design, in ``csrc/flash_attention.cu``: each (q
head, batch, q tile) loops over the kv tiles its causal and window reach
can touch, with the softmax state in registers.  bf16 is a persistent,
warp-specialised kernel (one block an SM over the q tiles, heaviest causal
tiles first): a producer thread issues TMA loads of the q rows and of
128-key K and V tiles into a ring of 3 stages (mbarrier completion),
and one or two consumer warpgroups of 64 q rows run S = QK^T and O += PV
as ``wgmma`` (P from registers), the softmax of one tile under the PV of
the one before and under the other warpgroup's products.  fp32 runs on the CUDA cores in the JAX order of
operations.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import NEG_INF, _softcap

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = {torch.float32: (16, 128), torch.bfloat16: (16, 64, 128)}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    fn = lib.flash_attention
    if fn.argtypes is None:
        fn.argtypes = [_P] * 6 + [_I] * 7 + [_F, _I, _I, _F, _I, _P]
        fn.restype = _I
        lib.flash_attention_shape.argtypes = [_I] * 4 + [ctypes.POINTER(_I)]
        lib.flash_attention_shape.restype = None
    return lib


def launch_shape(b: int, sq: int, h: int, d: int) -> Dict[str, int]:
    """The bf16 kernel's launch for these sizes (no launch): consumer
    warpgroups, q rows a work item, ring stages, threads and dynamic
    shared bytes a block, work items (q tiles x heads x batch) and blocks
    (one an SM at most: the kernel is persistent)."""
    info = (_I * 7)()
    _lib().flash_attention_shape(b, sq, h, d, info)
    keys = ("consumers", "rows", "stages", "threads", "smem", "items",
            "blocks")
    return dict(zip(keys, info))


def flash_attention_cuda(
    q: torch.Tensor,                # (B, Sq, H, D) fp32 or bf16
    k: torch.Tensor,                # (B, Sk, KV, D), q's dtype
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    kv_len: Optional[torch.Tensor] = None,       # (B,)
    q_offset: Union[int, torch.Tensor] = 0,      # int or (B,)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; raises on anything it cannot take."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    per_row = torch.is_tensor(q_offset)
    tensors = [q, k, v] + [t for t in (kv_len, q_offset) if torch.is_tensor(t)]
    if not all(t.is_cuda for t in tensors):
        raise ValueError("flash_attention_cuda takes CUDA tensors")
    if k.shape != (b, sk, kvh, d) or v.shape != k.shape or h % kvh:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the kernel takes fp32 or bf16 q, k, v of one "
                         f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in _HEAD_DIMS[q.dtype]:
        raise ValueError(f"head_dim {d} is not built for {q.dtype} "
                         f"(built: {_HEAD_DIMS[q.dtype]})")
    if kv_len is not None and kv_len.shape != (b,):
        raise ValueError("kv_len must be (B,)")
    if per_row and q_offset.shape != (b,):
        raise ValueError("a q_offset tensor must be (B,)")
    lib = _lib()
    q, k, v = (_build.aligned16(x) for x in (q, k, v))
    lens = None if kv_len is None else kv_len.to(torch.int32).contiguous()
    offs = q_offset.to(torch.int32).contiguous() if per_row else None
    out = torch.empty_like(q)
    scale = scale if scale is not None else d ** -0.5
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if lens is None else lens.data_ptr(),
        None if offs is None else offs.data_ptr(), out.data_ptr(),
        b, sq, sk, h, kvh, d, 0 if per_row else int(q_offset), float(scale),
        int(causal), 0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), _DTYPE_CODE[q.dtype],
        _build.current_stream(q.device))
    _build.check(lib, err, "flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


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


__all__ = ["flash_attention_cuda", "flash_attention_plain"]
