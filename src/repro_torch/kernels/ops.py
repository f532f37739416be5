"""Public kernel API of the port, dispatched on the tensor's device.

Each op keeps the JAX op's signature (``repro.kernels.ops``) apart from
the TPU tiling knobs (``block_q``, ``block_n``, ``block_kv``): each
Hopper kernel picks its own tiles.  Dispatch:

* a CPU tensor goes to the plain PyTorch version;
* a CUDA tensor goes to the Hopper kernel, or the call raises;
* ``impl="ref"`` asks for the plain version on any device (the tests and
  ``chip_smoke.py`` use it to hold a kernel against its plain version).

There is no fallback: a kernel that cannot build or launch raises.

``flash_attention`` is plain PyTorch on every device: the chunked prefill
passes a per-row ``q_offset``, which the JAX package also routes to its
plain ``kv_scan`` tier.  A hand-written flash kernel with per-row offsets
replaces it in a later slice.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import topk_retrieval as tk

NEG_INF = ref.NEG_INF

# every Hopper kernel wrapper, by name; each carries a ``launches`` count
KERNELS = {
    "rmsnorm": rn.rmsnorm_triton,
    "paged_decode_attention": pa.paged_decode_attention_cuda,
    "retrieval_topk": tk.topk_cuda,
    "retrieval_topk_merge": tk.topk_merge_cuda,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _use_kernel(t: torch.Tensor, impl: Optional[str]) -> bool:
    if impl == "ref":
        return False
    if impl is not None:
        raise ValueError(f"unknown impl {impl!r} (None or 'ref')")
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


# ===========================================================================
# Flash attention (chunked prefill): plain PyTorch
# ===========================================================================

def flash_attention(
    q: torch.Tensor,                # (B, Sq, H, D)
    k: torch.Tensor,                # (B, Sk, KV, D)
    v: torch.Tensor,                # (B, Sk, KV, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    kv_len: Optional[torch.Tensor] = None,
    q_offset: Union[int, torch.Tensor] = 0,
    scale: Optional[float] = None,
    impl: Optional[str] = None,
    block_kv: int = 256,
) -> torch.Tensor:
    if impl == "ref":
        return ref.attention_reference(
            q, k, v, causal=causal, window=window, softcap=softcap,
            kv_len=kv_len, q_offset=q_offset, scale=scale)
    if impl is not None:
        raise ValueError(f"unknown attention impl {impl!r}")
    return _attention_kv_scan(
        q, k, v, causal=causal, window=window, softcap=softcap,
        kv_len=kv_len, q_offset=q_offset, scale=scale, block_kv=block_kv)


def _attention_kv_scan(q, k, v, *, causal, window, softcap, kv_len,
                       q_offset, scale, block_kv):
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
        s = ref._softcap(s, softcap)
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


# ===========================================================================
# Paged decode attention
# ===========================================================================

def paged_decode_attention(
    q: torch.Tensor,          # (B, H, D)
    k_pool: torch.Tensor,     # (P, page, KV, D)
    v_pool: torch.Tensor,     # (P, page, KV, D)
    block_tab: torch.Tensor,  # (B, nmax) int32
    kv_len: torch.Tensor,     # (B,)
    *,
    kv_span: Optional[int] = None,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,   # (P, KV) int8 dequant scales
    v_scale: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Decode attention over a paged KV cache.  ``kv_span`` truncates the
    plain version's gathered view; the kernel reads live pages only."""
    if _use_kernel(q, impl):
        return pa.paged_decode_attention_cuda(
            q, k_pool, v_pool, block_tab, kv_len, window=window,
            softcap=softcap, scale=scale, k_scale=k_scale, v_scale=v_scale)
    return pa.paged_decode_attention_plain(
        q, k_pool, v_pool, block_tab, kv_len, kv_span=kv_span, window=window,
        softcap=softcap, scale=scale, k_scale=k_scale, v_scale=v_scale)


# ===========================================================================
# Retrieval top-k and the multi-partition merge
# ===========================================================================

def retrieval_topk(
    queries: torch.Tensor,   # (Q, D)
    database: torch.Tensor,  # (N, D)
    k: int,
    *,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by inner product. Returns (scores (Q,k), indices (Q,k))."""
    if _use_kernel(database, impl):
        return tk.topk_cuda(queries, database, k)
    return tk.topk_plain(queries, database, k)


def retrieval_topk_merge(
    part_scores: torch.Tensor,   # (Q, P, k)
    part_ids: torch.Tensor,      # (Q, P, k)
    mask: torch.Tensor,          # (Q, P) bool — per-query IVF probe set
    k: int,
    *,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse per-partition scoreboards into a global top-k; masked entries
    become ``(NEG_INF, -1)`` so a pruned id never surfaces."""
    if _use_kernel(part_scores, impl):
        return tk.topk_merge_cuda(part_scores, part_ids, mask, k)
    return tk.topk_merge_plain(part_scores, part_ids, mask, k)


# ===========================================================================
# RMSNorm
# ===========================================================================

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            *, impl: Optional[str] = None) -> torch.Tensor:
    if _use_kernel(x, impl):
        return rn.rmsnorm_triton(x, w, eps)
    return rn.rmsnorm_plain(x, w, eps)
