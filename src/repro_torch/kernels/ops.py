"""Public kernel API of the port, dispatched on the tensor's device.

Each op keeps the JAX op's signature (``repro.kernels.ops``) apart from
the TPU tiling knobs (``block_q``, ``block_n``, ``block_kv``): each
Hopper kernel picks its own tiles.  Dispatch:

* a CPU tensor goes to the plain PyTorch version;
* a CUDA tensor goes to the Hopper kernel, or the call raises;
* ``impl="ref"`` asks for the plain version on any device (the tests and
  ``chip_smoke.py`` use it to hold a kernel against its plain version).

There is no fallback: a kernel that cannot build or launch raises.

``flash_attention`` takes ``q_offset`` as an int (one-shot prefill) or a
per-row ``(B,)`` tensor (chunked prefill); the one Hopper kernel serves
both, where the JAX package routes per-row offsets to its plain
``kv_scan`` tier.  That tier is the port's plain version on the CPU.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import topk_retrieval as tk

NEG_INF = ref.NEG_INF

# every Hopper kernel wrapper, by name; each carries a ``launches`` count
KERNELS = {
    "rmsnorm": rn.rmsnorm_cuda,          # both forms count here
    "flash_attention": fa.flash_attention_cuda,
    "decode_attention": da.decode_attention_cuda,
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
# Flash attention (one-shot and chunked prefill)
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
    """``block_kv`` tiles the plain version's scan; the kernel picks its
    own tiles."""
    kw = dict(causal=causal, window=window, softcap=softcap, kv_len=kv_len,
              q_offset=q_offset, scale=scale)
    if _use_kernel(q, impl):
        return fa.flash_attention_cuda(q, k, v, **kw)
    return fa.flash_attention_plain(q, k, v, block_kv=block_kv, **kw)


# ===========================================================================
# Decode attention over a dense cache
# ===========================================================================

def decode_attention(
    q: torch.Tensor,        # (B, H, D)
    k_cache: torch.Tensor,  # (B, S, KV, D)
    v_cache: torch.Tensor,  # (B, S, KV, D)
    kv_len: torch.Tensor,   # (B,)
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    kw = dict(window=window, softcap=softcap, scale=scale)
    if _use_kernel(q, impl):
        return da.decode_attention_cuda(q, k_cache, v_cache, kv_len, **kw)
    return da.decode_attention_plain(q, k_cache, v_cache, kv_len, **kw)


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
        return rn.rmsnorm_cuda(x, w, eps)
    return rn.rmsnorm_plain(x, w, eps)


def add_rmsnorm(x: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6, *, impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual add fused into the norm after it: returns ``(s, y)``
    with ``s = x + r`` in x's dtype and ``y = rmsnorm(s, w, eps)``."""
    if _use_kernel(x, impl):
        return rn.add_rmsnorm_cuda(x, r, w, eps)
    return rn.add_rmsnorm_plain(x, r, w, eps)
