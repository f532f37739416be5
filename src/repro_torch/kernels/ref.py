"""Plain PyTorch reference oracles, ported from ``repro.kernels.ref``.

Naive, materializing implementations: the semantics every kernel of the
port is held against.  Everything computes in float32 and casts back.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

NEG_INF = -1e30


def _softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, KV, D) -> (B, S, H, D) by repeating each kv head H/KV times."""
    kv = k.shape[2]
    if num_heads % kv:
        raise ValueError(f"{num_heads} heads do not group over {kv} kv heads")
    return torch.repeat_interleave(k, num_heads // kv, dim=2)


def attention_reference(
    q: torch.Tensor,               # (B, Sq, H, D)
    k: torch.Tensor,               # (B, Sk, KV, D)
    v: torch.Tensor,               # (B, Sk, KV, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    kv_len: Optional[torch.Tensor] = None,    # (B,) valid kv length
    q_offset: Union[int, torch.Tensor] = 0,   # absolute position of q[:, 0]
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Naive attention with GQA / causal / sliding-window / softcap / kv_len."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    k = repeat_kv(k, h)
    v = repeat_kv(v, h)
    scale = scale if scale is not None else d ** -0.5
    dev = q.device
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    scores = _softcap(scores, softcap)
    k_pos = torch.arange(sk, device=dev)
    if not torch.is_tensor(q_offset):
        q_pos = torch.arange(sq, device=dev)[:, None] + q_offset   # (Sq, 1)
        mask = torch.ones((sq, sk), dtype=torch.bool, device=dev)
        if causal:
            mask &= k_pos[None, :] <= q_pos
        if window is not None:
            mask &= k_pos[None, :] > q_pos - window
        mask = mask[None, None].expand(b, 1, sq, sk)
    else:                                                 # per-row (B,)
        q_pos = q_offset[:, None] + torch.arange(sq, device=dev)  # (B, Sq)
        mask = torch.ones((b, sq, sk), dtype=torch.bool, device=dev)
        if causal:
            mask &= k_pos[None, None, :] <= q_pos[:, :, None]
        if window is not None:
            mask &= k_pos[None, None, :] > q_pos[:, :, None] - window
        mask = mask[:, None]                              # (B, 1, Sq, Sk)
    if kv_len is not None:
        mask = mask & (k_pos[None, None, None, :]
                       < kv_len[:, None, None, None])
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def decode_attention_reference(
    q: torch.Tensor,        # (B, H, D) — single new token per sequence
    k_cache: torch.Tensor,  # (B, S, KV, D)
    v_cache: torch.Tensor,  # (B, S, KV, D)
    kv_len: torch.Tensor,   # (B,) valid cache entries (incl. current)
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Dense one-token attention; the window keeps ``[kv_len-window, kv_len)``."""
    b, s, _, d = k_cache.shape
    h = q.shape[1]
    scale = scale if scale is not None else d ** -0.5
    k_pos = torch.arange(s, device=q.device)[None, :]
    keep = k_pos < kv_len[:, None]
    if window is not None:
        keep &= k_pos >= (kv_len[:, None] - window)
    scores = torch.einsum("bhd,bkhd->bhk", q.float(),
                          repeat_kv(k_cache, h).float()) * scale
    scores = _softcap(scores, softcap)
    scores = torch.where(keep[:, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", probs, repeat_kv(v_cache, h).float())
    return out.to(q.dtype)


def gather_paged_kv(pool: torch.Tensor, block_tab: torch.Tensor,
                    kv_span: Optional[int] = None,
                    scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(P, page, ...) pool + (B, nmax) block table -> dense (B, S, ...).

    ``kv_span`` truncates the view to the dense cache length.  ``scale``
    dequantizes an int8 pool: a ``(P, KV)`` fp32 per-page-per-head scale
    gathered through the same table, giving an fp32 view.
    """
    b, nmax = block_tab.shape
    tab = block_tab.long()
    gathered = pool[tab]                           # (B, nmax, page, ...)
    if scale is not None:
        s = scale[tab]                             # (B, nmax, KV)
        gathered = gathered.float() * s[:, :, None, :, None]
    dense = gathered.reshape((b, nmax * pool.shape[1]) + tuple(pool.shape[2:]))
    if kv_span is not None:
        dense = dense[:, :kv_span]
    return dense


def paged_decode_attention_reference(
    q: torch.Tensor,          # (B, H, D)
    k_pool: torch.Tensor,     # (P, page, KV, D)
    v_pool: torch.Tensor,     # (P, page, KV, D)
    block_tab: torch.Tensor,  # (B, nmax)
    kv_len: torch.Tensor,     # (B,)
    *,
    kv_span: Optional[int] = None,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,   # (P, KV) int8 dequant scales
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Oracle: gather pages to the dense layout, run dense decode attention."""
    k_dense = gather_paged_kv(k_pool, block_tab, kv_span, scale=k_scale)
    v_dense = gather_paged_kv(v_pool, block_tab, kv_span, scale=v_scale)
    return decode_attention_reference(q, k_dense, v_dense, kv_len,
                                      window=window, softcap=softcap,
                                      scale=scale)


def _first_k(scores: torch.Tensor, ids: torch.Tensor, k: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` along the last axis: score descending, then lower position
    first on ties (``jax.lax.top_k``'s order; ``torch.topk`` promises no
    tie order, a stable sort does).  Fewer than ``k`` entries leave a
    ``(NEG_INF, -1)`` tail."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    order = order[..., :k]
    top_s = torch.gather(scores, -1, order)
    top_i = torch.gather(ids, -1, order)
    short = k - top_s.shape[-1]
    if short > 0:
        pad = top_s.shape[:-1] + (short,)
        top_s = torch.cat([top_s, top_s.new_full(pad, NEG_INF)], dim=-1)
        top_i = torch.cat([top_i, top_i.new_full(pad, -1)], dim=-1)
    return top_s, top_i


def topk_reference(
    queries: torch.Tensor,   # (Q, D)
    database: torch.Tensor,  # (N, D)
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k inner-product search: full matmul + ordered top-k."""
    scores = queries.float() @ database.float().T
    ids = torch.arange(database.shape[0], dtype=torch.int32,
                       device=queries.device).expand_as(scores)
    return _first_k(scores, ids, k)


def topk_merge_reference(
    part_scores: torch.Tensor,   # (Q, P, k) per-partition scoreboards
    part_ids: torch.Tensor,      # (Q, P, k) matching global chunk ids
    mask: torch.Tensor,          # (Q, P) bool — per-query IVF probe set
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse per-partition scoreboards into a global top-k.  Masked-out
    entries are forced to ``(NEG_INF, -1)`` before the merge, so a pruned
    id never surfaces; ties keep the lower flat position."""
    q, p, kk = part_scores.shape
    m = mask.bool()[:, :, None]
    s = torch.where(m, part_scores.float(),
                    torch.full_like(part_scores, NEG_INF, dtype=torch.float32))
    i = torch.where(m, part_ids.to(torch.int32),
                    torch.full_like(part_ids, -1, dtype=torch.int32))
    return _first_k(s.reshape(q, p * kk), i.reshape(q, p * kk), k)


def rmsnorm_reference(x: torch.Tensor, w: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)
