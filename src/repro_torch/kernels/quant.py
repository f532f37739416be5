"""Int8 KV-page quantization: quantize-on-append with per-page scales.

Ported from ``repro.kernels.quant`` (plain ``jnp`` there, plain torch
here).  Pages store symmetric int8 (``q = round(x / scale)``, ``scale =
amax / 127``, round half to even) with one fp32 scale per (page,
kv_head).  The write path keeps the reference's two invariants:

* **Monotone growth**: appending to a live page may only grow its scale
  (scatter-max); the page's earlier int8 rows are then requantized by
  ``old / new`` so their dequantized values are kept.
* **Fresh-page reset**: a write at page offset 0 is the first write of a
  page lease, so the page's stale scale is zeroed before the max.  Mid-page
  writes are not fresh and grow the live scale.

Where the reference rebuilds the whole pool (it multiplies every page by
a factor that is exactly 1.0 off the touched pages), the port updates
the tensors in place and requantizes only the pages this call can touch:
each row's block range around its positions, plus the trash page 0,
whose scale the reference zeroes on every non-fresh write.  It writes
back only those pages' codes and scales, so a swap copy that fills other
pages on a side stream at the same time is never overwritten with stale
values.  Multiplying an int8 code by 1.0 and rounding gives the code
back, so this is the reference's function, except for a page that this
call does not touch and whose scale lies in ``(0, EPS)`` (an amax below
1.3e-6): the reference shrinks that page's codes by ``scale / EPS``, the
port leaves them.  At full width the whole-pool form would allocate an
fp32 copy of every layer's pool twice a decode step;
``tests/test_torch_quant.py`` holds the two forms equal code for code.
"""
from __future__ import annotations

from typing import Tuple

import torch

EPS = 1e-8


def _touched_pages(block_tab: torch.Tensor, positions: torch.Tensor,
                   page: int) -> torch.Tensor:
    """Pages a write at ``positions`` can touch, without a device sync:
    each row's blocks from its first position's on, as many as ``S``
    positions can span (a static count), and the trash page 0.  Extra
    blocks past the write are untouched pages (their factor is 1.0) or
    the trash page; duplicates requantize to the same codes."""
    b, nmax = block_tab.shape
    span = (positions.shape[1] - 1) // page + 2
    first = positions[:, :1].long() // page
    blocks = (first + torch.arange(span, device=positions.device)).clamp_(
        max=nmax - 1)
    pages = torch.gather(block_tab.long(), 1, blocks).reshape(-1)
    return torch.cat([pages, pages.new_zeros(1)])


def paged_scatter_quant(pool: torch.Tensor, scale: torch.Tensor,
                        new: torch.Tensor, block_tab: torch.Tensor,
                        positions: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``new`` into an int8 page pool at ``positions``, in place.

    pool: (P, page, KV, D) int8; scale: (P, KV) fp32;
    new: (B, S, KV, D); block_tab: (B, nmax); positions: (B, S).
    Returns ``(pool, scale)``, the same tensors, updated.
    """
    page = pool.shape[1]
    offs = (positions % page).long()
    pages = torch.gather(block_tab.long(), 1, (positions // page).long())
    newf = new.float()
    amax = newf.abs().amax(dim=-1)                       # (B, S, KV)
    flat = pages.reshape(-1)
    fresh = offs.reshape(-1) == 0
    # fresh pages drop their previous tenant's scale; non-fresh entries
    # redirect the zeroing to the trash page (row 0)
    scale_base = scale.clone()
    scale_base[torch.where(fresh, flat, torch.zeros_like(flat))] = 0.0
    kvh = scale.shape[1]
    new_scale = scale_base.scatter_reduce(
        0, flat[:, None].expand(-1, kvh), amax.reshape(-1, kvh) / 127.0,
        "amax")
    # requantize the pages whose scale grew (factor 1.0 elsewhere)
    factor = torch.where(scale_base > 0.0,
                         scale_base / torch.clamp(new_scale, min=EPS),
                         torch.ones_like(scale_base))
    rows = _touched_pages(block_tab, positions, page)
    pool[rows] = torch.round(pool[rows].float()
                             * factor[rows][:, None, :, None]).to(torch.int8)
    sel = torch.clamp(new_scale[pages], min=EPS)         # (B, S, KV)
    q = torch.clamp(torch.round(newf / sel[..., None]), -127, 127)
    pool[pages, offs] = q.to(torch.int8)
    # only the touched rows go back: a swap copy on another stream may be
    # writing the scales of pages outside them
    scale[rows] = new_scale[rows]
    return pool, scale


def quantize_rows(pool: torch.Tensor, scale: torch.Tensor, row: torch.Tensor,
                  pages: torch.Tensor, offs: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize a dense batch=1 prefill row into int8 pool pages, in place.

    Used by the one-shot prefill scatter: every touched page is written
    from offset 0 (fresh), so touched pages' scales are reset, then set,
    and no other page is requantized.

    pool: (P, page, KV, D) int8; scale: (P, KV) fp32;
    row: (1, L, KV, D) dense row cache (L == len(pages));
    pages/offs: (L,) flat page ids / in-page offsets.
    Returns ``(pool, scale)``, the same tensors, updated.
    """
    pages = pages.long()
    r = row[0].float()
    amax = r.abs().amax(dim=-1)                          # (L, KV)
    scale[pages] = 0.0
    scale.scatter_reduce_(0, pages[:, None].expand(-1, scale.shape[1]),
                          amax / 127.0, "amax")
    sel = torch.clamp(scale[pages], min=EPS)             # (L, KV)
    q = torch.clamp(torch.round(r / sel[..., None]), -127, 127)
    pool[pages, offs.long()] = q.to(torch.int8)
    return pool, scale
