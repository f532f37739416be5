"""GQA attention on a paged KV cache: chunked prefill and paged decode.

The two branches of ``repro.models.attention.attention_forward`` that the
paged serving path runs (``mixer="attn"``/``"local"``):

* ``mode="prefill"`` with per-row ``pos``: a prompt chunk at positions
  ``[pos, pos + S)`` writes its KV into the pool and attends over the
  pages written so far, gathered to a dense view of ``kv_span`` tokens;
* ``mode="decode"``: one token per row writes its KV and attends through
  the block table with ``ops.paged_decode_attention``.

JAX rebuilt the pool arrays on every step; here the pool tensors in
``cache`` are updated in place (``_paged_scatter``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models import layers


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype,
                   device) -> dict:
    d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    if cfg.qkv_bias:
        raise NotImplementedError("qkv bias: not in the llama family")
    return {
        "wq": layers.dense_init(gen, (d, h, hd), dtype, device, fan_in=d),
        "wk": layers.dense_init(gen, (d, kv, hd), dtype, device, fan_in=d),
        "wv": layers.dense_init(gen, (d, kv, hd), dtype, device, fan_in=d),
        "wo": layers.dense_init(gen, (h, hd, d), dtype, device,
                                fan_in=h * hd),
    }


def _project_qkv(p: dict, x: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    return q, k, v


def attention_forward(
    p: dict, x: torch.Tensor, cfg: ModelConfig, *,
    mixer: str,                      # "attn" | "local"
    mode: str,                       # "prefill" (chunked) | "decode"
    cache: dict,                     # {"k","v"} pooled (P, page, KV, hd)
    pos: torch.Tensor,               # (B,) chunk offsets or decode positions
    block_tab: torch.Tensor,         # (B, nmax) page ids
    kv_span: Optional[int] = None,   # dense length of the gathered view
) -> torch.Tensor:
    """Returns the attention output; ``cache`` is written in place."""
    if mixer not in ("attn", "local"):
        raise NotImplementedError(f"mixer {mixer!r}")
    if "k_scale" in cache:
        raise NotImplementedError("int8 KV pages: a later slice")
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    window = cfg.sliding_window if mixer == "local" else None
    rot = int(hd * cfg.rope_fraction)
    q, k, v = _project_qkv(p, x)

    if mode == "prefill":
        positions = pos[:, None] + torch.arange(s, device=x.device)  # (B,S)
        cos, sin = layers.rope_cos_sin(positions, rot, cfg.rope_theta)
        cos, sin = cos[:, :, None], sin[:, :, None]
        q = layers.apply_rope(q, cos, sin, rot)
        k = layers.apply_rope(k, cos, sin, rot)
        _paged_scatter(cache["k"], k, block_tab, positions)
        _paged_scatter(cache["v"], v, block_tab, positions)
        kd = ref.gather_paged_kv(cache["k"], block_tab, kv_span)
        vd = ref.gather_paged_kv(cache["v"], block_tab, kv_span)
        out = ops.flash_attention(
            q, kd, vd, causal=True, window=window,
            softcap=cfg.attn_logit_softcap, kv_len=pos + s, q_offset=pos)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"])

    if mode != "decode":
        raise NotImplementedError(f"mode {mode!r}: one-shot prefill and "
                                  "the dense cache come with a later slice")
    cos, sin = layers.rope_cos_sin(pos, rot, cfg.rope_theta)   # (B, rot/2)
    cos, sin = cos[:, None, None], sin[:, None, None]
    q = layers.apply_rope(q, cos, sin, rot)
    k = layers.apply_rope(k, cos, sin, rot)
    _paged_scatter(cache["k"], k, block_tab, pos[:, None])
    _paged_scatter(cache["v"], v, block_tab, pos[:, None])
    out = ops.paged_decode_attention(
        q[:, 0], cache["k"], cache["v"], block_tab, pos + 1,
        kv_span=kv_span, window=window, softcap=cfg.attn_logit_softcap)
    return torch.einsum("bhk,hkd->bd", out, p["wo"])[:, None]


def _paged_scatter(pool: torch.Tensor, new: torch.Tensor,
                   block_tab: torch.Tensor, positions: torch.Tensor) -> None:
    """pool (P, page, ...), new (B, S, ...), positions (B, S): in place.

    Writes each token's KV at ``(block_tab[b, p // page], p % page)``.
    Freed slots' tables point every block at the trash page (id 0), so
    writes from dead or still-prefilling rows never touch a live page.
    """
    page = pool.shape[1]
    pages = torch.gather(block_tab.long(), 1, (positions // page).long())
    pool[pages, (positions % page).long()] = new.to(pool.dtype)


def make_attn_cache_spec(cfg: ModelConfig, pages: int, page_size: int,
                         dtype) -> dict:
    """Per-layer pool shapes: ``{"k","v": ((pages, page, KV, hd), dtype)}``."""
    shape = (pages, page_size, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": (shape, dtype), "v": (shape, dtype)}
