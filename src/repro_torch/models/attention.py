"""GQA attention on a dense or a paged KV cache.

The branches of ``repro.models.attention.attention_forward`` that the
serving paths run (``mixer="attn"``/``"local"``):

* ``mode="prefill"``, ``pos=None``: one-shot prefill of a whole prompt at
  positions ``0..S-1``; its KV lands in ``cache[:, :S]`` of a dense
  ``(B, S_cache, KV, hd)`` cache and it attends causally over itself;
* ``mode="prefill"`` with per-row ``pos`` and a block table: a prompt
  chunk at positions ``[pos, pos + S)`` writes its KV into the pool and
  attends over the pages written so far, gathered to a dense view of
  ``kv_span`` tokens;
* ``mode="decode"``: one token per row writes its KV at ``pos`` and
  attends over the dense cache (``ops.decode_attention``) or, with a
  block table, through the pool (``ops.paged_decode_attention``).

An int8 pool (``cache`` has ``k_scale``/``v_scale`` leaves of ``(P, KV)``
fp32) quantizes on append (``kernels/quant.py``); chunked prefill then
attends over the fp32 dequantized gather (the flash kernel's fp32 path,
whatever the compute type), and decode hands the scales to the paged
kernel, which dequantizes as it reads.

JAX rebuilt the cache arrays on every call; here the tensors in ``cache``
are updated in place (``_row_update``, ``_paged_scatter``).  Dense
chunked prefill (a chunk offset without a block table) is not a branch:
no generator reaches it, since chunked prefill requires the paged pool.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, quant, ref
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
    mode: str,                       # "prefill" | "decode"
    cache: dict,                     # {"k","v"}: dense (B, S_cache, KV, hd)
                                     #   or pooled (P, page, KV, hd)
    pos: Optional[torch.Tensor] = None,     # (B,) chunk offsets or decode
                                            # positions; None: one-shot
    block_tab: Optional[torch.Tensor] = None,   # (B, nmax) page ids (paged)
    kv_span: Optional[int] = None,   # dense length of the gathered view
) -> torch.Tensor:
    """Returns the attention output; ``cache`` is written in place."""
    if mixer not in ("attn", "local"):
        raise NotImplementedError(f"mixer {mixer!r}")
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(f"mode {mode!r}")
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    window = cfg.sliding_window if mixer == "local" else None
    softcap = cfg.attn_logit_softcap
    rot = int(hd * cfg.rope_fraction)
    q, k, v = _project_qkv(p, x)

    if mode == "prefill" and pos is None:
        cos, sin = layers.rope_cos_sin(torch.arange(s, device=x.device), rot,
                                       cfg.rope_theta)
        cos, sin = cos[None, :, None], sin[None, :, None]
        q = layers.apply_rope(q, cos, sin, rot)
        k = layers.apply_rope(k, cos, sin, rot)
        cache["k"][:, :s] = k.to(cache["k"].dtype)
        cache["v"][:, :s] = v.to(cache["v"].dtype)
        out = ops.flash_attention(q, k, v, causal=True, window=window,
                                  softcap=softcap)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"])

    if mode == "prefill":
        if block_tab is None:
            raise NotImplementedError(
                "chunked prefill into a dense cache: no generator reaches it")
        positions = pos[:, None] + torch.arange(s, device=x.device)  # (B,S)
        cos, sin = layers.rope_cos_sin(positions, rot, cfg.rope_theta)
        cos, sin = cos[:, :, None], sin[:, :, None]
        q = layers.apply_rope(q, cos, sin, rot)
        k = layers.apply_rope(k, cos, sin, rot)
        if "k_scale" in cache:
            # int8 pool: quantize the chunk on append, then attend over
            # the fp32 dequantized view, as the reference does: q goes to
            # fp32 (exact) for the kernel's fp32 path, and the output
            # comes back in q's type to meet ``wo``
            quant.paged_scatter_quant(cache["k"], cache["k_scale"], k,
                                      block_tab, positions)
            quant.paged_scatter_quant(cache["v"], cache["v_scale"], v,
                                      block_tab, positions)
            kd = ref.gather_paged_kv(cache["k"], block_tab, kv_span,
                                     scale=cache["k_scale"])
            vd = ref.gather_paged_kv(cache["v"], block_tab, kv_span,
                                     scale=cache["v_scale"])
            qa = q.float()
        else:
            _paged_scatter(cache["k"], k, block_tab, positions)
            _paged_scatter(cache["v"], v, block_tab, positions)
            kd = ref.gather_paged_kv(cache["k"], block_tab, kv_span)
            vd = ref.gather_paged_kv(cache["v"], block_tab, kv_span)
            qa = q
        out = ops.flash_attention(
            qa, kd, vd, causal=True, window=window, softcap=softcap,
            kv_len=pos + s, q_offset=pos).to(q.dtype)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"])

    cos, sin = layers.rope_cos_sin(pos, rot, cfg.rope_theta)   # (B, rot/2)
    cos, sin = cos[:, None, None], sin[:, None, None]
    q = layers.apply_rope(q, cos, sin, rot)
    k = layers.apply_rope(k, cos, sin, rot)
    if block_tab is None:
        _row_update(cache["k"], k, pos)
        _row_update(cache["v"], v, pos)
        out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], pos + 1,
                                   window=window, softcap=softcap)
    else:
        ks = vs = None
        if "k_scale" in cache:
            ks, vs = cache["k_scale"], cache["v_scale"]
            quant.paged_scatter_quant(cache["k"], ks, k, block_tab,
                                      pos[:, None])
            quant.paged_scatter_quant(cache["v"], vs, v, block_tab,
                                      pos[:, None])
        else:
            _paged_scatter(cache["k"], k, block_tab, pos[:, None])
            _paged_scatter(cache["v"], v, block_tab, pos[:, None])
        out = ops.paged_decode_attention(
            q[:, 0], cache["k"], cache["v"], block_tab, pos + 1,
            kv_span=kv_span, window=window, softcap=softcap,
            k_scale=ks, v_scale=vs)
    return torch.einsum("bhk,hkd->bd", out, p["wo"])[:, None]


def _row_update(cache: torch.Tensor, new: torch.Tensor,
                pos: torch.Tensor) -> None:
    """cache (B, S, ...), new (B, 1, ...), pos (B,): row b's token lands at
    ``pos[b]``, in place.  A position past the end is clamped to the last
    row, as ``jax.lax.dynamic_update_slice`` clamps its start (no
    generator writes there; checking would cost a device sync a step)."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    at = pos.long().clamp(0, cache.shape[1] - 1)
    cache[rows, at] = new[:, 0].to(cache.dtype)


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


def make_attn_cache_spec(cfg: ModelConfig, batch: int, cache_len: int,
                         dtype, kv_format: Optional[str] = None) -> dict:
    """Per-layer shapes ``{"k","v": ((batch, cache_len, KV, hd), dtype)}``
    (a paged pool: ``(pages, page, KV, hd)``).  ``kv_format="int8"``
    (paged pools only) gives int8 ``k``/``v`` and fp32 ``(pages, KV)``
    ``k_scale``/``v_scale`` leaves."""
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    if kv_format == "int8":
        sshape = (batch, cfg.num_kv_heads)
        return {"k": (shape, torch.int8), "v": (shape, torch.int8),
                "k_scale": (sshape, torch.float32),
                "v_scale": (sshape, torch.float32)}
    return {"k": (shape, dtype), "v": (shape, dtype)}
