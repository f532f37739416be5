"""Dense transformer on a dense or a paged KV cache (family ``dense``).

Parameters are a plain dict of tensors in the JAX package's layouts, with
``blocks`` a list of per-layer dicts (JAX stacked them on a leading
repeats axis and scanned; PyTorch runs eagerly, so the stack is a Python
loop).  Three entry points share them: ``prefill`` (whole prompts into a
dense cache), ``decode_step`` (one token per slot at per-slot positions,
dense or paged) and ``chunk_prefill_step`` (one prompt chunk at per-slot
offsets, paged).  All write the caches in place.  Each residual add is
fused into the norm that follows it (``layers.add_rms_norm``): a layer
hands its MLP output on, pending, to the next layer's first norm or the
final norm.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import LayerKind, ModelConfig
from repro_torch.models import attention, layers

Params = Dict[str, Any]


def _check_family(cfg: ModelConfig) -> None:
    kinds = {k for k, _ in cfg.layer_kinds()} | {f for _, f in cfg.layer_kinds()}
    if (cfg.family != "dense" or cfg.encdec or cfg.first_k_dense
            or kinds - {"attn", "local", "dense"}):
        raise NotImplementedError(
            f"{cfg.name}: the port serves the dense attention family so far")


def init_layer(gen: torch.Generator, cfg: ModelConfig, dtype,
               device) -> Params:
    d = cfg.d_model
    return {
        "norm1": torch.ones((d,), dtype=dtype, device=device),
        "attn": attention.init_attention(gen, cfg, dtype, device),
        "norm2": torch.ones((d,), dtype=dtype, device=device),
        "ffn": layers.init_mlp(gen, d, cfg.d_ff, cfg.mlp_kind, dtype, device),
    }


def init_params(cfg: ModelConfig, gen: torch.Generator, dtype,
                device) -> Params:
    _check_family(cfg)
    p: Params = {
        "embed": layers.embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype,
                                   device),
        "blocks": [init_layer(gen, cfg, dtype, device)
                   for _ in range(cfg.num_layers)],
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = layers.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                         dtype, device)
    return p


def apply_layer(p: Params, x: torch.Tensor, delta: Optional[torch.Tensor],
                cfg: ModelConfig, kind: LayerKind, *, mode: str, cache: dict,
                pos: Optional[torch.Tensor],
                block_tab: Optional[torch.Tensor],
                kv_span: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer on the residual stream ``x`` with the previous layer's
    output ``delta`` still to add (None before the first layer).  Each
    residual add rides in the norm after it (``add_rms_norm``), so the
    layer returns its stream and its own MLP output, pending."""
    mixer, _ = kind
    if delta is None:
        h = layers.rms_norm(x, p["norm1"], cfg.norm_eps)
    else:
        x, h = layers.add_rms_norm(x, delta, p["norm1"], cfg.norm_eps)
    a = attention.attention_forward(
        p["attn"], h, cfg, mixer=mixer, mode=mode, cache=cache, pos=pos,
        block_tab=block_tab, kv_span=kv_span)
    x, h2 = layers.add_rms_norm(x, a, p["norm2"], cfg.norm_eps)
    return x, layers.apply_mlp(p["ffn"], h2, cfg.mlp_kind)


def _run_stack(p: Params, cfg: ModelConfig, x: torch.Tensor, *, mode: str,
               caches: List[dict], pos: Optional[torch.Tensor],
               block_tab: Optional[torch.Tensor], kv_span: Optional[int]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layers over ``x``; returns the stream and the last layer's
    pending output, which the final norm adds."""
    delta = None
    for lp, kind, cache in zip(p["blocks"], cfg.layer_kinds(), caches):
        x, delta = apply_layer(lp, x, delta, cfg, kind, mode=mode,
                               cache=cache, pos=pos, block_tab=block_tab,
                               kv_span=kv_span)
    return x, delta


def _final_norm(p: Params, cfg: ModelConfig, x: torch.Tensor,
                delta: torch.Tensor) -> torch.Tensor:
    """The last layer's pending output added in the final norm."""
    return layers.add_rms_norm(x, delta, p["final_norm"], cfg.norm_eps)[1]


def _embed_inputs(p: Params, cfg: ModelConfig,
                  inputs: torch.Tensor) -> torch.Tensor:
    x = p["embed"][inputs.long()]
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def unembed(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, p["embed"])
    else:
        logits = x @ p["lm_head"]
    return layers.softcap(logits, cfg.final_logit_softcap)


def prefill(p: Params, cfg: ModelConfig, inputs: torch.Tensor,
            cache: dict) -> torch.Tensor:
    """Causal pass over whole prompts ``inputs`` (B, S) at positions
    ``0..S-1``; their KV lands in ``cache[:, :S]`` of every layer's dense
    ``(B, S_cache, KV, hd)`` cache, in place.  Returns the last-position
    logits (B, V)."""
    x = _embed_inputs(p, cfg, inputs)
    x, delta = _run_stack(p, cfg, x, mode="prefill", caches=cache["blocks"],
                          pos=None, block_tab=None, kv_span=None)
    x = _final_norm(p, cfg, x[:, -1:], delta[:, -1:])
    return unembed(p, cfg, x)[:, 0]


def decode_step(p: Params, cfg: ModelConfig, inputs: torch.Tensor,
                cache: dict, pos: torch.Tensor, *,
                block_tab: Optional[torch.Tensor] = None,
                kv_span: Optional[int] = None) -> torch.Tensor:
    """One decode step at per-slot positions ``pos`` (B,); ``inputs``
    (B, 1) token ids.  ``cache`` is dense, or pooled pages read and
    written through ``block_tab`` (B, nmax) with a ``kv_span``-token
    view.  Writes ``cache`` in place; returns logits (B, V)."""
    x = _embed_inputs(p, cfg, inputs)
    x, delta = _run_stack(p, cfg, x, mode="decode", caches=cache["blocks"],
                          pos=pos, block_tab=block_tab, kv_span=kv_span)
    x = _final_norm(p, cfg, x, delta)
    return unembed(p, cfg, x)[:, 0]


def chunk_prefill_step(p: Params, cfg: ModelConfig, inputs: torch.Tensor,
                       cache: dict, offset: torch.Tensor, *,
                       block_tab: torch.Tensor,
                       kv_span: Optional[int] = None) -> torch.Tensor:
    """Prefill one prompt chunk ``inputs`` (B, C) at per-slot start
    ``offset`` (B,).  Its KV lands at ``[offset, offset + C)``; attention
    spans the cache written so far, viewed ``kv_span`` tokens wide.
    Returns the chunk's last-position logits (B, V)."""
    x = _embed_inputs(p, cfg, inputs)
    x, delta = _run_stack(p, cfg, x, mode="prefill", caches=cache["blocks"],
                          pos=offset, block_tab=block_tab, kv_span=kv_span)
    x = _final_norm(p, cfg, x[:, -1:], delta[:, -1:])
    return unembed(p, cfg, x)[:, 0]
