"""Model facade: init / prefill / chunk prefill / decode + cache specs."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, transformer


def make_cache_specs(cfg: ModelConfig, batch: int, cache_len: int,
                     dtype=torch.bfloat16, kv_format: Optional[str] = None
                     ) -> Dict[str, Any]:
    """Per-layer cache shapes: ``{"blocks": [{"k": (shape, dtype), "v":
    ...}] * num_layers}`` with shape ``(batch, cache_len, KV, hd)``.  The
    layout serves both caches: a dense cache has a row of ``cache_len``
    positions per sequence, the paged pool passes ``(pages, page_size)``
    (``pages`` counting the trash page 0).  ``kv_format="int8"`` (paged
    pools) adds the ``(pages, KV)`` fp32 scale leaves."""
    return {"blocks": [attention.make_attn_cache_spec(cfg, batch, cache_len,
                                                      dtype, kv_format)
                       for _ in range(cfg.num_layers)]}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device: DeviceLike = None,
               kv_format: Optional[str] = None) -> Dict[str, Any]:
    """Zeroed caches of :func:`make_cache_specs` on ``device``."""
    device = resolve_device(device)
    specs = make_cache_specs(cfg, batch, cache_len, dtype, kv_format)
    return {"blocks": [{name: torch.zeros(shape, dtype=dt, device=device)
                        for name, (shape, dt) in layer.items()}
                       for layer in specs["blocks"]]}


class Model:
    """Dense transformer entry point; parameters live outside, as in JAX.

    ``device`` defaults to CUDA and raises when it is absent; ``init``
    draws random weights from a seeded ``torch.Generator`` on it.
    """

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        transformer._check_family(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, seed: int = 0, dtype=torch.bfloat16) -> Dict[str, Any]:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return transformer.init_params(self.cfg, gen, dtype, self.device)

    def prefill(self, params, inputs, cache) -> torch.Tensor:
        return transformer.prefill(params, self.cfg, inputs, cache)

    def decode(self, params, inputs, cache, pos, block_tab=None,
               kv_span: Optional[int] = None) -> torch.Tensor:
        return transformer.decode_step(params, self.cfg, inputs, cache, pos,
                                       block_tab=block_tab, kv_span=kv_span)

    def chunk_prefill(self, params, inputs, cache, offset, block_tab,
                      kv_span: Optional[int] = None) -> torch.Tensor:
        return transformer.chunk_prefill_step(
            params, self.cfg, inputs, cache, offset, block_tab=block_tab,
            kv_span=kv_span)
