"""Gradient compression with error feedback (cross-pod DP traffic).

The port of ``repro.training.compression``: each leaf is quantized to
int8 in blocks of ``block`` values with an fp32 scale a block; the
quantization residual is carried in the compressor state and added back
at the next step (error feedback).  The dequantized gradients feed the
optimizer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch
import torch.nn.functional as F

from repro_torch.training.optimizer import tree_leaves, tree_map


@dataclass(frozen=True)
class GradCompressor:
    block: int = 256
    enabled: bool = True

    def init_state(self, params) -> Any:
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    def quantize(self, g32: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """An fp32 leaf's int8 codes ``(blocks, block)`` and fp32 scales
        ``(blocks, 1)``, the tail padded with zeros."""
        flat = g32.reshape(-1)
        fp = F.pad(flat, (0, -flat.shape[0] % self.block)).reshape(
            -1, self.block)
        scale = torch.amax(torch.abs(fp), dim=1, keepdim=True) / 127.0
        scale = torch.clamp(scale, min=1e-12)
        q = torch.clamp(torch.round(fp / scale), -127, 127).to(torch.int8)
        return q, scale

    def _leaf(self, g: torch.Tensor, err: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        g32 = g.float() + err
        q, scale = self.quantize(g32)
        deq = (q.float() * scale).reshape(-1)[:g32.numel()].reshape(g.shape)
        return deq.to(g.dtype), g32 - deq

    @torch.no_grad()
    def apply(self, grads, state) -> Tuple[Any, Any]:
        """Returns (dequantized grads, new error state)."""
        if not self.enabled:
            return grads, state
        pairs = tree_map(self._leaf, grads, state)
        return (tree_map(lambda _, pr: pr[0], grads, pairs),
                tree_map(lambda _, pr: pr[1], grads, pairs))

    def compressed_bytes(self, params) -> int:
        """DCN bytes per step with compression (int8 + f32 scale/block)."""
        total = 0
        for p in tree_leaves(params):
            n = p.numel()
            total += n + 4 * (-(-n // self.block))
        return total


__all__ = ["GradCompressor"]
