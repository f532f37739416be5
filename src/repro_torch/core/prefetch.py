"""LLM prefetching policy (paper §4.3): phase-aware queue depth.

The paper replaces FlexGen's fixed next-layer prefetch with a *queue*:
future layers stream host->device continuously, bounded only by free
memory; the queue is shallow during prefill (activations occupy memory)
and deep during decode.  The partition streamer sizes its lookahead with
the same policy.  The layer-streamed executor that runs the queue comes
with the layer-streaming slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class PrefetchPolicy:
    """Phase-aware queue depth (conservative prefill, aggressive decode)."""

    max_depth: int = 8
    prefill_depth: int = 1

    def depth(self, phase: str, free_bytes: float,
              layer_bytes: float) -> int:
        if free_bytes == float("inf"):
            cap = self.max_depth
        else:
            cap = int(free_bytes // max(layer_bytes, 1.0))
        if phase == "prefill":
            return max(1, min(self.prefill_depth, cap))
        return max(1, min(self.max_depth, cap))
