"""Assigned input shapes and applicability rules.

LM transformer shapes are ``seq_len x global_batch``.  ``decode_*`` /
``long_*`` lower ``serve_step`` (one new token against a KV cache of
``seq_len``), NOT ``train_step``.  ``long_500k`` requires sub-quadratic
attention and is skipped (with reason) for pure full-attention archs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, Optional[str]]:
    """Whether this (arch x shape) cell should be lowered.

    Returns (applicable, skip_reason).
    """
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "SKIP(full-attention): 500k decode needs sub-quadratic attention"
    return True, None
