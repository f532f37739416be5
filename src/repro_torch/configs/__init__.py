"""Architecture config registry of the PyTorch port.

``get_config(name)`` resolves the architectures the port serves: the
attention families that the paged pool takes (dense llama, gemma2-2b's
local/global layers, gemma-7b's MHA, chatglm3-6b's QKV bias and half
RoPE, granite-moe-1b-a400m's MoE FFN), the two that only the dense cache
takes (deepseek-v2-lite-16b's MLA over a dense first layer and MoE layers
with shared experts; mamba2-370m's SSD mixers; jamba-1.5-large-398b's
hybrid of Mamba and attention mixers over dense and MoE FFNs), the two
that only ``Model`` serves (chameleon-34b's embedding inputs, which the
``StreamedExecutor`` takes too; seamless-m4t-medium's encoder-decoder with
cross attention), and the paper's llama3-70b, which the placement
contracts price.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, SSMConfig
from repro_torch.configs.shapes import (SHAPE_ORDER, SHAPES, InputShape,
                                        shape_applicable)

# the reference's order: its ten assigned archs, then the paper's 70B
_MODULES = {
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "gemma2-2b": "gemma2_2b",
    "gemma-7b": "gemma_7b",
    "llama3-8b": "llama3_8b",
    "chatglm3-6b": "chatglm3_6b",
    "mamba2-370m": "mamba2_370m",
    "chameleon-34b": "chameleon_34b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "llama3-70b": "llama3_70b",
}

ASSIGNED_ARCHS: List[str] = [k for k in _MODULES if k != "llama3-70b"]

_cache: Dict[str, ModelConfig] = {}


def get_config(name: str) -> ModelConfig:
    key = name.replace("_", "-")
    if key not in _cache:
        if key not in _MODULES:
            raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
        mod = importlib.import_module(f"repro_torch.configs.{_MODULES[key]}")
        _cache[key] = mod.CONFIG
    return _cache[key]


def all_configs() -> Dict[str, ModelConfig]:
    return {name: get_config(name) for name in _MODULES}


__all__ = [
    "ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig", "InputShape",
    "SHAPES", "SHAPE_ORDER", "shape_applicable", "get_config",
    "all_configs", "ASSIGNED_ARCHS",
]
