"""Architecture config registry of the PyTorch port.

``get_config(name)`` resolves the architectures the port serves so far
(the dense llama family: llama3-8b on the serving paths, and the paper's
llama3-70b, which the placement contracts price).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import (SHAPE_ORDER, SHAPES, InputShape,
                                        shape_applicable)

_MODULES = {
    "llama3-8b": "llama3_8b",
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


__all__ = ["ModelConfig", "InputShape", "SHAPES", "SHAPE_ORDER",
           "shape_applicable", "get_config", "ASSIGNED_ARCHS"]
