"""Load the JAX package's parameter tree into the port's parameter dict.

The caller turns the JAX tree into numpy first
(``jax.tree.map(np.asarray, params)``), so this module needs no JAX.
JAX stacks each position of ``layer_pattern`` on a leading repeats axis
(``blocks[j]`` leaves are ``(R, ...)``); layer ``r * len(pattern) + j``
is slice ``r`` of ``blocks[j]``.  Layouts are kept as they are:
``wq (D, H, hd)``, ``wk``/``wv (D, KV, hd)``, ``wo (H, hd, D)``,
``embed (V, D)``, ``lm_head (D, V)``, norms ``(D,)``; QKV biases
``bq (H, hd)``, ``bk``/``bv (KV, hd)``; MoE leaves ``moe.router (D, E)``
and ``moe.w_gate``/``w_up (E, D, F)``, ``moe.w_down (E, F, D)``.  Every
leaf takes ``dtype`` but the router, which stays fp32 as the reference
creates it.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


# leaves the reference keeps in fp32 whatever the model's dtype
FP32_LEAVES = ("router",)


def _to_torch(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device,
                             torch.float32 if k in FP32_LEAVES else dtype)
                for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(
        device=device, dtype=dtype)


def _unstack(tree, r: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, r) for k, v in tree.items()}
    return np.asarray(tree)[r]


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device: DeviceLike = None,
                      dtype=torch.float32) -> Dict[str, Any]:
    transformer._check_family(cfg)
    device = resolve_device(device)
    pattern = len(cfg.layer_pattern)
    reps = cfg.num_layers // pattern
    blocks = tree["blocks"]
    if len(blocks) != pattern:
        raise ValueError(f"{len(blocks)} stacked blocks for a pattern of "
                         f"{pattern}")
    layers = [_to_torch(_unstack(blocks[j], r), device, dtype)
              for r in range(reps) for j in range(pattern)]
    out = {k: _to_torch(v, device, dtype) for k, v in tree.items()
           if k != "blocks"}
    out["blocks"] = layers
    return out
