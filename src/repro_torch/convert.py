"""Load the JAX package's parameter tree into the port's parameter dict,
and the way back (``params_to_numpy``).

The caller turns the JAX tree into numpy first
(``jax.tree.map(np.asarray, params)``), so this module needs no JAX.
JAX keeps the first ``first_k_dense`` layers apart (``prefix``, a list
of unstacked layers) and stacks each position of ``layer_pattern`` of the
rest on a leading repeats axis (``blocks[j]`` leaves are ``(R, ...)``,
``R = (num_layers - first_k_dense) / len(pattern)``); the port's flat
``blocks`` list is the prefix, then slice ``r`` of ``blocks[j]`` as layer
``first_k_dense + r * len(pattern) + j``.  Layouts are kept as they are:
``wq (D, H, hd)``, ``wk``/``wv (D, KV, hd)``, ``wo (H, hd, D)``,
``embed (V, D)``, ``lm_head (D, V)``, norms ``(D,)``; QKV biases
``bq (H, hd)``, ``bk``/``bv (KV, hd)``; MoE leaves ``moe.router (D, E)``,
``moe.w_gate``/``w_up (E, D, F)``, ``moe.w_down (E, F, D)`` and the
shared experts' MLP ``moe.shared.w_gate``/``w_up (D, F_sh)``,
``w_down (F_sh, D)``; MLA leaves ``mla.w_dkv (D, r)``, ``mla.w_krope
(D, rd)``, ``mla.norm_kv (r,)``, ``mla.w_uk (r, H, nope)``, ``mla.w_uv
(r, H, vd)``, ``mla.wq (D, H, nope + rd)``, ``mla.wo (H, vd, D)``; Mamba
leaves as ``models/ssm.py`` names them.  An encoder-decoder's decoder
layers carry ``norm_cross`` and ``cross`` (``wq``/``wk``/``wv``/``wo`` as
above), and its ``encoder`` holds ``blocks`` stacked the same way (no
prefix) and ``final_norm``; the ``embed`` frontend's tree has no
``embed``.  Every leaf takes ``dtype`` but
the router and Mamba's ``A_log``, ``dt_bias`` and ``D``, which stay fp32
as the reference creates them.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


# leaves the reference keeps in fp32 whatever the model's dtype
FP32_LEAVES = ("router", "A_log", "dt_bias", "D")


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


def _unstack_layers(blocks, reps: int, device, dtype):
    """Slice ``r`` of each stacked ``blocks[j]`` as layer ``r * len(blocks)
    + j``."""
    return [_to_torch(_unstack(blocks[j], r), device, dtype)
            for r in range(reps) for j in range(len(blocks))]


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device: DeviceLike = None,
                      dtype=torch.float32) -> Dict[str, Any]:
    transformer._check_family(cfg)
    device = resolve_device(device)
    pattern = len(cfg.layer_pattern)
    reps = (cfg.num_layers - cfg.first_k_dense) // pattern
    blocks, prefix = tree["blocks"], tree.get("prefix", [])
    if len(blocks) != pattern or len(prefix) != cfg.first_k_dense:
        raise ValueError(f"{len(blocks)} stacked blocks and {len(prefix)} "
                         f"prefix layers for a pattern of {pattern} and "
                         f"first_k_dense={cfg.first_k_dense}")
    layers = [_to_torch(lp, device, dtype) for lp in prefix]
    layers += _unstack_layers(blocks, reps, device, dtype)
    out = {k: _to_torch(v, device, dtype) for k, v in tree.items()
           if k not in ("blocks", "prefix", "encoder")}
    out["blocks"] = layers
    if cfg.encdec:
        enc = tree["encoder"]
        out["encoder"] = {
            "blocks": _unstack_layers(enc["blocks"],
                                      cfg.num_encoder_layers // pattern,
                                      device, dtype),
            "final_norm": _to_torch(enc["final_norm"], device, dtype)}
    return out


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.detach().float().cpu().numpy()


def _restack(layers, pattern: int):
    """The port's flat layers back onto the reference's stacks:
    ``blocks[j]`` holds layers ``j, j + pattern, ...`` on a leading axis."""
    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)
    return [stack(layers[j::pattern]) for j in range(pattern)]


def params_to_numpy(params: Dict[str, Any],
                    cfg: ModelConfig) -> Dict[str, Any]:
    """The port's parameter tree (or a tree of the same shape: gradients,
    optimizer moments) as numpy fp32 in the JAX package's layout: the
    ``first_k_dense`` layers as ``prefix``, the rest restacked on each
    pattern position's repeats axis (an encoder's blocks too).  The
    inverse of ``params_from_numpy`` up to dtype."""
    transformer._check_family(cfg)
    pattern = len(cfg.layer_pattern)
    layers = [_to_numpy(lp) for lp in params["blocks"]]
    out = {k: _to_numpy(v) for k, v in params.items()
           if k not in ("blocks", "encoder")}
    if cfg.first_k_dense:
        out["prefix"] = layers[:cfg.first_k_dense]
    out["blocks"] = _restack(layers[cfg.first_k_dense:], pattern)
    if cfg.encdec:
        enc = params["encoder"]
        out["encoder"] = {
            "blocks": _restack([_to_numpy(lp) for lp in enc["blocks"]],
                               pattern),
            "final_norm": _to_numpy(enc["final_norm"])}
    return out
