"""Checkpointing: atomic writes, retention, shard-aware, leaf-checked.

The port of ``repro.training.checkpoint`` in its layout,
``<dir>/step_<n>/shard_<i>.ckpt`` plus ``meta.json``, written to a
``.tmp`` directory and renamed, so a crash mid-save never corrupts the
newest complete step; ``keep`` steps are retained; restore checks each
leaf's shape against a template.  The reference encodes with msgpack and
zstd, which the card's machine lacks: a shard here is ``torch.save`` of
``{"magic", "step", "arrays": {path: CPU tensor}}``, loaded with
``weights_only=True``.  A leaf's path joins its dict keys and list
indices with ``/``, as the reference names them.

Over a mesh each process saves its own slices as ``shard_<rank>`` with
``num_shards`` the world, into one step directory: every shard is
written into the ``.tmp`` directory, then (``barrier`` given) shard 0
alone writes ``meta.json`` and renames it once all are in.  Each process
loads its own shard back.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

_MAGIC = "repro-ckpt-v1"


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _flatten(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def _unflatten(template, leaves: Dict[str, Any], prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, f"{prefix}/{k}" if prefix else k)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten(v, leaves, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(template))
    return leaves[prefix]


def save_checkpoint(directory: str, step: int, tree,
                    shard_id: int = 0, num_shards: int = 1,
                    keep: int = 3, extra: Optional[Dict] = None,
                    barrier: Optional[Callable[[], None]] = None) -> str:
    """Write ``tree`` as shard ``shard_id`` of step ``step``.  With
    several shards, every process calls this with its own and the same
    ``barrier`` (``torch.distributed.barrier``): the step directory
    appears, whole, once every shard is in."""
    if num_shards > 1 and barrier is None:
        raise ValueError("a checkpoint of several shards needs a barrier")
    step_dir = os.path.join(directory, f"step_{step:08d}")
    tmp_dir = step_dir + ".tmp"
    os.makedirs(tmp_dir, exist_ok=True)
    arrays = {k: torch.as_tensor(v).detach().cpu()
              for k, v in _flatten(tree)}
    torch.save({"magic": _MAGIC, "step": step, "arrays": arrays},
               os.path.join(tmp_dir, f"shard_{shard_id:04d}.ckpt"))
    if barrier is not None:
        barrier()
    if shard_id == 0:
        meta = {"step": step, "num_shards": num_shards,
                "extra": extra or {}, "magic": _MAGIC}
        with open(os.path.join(tmp_dir, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(step_dir):
            shutil.rmtree(step_dir)
        os.rename(tmp_dir, step_dir)
        _apply_retention(directory, keep)
    if barrier is not None:
        barrier()
    return step_dir


def _apply_retention(directory: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(directory, d, "meta.json"))]
    return max(steps) if steps else None


def load_checkpoint(directory: str, template, step: Optional[int] = None,
                    shard_id: int = 0):
    """Restore into the structure of ``template``: each leaf checked for
    its shape and cast to the template leaf's dtype on its device.
    Returns ``(tree, step)``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    step_dir = os.path.join(directory, f"step_{step:08d}")
    payload = torch.load(os.path.join(step_dir, f"shard_{shard_id:04d}.ckpt"),
                         weights_only=True)
    if payload.get("magic") != _MAGIC:
        raise ValueError(f"{step_dir}: not a checkpoint of this format")
    arrays = payload["arrays"]
    leaves = {}
    for key, want in _flatten(template):
        arr = arrays[key]
        want = torch.as_tensor(want)
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"{key}: {tuple(arr.shape)} != "
                             f"{tuple(want.shape)}")
        leaves[key] = arr.to(device=want.device, dtype=want.dtype)
    return _unflatten(template, leaves), step


__all__ = ["save_checkpoint", "latest_step", "load_checkpoint"]
