"""AdamW from scratch: fp32 master weights and moments, global-norm
clipping, cosine schedule with linear warmup.

The port of ``repro.training.optimizer``, term for term, over the port's
parameter tree (nested dicts and lists of tensors).  The optimizer state
mirrors the parameters: ``{"step", "mu", "nu", "master"}``.  Where the
reference returns new arrays, ``adamw_update`` updates the state's
moments and master weights in place (so a full-width state is not held
twice) and returns the state with its new step and fresh parameters in
the parameters' dtype.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Tuple

import torch

from repro_torch.sharding import collectives
from repro_torch.sharding.specs import is_spec


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def tree_leaves(tree, is_leaf: Callable = lambda x: False
                ) -> Iterator[torch.Tensor]:
    """The tensors of a nested dict/list tree, in order."""
    if is_leaf(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v, is_leaf)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v, is_leaf)
    else:
        yield tree


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same places of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a 0-d tensor), fp32."""
    device = step.device if torch.is_tensor(step) else None
    step = _f32(step, device)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps
                                           - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params) -> Dict[str, Any]:
    leaf = next(tree_leaves(params))
    return {
        "step": torch.zeros((), dtype=torch.int32, device=leaf.device),
        "mu": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params),
        "nu": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params),
        "master": tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                           params),
    }


def global_norm(tree, specs=None, ctx=None) -> torch.Tensor:
    """The norm of every leaf together.  Over a mesh (``specs``, ``ctx``)
    each rank holds slices: the squares of the leaves split over the same
    axes are summed, then over those axes, so each element counts once
    (a replicated leaf once, not once a rank)."""
    if ctx is None:
        total = None
        for x in tree_leaves(tree):
            sq = torch.sum(torch.square(x.float()))
            total = sq if total is None else total + sq
        return torch.sqrt(total)
    by_axes: Dict[tuple, torch.Tensor] = {}
    spec_leaves = tree_leaves(specs, is_leaf=is_spec)
    for x, spec in zip(tree_leaves(tree), spec_leaves):
        axes = tuple(a for e in spec for a in ctx.live_axes(e))
        sq = torch.sum(torch.square(x.float()))
        by_axes[axes] = sq if axes not in by_axes else by_axes[axes] + sq
    total = None
    for axes, sq in by_axes.items():
        for a in axes:
            sq = collectives.all_reduce(sq, ctx.group(a))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, specs=None,
                 ctx=None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: ``(new params, state, {"grad_norm", "lr"})``.
    Over a mesh every tree holds this rank's slices, and ``specs`` and
    ``ctx`` give the clipping norm its sums over the mesh."""
    step = state["step"] + 1
    gnorm = global_norm(grads, specs, ctx)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    stepf = step.float()
    b1c = 1 - torch.pow(_f32(cfg.b1, step.device), stepf)
    b2c = 1 - torch.pow(_f32(cfg.b2, step.device), stepf)

    def upd(p, g, m, v, master):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        mhat = m / b1c
        vhat = v / b2c
        master.sub_(lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                          + cfg.weight_decay * master))
        return master.to(p.dtype, copy=True)

    new_params = tree_map(upd, params, grads, state["mu"], state["nu"],
                          state["master"])
    state = dict(state, step=step)
    return new_params, state, {"grad_norm": gnorm, "lr": lr}


__all__ = ["AdamWConfig", "schedule", "adamw_init", "global_norm",
           "adamw_update", "tree_leaves", "tree_map"]
