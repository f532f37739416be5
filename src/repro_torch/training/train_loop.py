"""Train step factory: gradient accumulation, compression, AdamW.

The port of ``repro.training.train_loop``:

  1. gradients of ``model.loss_fn`` by autograd; with ``grad_accum`` > 1
     the batch splits into that many micro-batches (rows ``i * m`` to
     ``(i + 1) * m``, as the reference's reshape), each one's gradients
     summed in fp32 and averaged, as its ``lax.scan`` does (``remat`` in
     the model keeps activation memory to one layer a micro-batch);
  2. optional int8 error-feedback compression of the gradients, in the
     reference's blocks: its layers are stacked by pattern position, so a
     block may span layers (``compress_global``);
  3. AdamW with fp32 master weights.

Over a mesh (the model's ``ctx``) every tree holds this rank's slices.
Each rank's gradients are its own batch rows' part, so before anything
reads them they are summed over the batch axes a leaf is not split on
(the expert leaves' split axes were reduce-scattered in the backward);
the model's collectives make every leaf whole over the model axis (the
norms, which run on the sequence's shards, through ``copy_to``).  The
compressor then sees the global gradient, as the reference's does: a
split leaf is gathered, compressed in the reference's blocks, and this
rank's slice kept.  The clipping norm sums over the mesh.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.model import Model
from repro_torch.sharding import collectives
from repro_torch.sharding.specs import (entry_axes, gather_leaf, is_spec,
                                        shard_leaf, tree_map_path)
from repro_torch.training.compression import GradCompressor
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update, tree_leaves,
                                            tree_map)


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    comp_state: Any = None

    @classmethod
    def create(cls, model: Model, seed: int = 0, dtype=torch.bfloat16,
               compressor: Optional[GradCompressor] = None
               ) -> "TrainState":
        params = model.init(seed=seed, dtype=dtype)
        return cls(params=params, opt_state=adamw_init(params),
                   comp_state=(compressor.init_state(params)
                               if compressor else None))


def value_and_grad(model: Model, params, batch: Dict[str, torch.Tensor]):
    """``(loss, metrics, grads)``: the gradients in the parameters' tree
    and dtypes (zeros for a leaf the loss does not reach)."""
    leaves = list(tree_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    with torch.enable_grad():
        loss, mets = model.loss_fn(params, batch)
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
    for t in leaves:
        t.requires_grad_(False)
    out = tree_map(lambda p: next(grads), params)
    out = tree_map(lambda p, g: torch.zeros_like(p) if g is None else g,
                   params, out)
    return (loss.detach(), {k: v.detach() for k, v in mets.items()}, out)


@torch.no_grad()
def reduce_grads(model: Model, grads, micro_batch: int):
    """Each leaf's gradient summed over the batch axes it is not split
    on, where a ``micro_batch`` of rows splits over the batch axes (each
    rank then holds its own rows' part); as it is where every batch rank
    ran all the rows."""
    ctx = model.ctx
    lay = model.layout(micro_batch, 1, "train")
    if lay is None or not lay.batch:
        return grads

    def reduce(_, spec, g):
        used = {a for e in spec for a in entry_axes(e)}
        for a in ctx.batch_axes:
            if a not in used:
                g = collectives.all_reduce(g, ctx.group(a))
        return g

    return tree_map_path(reduce, model.param_specs(), grads, is_leaf=is_spec)


def _stacked_name(path: str, cfg) -> Tuple[str, int]:
    """The reference's name for a port leaf and its index on the stacked
    leaf's repeats axis: layer ``first_k_dense + r * len(pattern) + j`` is
    repeat ``r`` of ``blocks/j`` (``prefix/i`` before ``first_k_dense``;
    an encoder's blocks alike, from 0)."""
    keys = path.split("/")
    if "blocks" not in keys:
        return path, 0
    at = keys.index("blocks")
    i, rest = int(keys[at + 1]), keys[at + 2:]
    first = cfg.first_k_dense if at == 0 else 0
    if i < first:
        return "/".join(["prefix", str(i)] + rest), 0
    r, j = divmod(i - first, len(cfg.layer_pattern))
    return "/".join(keys[:at + 1] + [str(j)] + rest), r


@torch.no_grad()
def compress_global(model: Model, compressor: GradCompressor, grads,
                    state):
    """``compressor.apply`` on the gradient as the reference holds it: its
    layers stacked by pattern position, so a block of ``block`` values may
    span layers, and whole over the mesh (a split leaf gathered with its
    error state, this rank's slices of both kept)."""
    if not compressor.enabled:
        return grads, state
    ctx, cfg = model.ctx, model.cfg
    specs = (model.param_specs() if ctx is not None
             else tree_map(lambda _: None, grads))
    whole: Dict[str, Any] = {}
    groups: Dict[str, list] = {}

    def collect(path, g, e, spec):
        if ctx is not None:
            g, e = gather_leaf(g, spec, ctx), gather_leaf(e, spec, ctx)
        whole[path] = (g, e)
        name, r = _stacked_name(path, cfg)
        groups.setdefault(name, []).append((r, path))

    tree_map_path(collect, grads, state, specs)
    out: Dict[str, Any] = {}
    for members in groups.values():
        paths = [p for _, p in sorted(members)]
        g = torch.cat([whole[p][0].reshape(-1) for p in paths])
        e = torch.cat([whole[p][1].reshape(-1) for p in paths])
        deq, err = compressor._leaf(g, e)
        at = 0
        for p in paths:
            n, shape = whole[p][0].numel(), whole[p][0].shape
            out[p] = (deq[at:at + n].reshape(shape),
                      err[at:at + n].reshape(shape))
            at += n

    def mine(path, _, spec, k):
        x = out[path][k]
        return x if ctx is None else shard_leaf(x, spec, ctx)

    return (tree_map_path(lambda p, g, s: mine(p, g, s, 0), grads, specs),
            tree_map_path(lambda p, g, s: mine(p, g, s, 1), grads, specs))


def make_train_step(model: Model, opt_cfg: AdamWConfig, grad_accum: int = 1,
                    compressor: Optional[GradCompressor] = None):
    """Returns ``step(params, opt_state, comp_state, batch) -> (params,
    opt_state, comp_state, metrics)``."""

    def accumulate(params, batch):
        if grad_accum == 1:
            loss, mets, grads = value_and_grad(model, params, batch)
            rows = batch["labels"].shape[0]
            return loss, mets, reduce_grads(model, grads, rows)
        acc, loss_sum = None, None
        for i in range(grad_accum):
            micro = {k: v.reshape(grad_accum, -1, *v.shape[1:])[i]
                     for k, v in batch.items()}
            loss, _, grads = value_and_grad(model, params, micro)
            grads = reduce_grads(model, grads, micro["labels"].shape[0])
            if acc is None:
                acc = tree_map(lambda g: g.float(), grads)
                loss_sum = loss
            else:
                acc = tree_map(lambda a, g: a.add_(g.float()), acc, grads)
                loss_sum = loss_sum + loss
            del grads
        grads = tree_map(lambda g: g / grad_accum, acc)
        loss = loss_sum / grad_accum
        return loss, {"xent": loss}, grads

    def step(params, opt_state, comp_state, batch):
        loss, mets, grads = accumulate(params, batch)
        if compressor is not None:
            grads, comp_state = compress_global(model, compressor, grads,
                                                comp_state)
        params, opt_state, opt_mets = adamw_update(
            params, grads, opt_state, opt_cfg,
            specs=None if model.ctx is None else model.param_specs(),
            ctx=model.ctx)
        metrics = {"loss": loss, **mets, **opt_mets}
        return params, opt_state, comp_state, metrics

    return step


__all__ = ["TrainState", "make_train_step", "value_and_grad",
           "reduce_grads", "compress_global"]
