"""Train step factory: gradient accumulation, compression, AdamW.

The port of ``repro.training.train_loop`` without a mesh:

  1. gradients of ``model.loss_fn`` by autograd; with ``grad_accum`` > 1
     the batch splits into that many micro-batches (rows ``i * m`` to
     ``(i + 1) * m``, as the reference's reshape), each one's gradients
     summed in fp32 and averaged, as its ``lax.scan`` does (``remat`` in
     the model keeps activation memory to one layer a micro-batch);
  2. optional int8 error-feedback compression of the gradients;
  3. AdamW with fp32 master weights.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.models.model import Model
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


def make_train_step(model: Model, opt_cfg: AdamWConfig, grad_accum: int = 1,
                    compressor: Optional[GradCompressor] = None):
    """Returns ``step(params, opt_state, comp_state, batch) -> (params,
    opt_state, comp_state, metrics)``."""

    def accumulate(params, batch):
        if grad_accum == 1:
            return value_and_grad(model, params, batch)
        acc, loss_sum = None, None
        for i in range(grad_accum):
            micro = {k: v.reshape(grad_accum, -1, *v.shape[1:])[i]
                     for k, v in batch.items()}
            loss, _, grads = value_and_grad(model, params, micro)
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
            grads, comp_state = compressor.apply(grads, comp_state)
        params, opt_state, opt_mets = adamw_update(params, grads, opt_state,
                                                   opt_cfg)
        metrics = {"loss": loss, **mets, **opt_mets}
        return params, opt_state, comp_state, metrics

    return step


__all__ = ["TrainState", "make_train_step", "value_and_grad"]
