"""How one pass of the model lays its tensors over a mesh.

Torch has no GSPMD: a pass over a mesh issues its collectives itself.
A ``Layout`` is decided once a pass, from the mesh and the global batch:

* ``batch``: the batch rows split over the batch axes (when they divide;
  otherwise every batch rank holds all rows, as the reference's
  ``batch_spec`` replicates them);
* ``seq``: the residual stream between blocks split along the sequence
  over the model axis (Megatron's sequence parallelism, the reference's
  ``constrain(x, ctx, "batch", "seq", None)``).

Tensor-parallel products follow Megatron: a column-parallel product
(heads, FFN columns, vocabulary) takes its input through ``col_in`` and a
row-parallel one (``wo``, ``w_down``) gives its partial sum through
``row_out``; a computation every model rank does alike (heads that do not
divide the axis) takes ``rep_in`` and gives ``rep_out``.  Under sequence
parallelism these are the all-gather and reduce-scatter of the sequence;
without it, the identity with an all-reduced gradient and the all-reduce.
The norms run on the stream's shards, so their weights meet them through
``norm_weight``, whose gradient sums the shards' parts over the model
axis.  With one model rank each of these is the identity.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.sharding import collectives as C
from repro_torch.sharding.specs import MeshContext


@dataclass(frozen=True)
class Layout:
    ctx: MeshContext
    seq: bool                  # the stream split along the sequence
    batch: bool                # the batch rows split over the batch axes
    moe_strategy: str = "tp"   # "tp" (experts' F split) or "ep"

    @property
    def tp(self) -> int:
        return self.ctx.tp_size

    @property
    def model_group(self):
        return self.ctx.model_group

    def sharded(self, n: int) -> bool:
        """Whether a dim of ``n`` splits over the model axis (the rules'
        ``_div``, on an axis of more than one rank)."""
        return self.tp > 1 and n % self.tp == 0

    def chunk(self, n: int) -> Tuple[int, int]:
        """This model rank's ``(start, size)`` of a dim of ``n``."""
        c = n // self.tp
        return self.ctx.model_rank * c, c

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's batch rows of a global (replicated) tensor."""
        if not self.batch:
            return x
        return C.split(x, 0, self.ctx.batch_group)

    def whole_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every batch rank's rows, concatenated (no gradient)."""
        if not self.batch:
            return x
        return C.gather_into(x, 0, self.ctx.batch_group)

    def col_in(self, h: torch.Tensor) -> torch.Tensor:
        g = self.model_group
        return C.all_gather(h, 1, g) if self.seq else C.copy_to(h, g)

    def row_out(self, y: torch.Tensor) -> torch.Tensor:
        g = self.model_group
        return C.reduce_scatter(y, 1, g) if self.seq else C.all_reduce(y, g)

    def rep_in(self, h: torch.Tensor) -> torch.Tensor:
        return (C.gather_replicated(h, 1, self.model_group) if self.seq
                else h)

    def rep_out(self, y: torch.Tensor) -> torch.Tensor:
        return C.split(y, 1, self.model_group) if self.seq else y

    def norm_weight(self, w: torch.Tensor) -> torch.Tensor:
        return C.copy_to(w, self.model_group) if self.seq else w


__all__ = ["Layout"]
