"""Mesh context: which mesh axes carry the batch and which the model.

Ported from ``repro.sharding.specs`` (``MeshContext``, ``from_mesh``).
The mesh is a ``torch.distributed`` ``DeviceMesh``: one process per
device, its axes named.  Batch work shards over the pod and data axes
jointly (``batch_axes``); tensor-parallel dims would shard over
``model_axis``.  ``batch_group`` is the process group the batch-axis
collectives run over (the sharded retrieval's all-gather), and
``batch_rank`` this process's index along it.

The parameter partition rules of the reference (``param_pspecs``) shard
tensor-parallel weights; the port has no tensor-parallel model yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


@dataclass(frozen=True)
class MeshContext:
    mesh: DeviceMesh
    batch_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    _groups: Dict[str, dist.ProcessGroup] = field(
        default_factory=dict, init=False, repr=False, compare=False)

    def _size(self, axis: str) -> int:
        return int(self.mesh.size(self.mesh.mesh_dim_names.index(axis)))

    @property
    def dp_size(self) -> int:
        size = 1
        for a in self.batch_axes:
            size *= self._size(a)
        return size

    @property
    def tp_size(self) -> int:
        return self._size(self.model_axis)

    @property
    def all_axes(self) -> Tuple[str, ...]:
        return tuple(self.mesh.mesh_dim_names)

    def shard_tokens(self, global_batch: int) -> bool:
        return global_batch % self.dp_size == 0

    @property
    def batch_group(self) -> dist.ProcessGroup:
        """The process group spanning the batch axes (row-major over
        them when there are several, as ``jax.lax.all_gather`` orders a
        tuple of axes).  Made at first use: call it on every process."""
        if len(self.batch_axes) == 1:
            return self.mesh.get_group(self.batch_axes[0])
        if "batch" not in self._groups:
            self._groups["batch"] = self._new_batch_group()
        return self._groups["batch"]

    def _new_batch_group(self) -> dist.ProcessGroup:
        """One group for each coordinate of the other axes, over the
        ranks its batch axes span.  ``new_group`` is collective, so every
        process makes all of them, in one order, and keeps its own."""
        names = list(self.mesh.mesh_dim_names)
        dims = [names.index(a) for a in self.batch_axes]
        rest = [i for i in range(len(names)) if i not in dims]
        rows = self.mesh.mesh.permute(rest + dims).reshape(-1, self.dp_size)
        me, mine = dist.get_rank(), None
        for ranks in rows.tolist():
            # a group orders its members by global rank; the all-gather's
            # order must be the row-major one ``batch_rank`` counts in
            if ranks != sorted(ranks):
                raise ValueError(f"batch axes {self.batch_axes} of mesh "
                                 f"{names} are not row-major by rank")
            group = dist.new_group(ranks)
            if me in ranks:
                mine = group
        return mine

    @property
    def batch_rank(self) -> int:
        """This process's index along the batch axes, row-major."""
        coord = self.mesh.get_coordinate()
        names = self.mesh.mesh_dim_names
        rank = 0
        for a in self.batch_axes:
            i = names.index(a)
            rank = rank * int(self.mesh.size(i)) + int(coord[i])
        return rank


def from_mesh(mesh: DeviceMesh) -> MeshContext:
    names = tuple(mesh.mesh_dim_names)
    batch_axes = tuple(a for a in names if a in ("pod", "data")) or names[:1]
    model_axis = "model" if "model" in names else names[-1]
    return MeshContext(mesh=mesh, batch_axes=batch_axes, model_axis=model_axis)
