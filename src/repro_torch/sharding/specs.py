"""Sharding rules: which mesh axes hold which dims of every parameter.

Ported from ``repro.sharding.specs``.  The mesh is a ``torch.distributed``
``DeviceMesh``: one process per device, its axes named.  Batch work
shards over the pod and data axes jointly (``batch_axes``);
tensor-parallel dims (attention heads, FFN columns, the experts' hidden
dim, the vocabulary) shard over ``model_axis``.  A dim that does not
divide by its axis is left replicated (gemma2-2b's 8 heads on a 16-wide
model axis).

Torch has no GSPMD, so a spec is carried out by hand: each process holds
the slice of every leaf that its coordinates pick (``shard_params``), and
``gather_params`` puts the whole leaves back together.  The rules are the
reference's, rule for rule (``param_pspecs``, ``shard_extra_dim``,
``logical_to_pspec``), over the port's tree, whose layers are a flat
list: a spec here is the reference's for the same leaf without the
leading ``None`` of its stacked (scanned) layers.

``batch_group`` is the process group the batch-axis collectives run over
and ``batch_rank`` this process's index along it; ``group(axis)`` is one
axis's group and ``axes_group(axes)`` the group over several, each made
at first use on every process in the same order.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.sharding import collectives

Entry = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """A leaf's layout over the mesh: one entry a dim, each ``None``
    (whole), an axis name, or a tuple of names (the dim split over their
    product, row-major).  Dims past the entries are whole."""

    def __new__(cls, *entries: Entry):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def entry_axes(entry: Entry) -> Tuple[str, ...]:
    """The axis names of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclass(frozen=True)
class MeshContext:
    mesh: DeviceMesh
    batch_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    _groups: Dict[Tuple[str, ...], dist.ProcessGroup] = field(
        default_factory=dict, init=False, repr=False, compare=False)

    def axis_size(self, axis: str) -> int:
        return int(self.mesh.size(self.mesh.mesh_dim_names.index(axis)))

    def axes_size(self, axes: Sequence[str]) -> int:
        return math.prod(self.axis_size(a) for a in axes)

    @property
    def dp_size(self) -> int:
        return self.axes_size(self.batch_axes)

    @property
    def tp_size(self) -> int:
        return self.axis_size(self.model_axis)

    @property
    def all_axes(self) -> Tuple[str, ...]:
        return tuple(self.mesh.mesh_dim_names)

    def shard_tokens(self, global_batch: int) -> bool:
        return global_batch % self.dp_size == 0

    def group(self, axis: str) -> dist.ProcessGroup:
        """The process group along one axis (its ranks in coordinate
        order)."""
        return self.mesh.get_group(axis)

    @property
    def model_group(self) -> dist.ProcessGroup:
        return self.group(self.model_axis)

    @property
    def batch_group(self) -> dist.ProcessGroup:
        """The process group spanning the batch axes (row-major over
        them when there are several, as ``jax.lax.all_gather`` orders a
        tuple of axes).  Made at first use: call it on every process."""
        return self.axes_group(self.batch_axes)

    def axes_group(self, axes: Sequence[str]) -> dist.ProcessGroup:
        """The process group spanning ``axes``, row-major over them."""
        axes = tuple(axes)
        if len(axes) == 1:
            return self.group(axes[0])
        if axes not in self._groups:
            self._groups[axes] = self._new_group(axes)
        return self._groups[axes]

    def _new_group(self, axes: Tuple[str, ...]) -> dist.ProcessGroup:
        """One group for each coordinate of the other axes, over the
        ranks ``axes`` span.  ``new_group`` is collective, so every
        process makes all of them, in one order, and keeps its own."""
        names = list(self.mesh.mesh_dim_names)
        dims = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in dims]
        rows = self.mesh.mesh.permute(rest + dims).reshape(
            -1, self.axes_size(axes))
        me, mine = dist.get_rank(), None
        for ranks in rows.tolist():
            # a group orders its members by global rank; a gather's order
            # must be the row-major one ``axes_rank`` counts in
            if ranks != sorted(ranks):
                raise ValueError(f"axes {axes} of mesh {names} are not "
                                 f"row-major by rank")
            group = dist.new_group(ranks)
            if me in ranks:
                mine = group
        return mine

    def axis_rank(self, axis: str) -> int:
        return int(self.mesh.get_coordinate()[
            self.mesh.mesh_dim_names.index(axis)])

    def axes_rank(self, axes: Sequence[str]) -> int:
        """This process's index along ``axes``, row-major."""
        rank = 0
        for a in axes:
            rank = rank * self.axis_size(a) + self.axis_rank(a)
        return rank

    @property
    def batch_rank(self) -> int:
        return self.axes_rank(self.batch_axes)

    @property
    def model_rank(self) -> int:
        return self.axis_rank(self.model_axis)

    def live_axes(self, entry: Entry) -> Tuple[str, ...]:
        """The axes of ``entry`` that split anything (size above 1)."""
        return tuple(a for a in entry_axes(entry) if self.axis_size(a) > 1)


def from_mesh(mesh: DeviceMesh) -> MeshContext:
    names = tuple(mesh.mesh_dim_names)
    batch_axes = tuple(a for a in names if a in ("pod", "data")) or names[:1]
    model_axis = "model" if "model" in names else names[-1]
    return MeshContext(mesh=mesh, batch_axes=batch_axes, model_axis=model_axis)


def _div(n: int, d: int) -> bool:
    return n % d == 0


# ---------------------------------------------------------------------------
# Parameter partition rules (matched on the leaf's path)
# ---------------------------------------------------------------------------

def _pspec_for(name: str, shape: Tuple[int, ...],
               ctx: MeshContext) -> PartitionSpec:
    """The reference's rule for the leaf ``name`` of (unstacked)
    ``shape``."""
    tp, m = ctx.tp_size, ctx.model_axis
    body = shape

    def expert_axes(e: int) -> Entry:
        """FSDP-style expert-dim sharding over the batch axes (ZeRO for
        expert weights and their optimizer moments); the MoE all-gathers
        them on use."""
        if e % ctx.dp_size == 0:
            return ctx.batch_axes
        for ax in ctx.batch_axes[::-1]:
            if e % ctx.axis_size(ax) == 0:
                return ax
        return None

    # embeddings / heads
    if name.endswith("embed"):
        return P(m if _div(body[0], tp) else None, None)
    if name.endswith("lm_head"):
        return P(None, m if _div(body[1], tp) else None)
    # attention
    if re.search(r"(wq|wk|wv)$", name):
        return P(None, m if _div(body[1], tp) else None, None)
    if re.search(r"(bq|bk|bv)$", name):
        return P(m if _div(body[0], tp) else None, None)
    if name.endswith("wo"):
        return P(m if _div(body[0], tp) else None, None, None)
    # MLA
    if re.search(r"(w_uk|w_uv)$", name):
        return P(None, m if _div(body[1], tp) else None, None)
    if re.search(r"(w_dkv|w_krope)$", name):
        return P(None, None)
    # dense FFN
    if re.search(r"(w_gate|w_up)$", name) and len(body) == 2:
        return P(None, m if _div(body[1], tp) else None)
    if name.endswith("w_down") and len(body) == 2:
        return P(m if _div(body[0], tp) else None, None)
    # MoE expert weights (E, D, F) / (E, F, D)
    if re.search(r"(w_gate|w_up)$", name) and len(body) == 3:
        return P(expert_axes(body[0]), None,
                 m if _div(body[2], tp) else None)
    if name.endswith("w_down") and len(body) == 3:
        return P(expert_axes(body[0]), m if _div(body[1], tp) else None,
                 None)
    if name.endswith("router"):
        return P(None, None)
    # mamba
    if re.search(r"(in_z|in_x|in_dt)$", name):
        return P(None, m if _div(body[1], tp) else None)
    if name.endswith("in_bc"):
        return P(None, None)
    if re.search(r"(conv_x_w)$", name):
        return P(m if _div(body[0], tp) else None, None)
    if re.search(r"(conv_x_b|gate_norm)$", name):
        return P(m if _div(body[0], tp) else None)
    if name.endswith("out_proj"):
        return P(m if _div(body[0], tp) else None, None)
    # norms, scalars, everything else: replicated
    return P(*(None,) * len(body))


def tree_map_path(fn: Callable, tree, *rest, path: str = "",
                  is_leaf: Callable = lambda x: False):
    """``fn(path, leaf, *others)`` over a tree of dicts and lists, the
    path its keys and indices joined with ``/`` (the reference's names);
    ``is_leaf`` stops the descent early (a ``PartitionSpec`` is a
    tuple)."""
    if not is_leaf(tree):
        if isinstance(tree, dict):
            return {k: tree_map_path(
                fn, v, *(r[k] for r in rest),
                path=f"{path}/{k}" if path else str(k), is_leaf=is_leaf)
                for k, v in tree.items()}
        if isinstance(tree, (list, tuple)) and not isinstance(
                tree, PartitionSpec):
            return type(tree)(tree_map_path(
                fn, v, *(r[i] for r in rest),
                path=f"{path}/{i}" if path else str(i), is_leaf=is_leaf)
                for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape if hasattr(leaf, "shape") else leaf)


def param_pspecs(param_shapes, ctx: Optional[MeshContext]):
    """A ``PartitionSpec`` for every leaf of a parameter tree (tensors,
    meta tensors or shapes), by the leaf's path."""
    if ctx is None:
        return tree_map_path(lambda _, leaf: P(), param_shapes)
    return tree_map_path(lambda name, leaf: _pspec_for(name, _shape(leaf),
                                                       ctx), param_shapes)


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def shard_extra_dim(pspecs, param_shapes, ctx: MeshContext):
    """ZeRO/FSDP transform: additionally shard each leaf's first free
    (unsharded, divisible) dim over the batch axes that leaf does not use
    yet; where their product does not divide, over one of them."""
    def visit(_, spec, leaf):
        shape = _shape(leaf)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        used = {a for entry in parts for a in entry_axes(entry)}
        free = tuple(a for a in ctx.batch_axes if a not in used)
        if not free:
            return spec
        size = ctx.axes_size(free)
        for i, (ax, n) in enumerate(zip(parts, shape)):
            if ax is None and n % size == 0 and n > 0:
                parts[i] = free
                return P(*parts)
        for a in free:
            sz = ctx.axis_size(a)
            for i, (ax, n) in enumerate(zip(parts, shape)):
                if ax is None and n % sz == 0 and n > 0:
                    parts[i] = (a,)
                    return P(*parts)
        return spec

    return tree_map_path(visit, pspecs, param_shapes, is_leaf=is_spec)


def logical_to_pspec(ctx: Optional[MeshContext], *logical) -> PartitionSpec:
    """Logical activation axes (``"batch"``, ``"model"``, ``"seq"``,
    None) to a spec; ``"seq"`` is Megatron-style sequence parallelism,
    the activations between blocks split over the model axis."""
    if ctx is None:
        return P()
    out = []
    for ax in logical:
        if ax == "batch":
            out.append(ctx.batch_axes)
        elif ax in ("model", "seq"):
            out.append(ctx.model_axis)
        else:
            out.append(None)
    return P(*out)


# ---------------------------------------------------------------------------
# Carrying a spec out: slices, whole leaves, layout changes
# ---------------------------------------------------------------------------

def _dims(spec: PartitionSpec, ctx: MeshContext):
    """``(dim, axes)`` for each dim a spec splits over live axes."""
    return [(i, ctx.live_axes(e)) for i, e in enumerate(spec)
            if ctx.live_axes(e)]


def shard_leaf(x: torch.Tensor, spec: PartitionSpec,
               ctx: MeshContext) -> torch.Tensor:
    """This process's slice of the whole leaf ``x`` (a copy where it is
    a part, ``x`` itself where the spec splits nothing)."""
    dims = _dims(spec, ctx)
    for i, axes in dims:
        n = ctx.axes_size(axes)
        if x.shape[i] % n:
            raise ValueError(f"dim {i} of {tuple(x.shape)} does not split "
                             f"over {axes} ({n})")
        chunk = x.shape[i] // n
        x = x.narrow(i, ctx.axes_rank(axes) * chunk, chunk)
    return x.clone() if dims else x


def gather_leaf(x: torch.Tensor, spec: PartitionSpec,
                ctx: MeshContext) -> torch.Tensor:
    """The whole leaf from every process's slice ``x`` (collective over
    the axes the spec splits)."""
    for i, axes in _dims(spec, ctx):
        x = collectives.gather_into(x, i, ctx.axes_group(axes))
    return x


def shard_params(params, specs, ctx: MeshContext):
    """Each leaf's slice for this process: ``device_put`` with a
    ``NamedSharding``, seen from one process."""
    return tree_map_path(lambda _, x, s: shard_leaf(x, s, ctx), params,
                         specs)


def gather_params(params, specs, ctx: MeshContext):
    """The whole leaves from every process's slices (collective)."""
    return tree_map_path(lambda _, x, s: gather_leaf(x, s, ctx), params,
                         specs)


def constrain(x: torch.Tensor, ctx: Optional[MeshContext], have, want
              ) -> torch.Tensor:
    """Carry ``x`` from the layout of the logical axes ``have`` to that of
    ``want`` (tuples of ``"batch"``, ``"seq"``, ``"model"``, None): the
    reference's ``with_sharding_constraint``, where a layout change is a
    collective.  Only the sequence moves, over the model axis (gathered or
    split); nothing happens where the layout already holds.  Outside
    autograd: a differentiable change goes through
    ``sharding.collectives``."""
    if ctx is None or tuple(have) == tuple(want):
        return x
    moved = [i for i, (a, b) in enumerate(zip(have, want)) if a != b]
    if any(have[i] not in ("seq", None) or want[i] not in ("seq", None)
           for i in moved):
        raise NotImplementedError(f"layout change {have} -> {want}")
    for i in moved:
        if want[i] is None:
            x = collectives.gather_into(x, i, ctx.model_group)
        else:
            x = collectives.take_chunk(x, i, ctx.model_group)
    return x
