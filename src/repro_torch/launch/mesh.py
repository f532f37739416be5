"""Device mesh construction.

Ported from ``repro.launch.mesh.make_mesh``.  A torch mesh spans
processes, one device each, so the default process group must exist
first: the caller starts it with ``torch.distributed.init_process_group``
and gives it its address, world size and rank.  The production meshes of
the reference (256 or 512 devices) wait for a tensor-parallel model.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` with axes named ``axes`` over every process of
    the default group, row-major by rank.  ``device_type`` is ``"cuda"``
    (NCCL) unless the caller asks for ``"cpu"`` (gloo)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes}")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device_type='cpu'")
    if not dist.is_initialized():
        raise RuntimeError("start the default process group first "
                           "(init_process_group with its address, world "
                           "size and rank)")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} processes, "
                         f"the group has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)
