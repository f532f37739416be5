"""Device mesh construction.

Ported from ``repro.launch.mesh``.  A torch mesh spans processes, one
device each, so the default process group must exist first: the caller
starts it with ``torch.distributed.init_process_group`` and gives it its
address, world size and rank.  ``make_production_mesh`` is the
reference's: a single pod is ``(data=16, model=16)``, 256 devices; two
pods are ``(pod=2, data=16, model=16)``, 512, where the pod axis carries
only data-parallel traffic.  Without the cards, a fake process group of
that many ranks in one process gives the same mesh
(``torch.testing._internal.distributed.fake_pg``).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The production mesh over every process of the default group,
    which must have 256 ranks (512 with ``multi_pod``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise RuntimeError(
            f"need {n} processes for mesh {shape}, the default group has "
            f"{have}: start it with world_size={n} (one process a device, "
            f"or the fake process group for a dry run)")
    return make_mesh(shape, axes, device_type=device_type)


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
