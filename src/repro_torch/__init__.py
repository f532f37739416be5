"""RAGDoll serving path ported to PyTorch and hand-written Hopper kernels.

The JAX package ``repro`` is the reference; this package keeps its module
layout and public names.  Entry points run on the CUDA device unless the
caller passes ``device="cpu"`` (see :func:`resolve_device`).
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless asked otherwise.

    Raises when CUDA is requested (explicitly or by default) and absent, so
    nothing silently runs on the CPU in place of the card.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


__all__ = ["resolve_device"]
