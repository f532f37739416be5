"""RMSNorm, alone and fused with the residual add before it: a CUDA C++
kernel for Hopper, its launch count and plain versions.

Replaces ``src/repro/kernels/rmsnorm.py::rmsnorm_pallas``.

``add_rmsnorm_cuda(x, r, w)`` returns ``(s, y)`` with ``s = x + r``
(rounded to x's dtype, bit-equal to the eager add) and ``y = rmsnorm(s)``;
the layer stack uses it for every norm that follows a residual add.
``rmsnorm_cuda`` is the plain form (no residual).  Both launch one kernel
(``csrc/rmsnorm.cu``, which says what bounds it and how the design meets
that) and count under ``rmsnorm_cuda.launches``: they port the one Pallas
kernel.  The library is plain C, loaded with ``ctypes``, so a launch costs
the host one foreign call.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm_reference as rmsnorm_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def add_rmsnorm_plain(x: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                      eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    s = x + r
    return s, rmsnorm_plain(s, w, eps)


_launcher = None


def _lib() -> ctypes.CDLL:
    global _launcher
    lib = _build.library("rmsnorm")
    if _launcher is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.rmsnorm_launch.argtypes = [P] * 5 + [I, I, ctypes.c_float, I, I,
                                                  P]
        lib.rmsnorm_launch.restype = I
        _launcher = lib.rmsnorm_launch
    return lib


def _launch(x: torch.Tensor, r: Optional[torch.Tensor], w: torch.Tensor,
            eps: float, what: str) -> torch.Tensor:
    """Checks, then one launch.  Returns ``out``: (1, *x.shape) holding y,
    or (2, *x.shape) holding y then s.  Kept lean: the host sets the pace
    of a decode step, and this runs 65 times in one."""
    if not (x.is_cuda and w.is_cuda and (r is None or r.is_cuda)):
        raise ValueError(f"{what} takes CUDA tensors")
    d = x.shape[-1]
    if w.shape != (d,):
        raise ValueError(f"weight shape {tuple(w.shape)} != ({d},)")
    code = _DTYPES.get(x.dtype)
    if code is None:
        raise ValueError(f"unsupported dtype {x.dtype}")
    if r is not None and (r.shape != x.shape or r.dtype != x.dtype):
        raise ValueError(f"residual {tuple(r.shape)} {r.dtype} does not "
                         f"match x {tuple(x.shape)} {x.dtype}")
    wcode = _DTYPES.get(w.dtype)
    if wcode != 0 and wcode != code:
        w, wcode = w.float(), 0
    if _launcher is None:
        _lib()
    x = x if x.is_contiguous() else x.contiguous()
    w = w if w.is_contiguous() else w.contiguous()
    out = torch.empty((1 if r is None else 2, *x.shape), dtype=x.dtype,
                      device=x.device)
    rows = x.numel() // d if d else 0
    if rows:
        y = out.data_ptr()
        if r is None:
            r_ptr = s_ptr = None
        else:
            r = r if r.is_contiguous() else r.contiguous()
            r_ptr, s_ptr = r.data_ptr(), y + x.numel() * x.element_size()
        err = _launcher(x.data_ptr(), r_ptr, w.data_ptr(), s_ptr, y, rows, d,
                        eps, code, wcode, _build.current_stream(x.device))
        if err:
            _build.check(_lib(), err, what)
        rmsnorm_cuda.launches += 1
    return out


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """Launch the plain form on CUDA tensors; raises on what it cannot
    take."""
    return _launch(x, None, w, eps, "rmsnorm_cuda")[0]


def add_rmsnorm_cuda(x: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                     eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the fused form: ``(x + r, rmsnorm(x + r))`` in x's dtype."""
    y, s = _launch(x, r, w, eps, "add_rmsnorm_cuda").unbind(0)
    return s, y


rmsnorm_cuda.launches = 0

__all__ = ["rmsnorm_cuda", "add_rmsnorm_cuda", "rmsnorm_plain",
           "add_rmsnorm_plain"]
