"""RMSNorm, alone and fused with the residual add before it: a CUDA C++
kernel for Hopper, its launch count and plain versions.

Replaces ``src/repro/kernels/rmsnorm.py::rmsnorm_pallas``.

``add_rmsnorm_cuda(x, r, w)`` returns ``(s, y)`` with ``s = x + r``
(rounded to x's dtype, bit-equal to the eager add) and ``y = rmsnorm(s)``;
the layer stack uses it for every norm that follows a residual add.
``rmsnorm_cuda`` is the plain form (no residual).  Both launch one kernel
(``csrc/rmsnorm.cu``, which says what bounds it and how the design meets
that) and count under ``rmsnorm_cuda.launches``: they port the one Pallas
kernel.  ``rmsnorm_bwd_cuda`` is the backward pass of both forms (training;
``rmsnorm_bwd_cuda.launches``).  The library is plain C, loaded with ``ctypes``, so a launch costs
the host one foreign call.
"""
from __future__ import annotations

import ctypes
import functools
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
_bwd_launcher = None


def _lib() -> ctypes.CDLL:
    global _launcher, _bwd_launcher
    lib = _build.library("rmsnorm")
    if _launcher is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.rmsnorm_launch.argtypes = [P] * 5 + [I, I, ctypes.c_float, I, I,
                                                  P]
        lib.rmsnorm_launch.restype = I
        lib.rmsnorm_bwd_launch.argtypes = [P] * 7 + [I, I, I, ctypes.c_float,
                                                     I, I, I, P]
        lib.rmsnorm_bwd_launch.restype = I
        lib.rmsnorm_bwd_blocks.argtypes = [I] * 4
        lib.rmsnorm_bwd_blocks.restype = I
        _bwd_launcher = lib.rmsnorm_bwd_launch
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

@functools.lru_cache(maxsize=None)
def bwd_blocks(index: int, d: int, code: int, wcode: int, vec: bool) -> int:
    """The backward row kernel's blocks on card ``index`` for rows of
    ``d`` (dtype codes of s and w; vectors of 8 or 1): the library's
    answer, as many as the card holds at once, at most 4 an SM.  The dw
    partial has this many rows."""
    with torch.cuda.device(index):
        n = _lib().rmsnorm_bwd_blocks(d, code, wcode, int(vec))
    if n <= 0:
        raise ValueError(f"no RMSNorm backward kernel takes rows of {d} "
                         f"(dtype codes {code}, {wcode})")
    return n


def rmsnorm_bwd_cuda(s: torch.Tensor, dy: torch.Tensor, w: torch.Tensor,
                     eps: float = 1e-6, ds: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward pass of both forms on CUDA tensors: ``s`` the norm's
    input (the fused form's saved sum ``x + r``), ``dy`` the gradient of
    its output, ``ds`` the gradient of the fused form's ``s`` output (None
    for the plain form).  Returns ``(dx, dw)``: dx in s's dtype (the fused
    form's dr too), dw in fp32 (summed over the rows in fp32; the caller
    rounds it to w's dtype).  One launch of the backward counts once (it
    runs the row kernel, one pass over the rows in persistent blocks, and
    the dw sum over the blocks' partials)."""
    if not (s.is_cuda and dy.is_cuda and w.is_cuda
            and (ds is None or ds.is_cuda)):
        raise ValueError("rmsnorm_bwd_cuda takes CUDA tensors")
    d = s.shape[-1]
    if w.shape != (d,) or dy.shape != s.shape or (
            ds is not None and ds.shape != s.shape):
        raise ValueError(f"shapes s {tuple(s.shape)} dy {tuple(dy.shape)} "
                         f"w {tuple(w.shape)}")
    code = _DTYPES.get(s.dtype)
    if code is None or dy.dtype != s.dtype or (
            ds is not None and ds.dtype != s.dtype):
        raise ValueError(f"unsupported dtypes {s.dtype}, {dy.dtype}")
    lib = _lib()
    wcode = _DTYPES.get(w.dtype)
    w_in = w if wcode in (0, code) else w.float()
    wcode = _DTYPES[w_in.dtype]
    s, dy, w_in = s.contiguous(), dy.contiguous(), w_in.contiguous()
    ds = None if ds is None else ds.contiguous()
    dx = torch.empty_like(s)
    dw = torch.empty((d,), dtype=torch.float32, device=s.device)
    rows = s.numel() // d if d else 0
    if rows:
        # 16-byte vectors of 8 elements where every row allows them (the
        # fresh dx and partial are aligned)
        vec = d % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in (
            s, dy, w_in) + (() if ds is None else (ds,)))
        blocks = min(rows, bwd_blocks(s.device.index or 0, d, code, wcode,
                                      vec))
        partial = torch.empty((blocks, d), dtype=torch.float32,
                              device=s.device)
        err = _bwd_launcher(s.data_ptr(), dy.data_ptr(),
                            None if ds is None else ds.data_ptr(),
                            w_in.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                            partial.data_ptr(), blocks, rows, d, eps, code,
                            wcode, int(vec), _build.current_stream(s.device))
        if err:
            _build.check(lib, err, "rmsnorm_bwd_cuda")
        rmsnorm_bwd_cuda.launches += 1
    else:
        dw.zero_()
    return dx, dw


rmsnorm_bwd_cuda.launches = 0


def rmsnorm_bwd_plain(s: torch.Tensor, dy: torch.Tensor, w: torch.Tensor,
                      eps: float = 1e-6, ds: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: autograd of ``rmsnorm_plain``, plus
    ``ds`` for the fused form."""
    with torch.enable_grad():
        s_ = s.detach().requires_grad_(True)
        w_ = w.detach().requires_grad_(True)
        dx, dw = torch.autograd.grad(rmsnorm_plain(s_, w_, eps), (s_, w_),
                                     dy)
    return (dx if ds is None else dx + ds), dw


__all__ = ["rmsnorm_cuda", "add_rmsnorm_cuda", "rmsnorm_bwd_cuda",
           "rmsnorm_plain", "add_rmsnorm_plain", "rmsnorm_bwd_plain"]
