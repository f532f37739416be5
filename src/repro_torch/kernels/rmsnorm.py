"""RMSNorm: a Triton kernel for Hopper, its launch count and plain version.

Replaces ``src/repro/kernels/rmsnorm.py::rmsnorm_pallas``.

What bounds it on the H100: bytes.  A row is one fp32 reduction followed
by one elementwise pass, about 4 flops per element against at least 4
bytes moved (bf16 in, bf16 out), so the floor is reading x once and
writing the result once.  Design: one program per row holds the whole
row (D = 4096 for llama3-8b) in registers, so x is read from device
memory exactly once; the mean of squares and the scale are fp32, and the
result is cast back to x's dtype as the reference does.

Triton is imported, and the kernel compiled, inside the launching
function: a CPU-only install imports this module without Triton.
"""
from __future__ import annotations

import functools
import os

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm_reference as rmsnorm_plain


@functools.lru_cache(maxsize=None)
def _kernel():
    os.environ.setdefault("TRITON_CACHE_DIR", str(_build.BUILD_ROOT / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_kernel(x_ptr, w_ptr, o_ptr, d, eps, BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        offs = tl.arange(0, BLOCK)
        live = offs < d
        x = tl.load(x_ptr + row * d + offs, mask=live, other=0.0).to(tl.float32)
        var = tl.sum(x * x, axis=0) / d
        w = tl.load(w_ptr + offs, mask=live, other=0.0).to(tl.float32)
        y = x * tl.rsqrt(var + eps) * w
        tl.store(o_ptr + row * d + offs, y.to(o_ptr.dtype.element_ty),
                 mask=live)

    return triton, rmsnorm_kernel


def rmsnorm_triton(x: torch.Tensor, w: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; raises on anything it cannot take."""
    if not (x.is_cuda and w.is_cuda):
        raise ValueError("rmsnorm_triton takes CUDA tensors")
    d = x.shape[-1]
    if w.shape != (d,):
        raise ValueError(f"weight shape {tuple(w.shape)} != ({d},)")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"unsupported dtype {x.dtype}")
    triton, kernel = _kernel()
    x2 = x.reshape(-1, d).contiguous()
    out = torch.empty_like(x2)
    block = triton.next_power_of_2(d)
    rows = x2.shape[0]
    if rows:
        kernel[(rows,)](x2, w.contiguous(), out, d, eps, BLOCK=block,
                        num_warps=min(16, max(1, block // 256)))
        rmsnorm_triton.launches += 1
    return out.reshape(x.shape)


rmsnorm_triton.launches = 0

__all__ = ["rmsnorm_triton", "rmsnorm_plain"]
