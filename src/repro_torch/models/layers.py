"""Shared building blocks: init, norms, RoPE, MLPs, softcap."""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def dense_init(gen: torch.Generator, shape: Sequence[int], dtype,
               device, fan_in: Optional[int] = None) -> torch.Tensor:
    """Normal(0, 1/sqrt(fan_in)) truncated at two standard deviations."""
    fan_in = fan_in if fan_in is not None else shape[0]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(tuple(shape), generator=gen, device=device,
                    dtype=torch.float32)
    return (x.clamp_(-2.0, 2.0) * std).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int], dtype,
               device) -> torch.Tensor:
    x = torch.randn(tuple(shape), generator=gen, device=device,
                    dtype=torch.float32)
    return (x.clamp_(-2.0, 2.0) * 0.02).to(dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return ops.rmsnorm(x, w, eps)


def add_rms_norm(x: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                 eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x + r, rms_norm(x + r))``: a residual add and the norm after it."""
    return ops.add_rmsnorm(x, r, w, eps)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# RoPE (half-split rotary pairing, as repro.models.layers)
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, rot_dim: int,
                 theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin (..., rot_dim/2), f32."""
    exponent = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                            device=positions.device) / rot_dim
    freqs = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rot_dim: Optional[int] = None) -> torch.Tensor:
    """x (..., S, H, D); cos/sin broadcastable (..., S, 1, rot/2)."""
    d = x.shape[-1]
    rot = rot_dim if rot_dim is not None else d
    xr, xp = x[..., :rot], x[..., rot:]
    x1f, x2f = xr[..., :rot // 2].float(), xr[..., rot // 2:].float()
    o1 = x1f * cos - x2f * sin
    o2 = x2f * cos + x1f * sin
    out = torch.cat([o1, o2], dim=-1).to(x.dtype)
    if rot < d:
        out = torch.cat([out, xp], dim=-1)
    return out


# ---------------------------------------------------------------------------
# MLPs: SwiGLU, GeGLU (gated, tanh-approximate GELU) and plain GELU
# ---------------------------------------------------------------------------

MLP_KINDS = ("swiglu", "geglu", "gelu")


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, kind: str,
             dtype, device) -> dict:
    if kind not in MLP_KINDS:
        raise ValueError(f"mlp kind {kind!r}")
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(gen, (d_model, d_ff), dtype, device),
            "w_up": dense_init(gen, (d_model, d_ff), dtype, device),
            "w_down": dense_init(gen, (d_ff, d_model), dtype, device,
                                 fan_in=d_ff),
        }
    return {
        "w_up": dense_init(gen, (d_model, d_ff), dtype, device),
        "w_down": dense_init(gen, (d_ff, d_model), dtype, device,
                             fan_in=d_ff),
    }


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def apply_mlp(params: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        g = F.silu(x @ params["w_gate"])
        return (g * (x @ params["w_up"])) @ params["w_down"]
    if kind == "geglu":
        g = gelu(x @ params["w_gate"])
        return (g * (x @ params["w_up"])) @ params["w_down"]
    if kind == "gelu":
        return gelu(x @ params["w_up"]) @ params["w_down"]
    raise ValueError(f"mlp kind {kind!r}")


def mlp_flops(d_model: int, d_ff: int, kind: str, tokens: int) -> int:
    n_mat = 3 if kind in ("swiglu", "geglu") else 2
    return 2 * n_mat * d_model * d_ff * tokens
