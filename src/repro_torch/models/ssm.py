"""Mamba2 blocks via SSD (state-space duality, arXiv:2405.21060).

The port of ``repro.models.ssm``: plain torch ops, as the reference is
plain ``jnp`` (no Pallas kernel), with its fp32 steps where it puts them.
Prefill runs the chunked SSD algorithm: quadratic attention-like products
within a chunk, a linear recurrence across chunks (a Python loop over the
chunks where the reference scans them) carrying the ``(B, H, P, N)``
state.  Decode is the O(1) step recurrence.  The cache is the conv
history ``(B, d_conv - 1, di + 2GN)`` and the fp32 state: constant in
sequence length.  ``gate_norm`` is ``layers.rms_norm`` (the RMSNorm
kernel on the card).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers

NEG_INF = -1e30


def init_mamba(gen: torch.Generator, cfg: ModelConfig, dtype,
               device) -> dict:
    """The reference's layouts; ``A_log``, ``dt_bias`` and ``D`` in fp32
    whatever ``dtype``, as it creates them."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.num_heads(d)
    gn2 = 2 * s.n_groups * s.d_state
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_z": layers.dense_init(gen, (d, di), dtype, device),
        "in_x": layers.dense_init(gen, (d, di), dtype, device),
        "in_bc": layers.dense_init(gen, (d, gn2), dtype, device),
        "in_dt": layers.dense_init(gen, (d, nh), dtype, device),
        "conv_x_w": layers.dense_init(gen, (di, s.d_conv), dtype, device,
                                      fan_in=s.d_conv),
        "conv_x_b": torch.zeros((di,), dtype=dtype, device=device),
        "conv_bc_w": layers.dense_init(gen, (gn2, s.d_conv), dtype, device,
                                       fan_in=s.d_conv),
        "conv_bc_b": torch.zeros((gn2,), dtype=dtype, device=device),
        "A_log": torch.zeros((nh,), **f32),            # A = -exp(A_log)
        "dt_bias": torch.full((nh,), -2.0, **f32),     # softplus ~ 0.12
        "D": torch.ones((nh,), **f32),
        "gate_norm": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": layers.dense_init(gen, (di, d), dtype, device,
                                      fan_in=di),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init_state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv as k shifted adds in fp32, then SiLU.

    x (B, S, C); w (C, k); init_state (B, k-1, C) history or None (zeros).
    """
    bsz, s, c = x.shape
    k = w.shape[1]
    hist = init_state if init_state is not None else \
        x.new_zeros((bsz, k - 1, c))
    xp = torch.cat([hist.to(x.dtype), x], dim=1)           # (B, S+k-1, C)
    out = torch.zeros((bsz, s, c), dtype=torch.float32, device=x.device)
    for j in range(k):
        out = out + xp[:, j:j + s].float() * w[:, j].float()
    return F.silu(out + b.float()).to(x.dtype)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable segment sums: a (..., Q) -> (..., Q, Q) with [i, j] =
    sum(a[j+1..i]) for j <= i, ``NEG_INF`` above the diagonal."""
    q = a.shape[-1]
    x = a[..., None].expand(*a.shape, q)                   # [..., i, j] = a_i
    below = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                  device=a.device), diagonal=-1)
    x = torch.where(below, x, torch.zeros((), dtype=a.dtype, device=a.device))
    x = torch.cumsum(x, dim=-2)                            # sum_{j+1..i}
    keep = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(keep, x, torch.full((), NEG_INF, dtype=a.dtype,
                                           device=a.device))


def ssd_chunked(
    x: torch.Tensor,      # (B, S, H, P) values (not yet dt-scaled)
    dt: torch.Tensor,     # (B, S, H) fp32, post-softplus
    a: torch.Tensor,      # (H,) fp32 negative decay
    b_: torch.Tensor,     # (B, S, G, N)
    c_: torch.Tensor,     # (B, S, G, N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,   # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan; returns (y (B, S, H, P) fp32, final state
    (B, H, P, N) fp32)."""
    bsz, s, h, p = x.shape
    g, n = b_.shape[2], b_.shape[3]
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    rep = h // g

    xf = x.float().reshape(bsz, nc, chunk, h, p)
    dtf = dt.reshape(bsz, nc, chunk, h)
    bf = b_.float().reshape(bsz, nc, chunk, g, n)
    cf = c_.float().reshape(bsz, nc, chunk, g, n)
    # groups broadcast to heads: (B, nc, Q, G, N) -> (B, nc, Q, H, N)
    bh = torch.repeat_interleave(bf, rep, dim=3)
    ch = torch.repeat_interleave(cf, rep, dim=3)

    adt = dtf * a[None, None, None, :]                     # (B,nc,Q,H)
    xdt = xf * dtf[..., None]
    acum = torch.cumsum(adt, dim=2)

    # within a chunk (quadratic)
    lmat = torch.exp(_segsum(adt.movedim(-1, 2)))          # (B,nc,H,Q,Q)
    scores = torch.einsum("bcqhn,bcshn->bchqs", ch, bh)
    y_diag = torch.einsum("bchqs,bcshp->bcqhp", scores * lmat, xdt)

    # each chunk's own state
    decay_states = torch.exp(acum[:, :, -1:, :] - acum)    # (B,nc,Q,H)
    states = torch.einsum("bcqhn,bcqhp->bchpn",
                          bh * decay_states[..., None], xdt)

    # across chunks: the recurrence, each chunk fed the state before it
    chunk_decay = torch.exp(acum[:, :, -1, :])             # (B,nc,H)
    st = (init_state.float() if init_state is not None else
          torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device))
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                 # (B,nc,H,P,N)

    # the earlier chunks' contribution
    state_decay = torch.exp(acum)                          # (B,nc,Q,H)
    y_off = torch.einsum("bcqhn,bchpn->bcqhp", ch, prev_states) \
        * state_decay[..., None]
    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y, st


def ssd_step(
    x: torch.Tensor,      # (B, H, P)
    dt: torch.Tensor,     # (B, H) fp32
    a: torch.Tensor,      # (H,)
    b_: torch.Tensor,     # (B, G, N)
    c_: torch.Tensor,     # (B, G, N)
    state: torch.Tensor,  # (B, H, P, N) fp32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token of the recurrence: O(1) in sequence length."""
    rep = x.shape[1] // b_.shape[1]
    bh = torch.repeat_interleave(b_.float(), rep, dim=1)   # (B,H,N)
    ch = torch.repeat_interleave(c_.float(), rep, dim=1)
    da = torch.exp(dt * a[None, :])                        # (B,H)
    xdt = x.float() * dt[..., None]                        # (B,H,P)
    new_state = state * da[..., None, None] + \
        torch.einsum("bhp,bhn->bhpn", xdt, bh)
    y = torch.einsum("bhpn,bhn->bhp", new_state, ch)
    return y, new_state


def mamba_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
                  cache: Optional[dict],   # {"conv" (B, k-1, C), "state"
                                           #  (B, H, P, N) fp32}; None with
                                           #  mode="train"
                  pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A Mamba2 block over a whole prompt (``mode="prefill"``), over a
    whole sequence without a cache (``"train"``: the SSD over the
    sequence) or one token a row (``"decode"``; no positional encoding, so
    ``pos`` is unused).  Writes ``cache`` in place; returns the output."""
    if mode not in ("prefill", "decode", "train"):
        raise NotImplementedError(f"mode {mode!r}")
    s_cfg = cfg.ssm
    bsz, s, _ = x.shape
    di = s_cfg.d_inner(cfg.d_model)
    nh = s_cfg.num_heads(cfg.d_model)
    hd = s_cfg.head_dim
    g, n = s_cfg.n_groups, s_cfg.d_state
    k = s_cfg.d_conv

    z = x @ p["in_z"]                                      # (B,S,di)
    xr = x @ p["in_x"]
    bc = x @ p["in_bc"]                                    # (B,S,2GN)
    dt_raw = (x @ p["in_dt"]).float()                      # (B,S,nh)
    a = -torch.exp(p["A_log"])
    dt = F.softplus(dt_raw + p["dt_bias"])

    if mode in ("prefill", "train"):
        hist = torch.cat([xr, bc], dim=-1)
        xr = _causal_conv(xr, p["conv_x_w"], p["conv_x_b"])
        bc = _causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"])
        bmat, cmat = bc.split(g * n, dim=-1)
        xh = xr.reshape(bsz, s, nh, hd)
        y, state = ssd_chunked(xh, dt, a, bmat.reshape(bsz, s, g, n),
                               cmat.reshape(bsz, s, g, n),
                               min(s_cfg.chunk_size, s))
        y = y + p["D"][None, None, :, None] * xh.float()
        if mode == "prefill":
            conv = hist[:, s - (k - 1):] if s >= k - 1 else \
                F.pad(hist, (0, 0, k - 1 - s, 0))
            cache["conv"].copy_(conv.to(cache["conv"].dtype))
            cache["state"].copy_(state)
    else:
        conv_hist = cache["conv"]                          # (B, k-1, C)
        cur = torch.cat([xr, bc], dim=-1)                  # (B, 1, C)
        xr = _causal_conv(xr, p["conv_x_w"], p["conv_x_b"],
                          conv_hist[..., :di])
        bc = _causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"],
                          conv_hist[..., di:])
        new_conv = torch.cat([conv_hist, cur.to(conv_hist.dtype)],
                             dim=1)[:, 1:]
        bmat, cmat = bc[:, 0].split(g * n, dim=-1)
        xh = xr[:, 0].reshape(bsz, nh, hd)
        y, state = ssd_step(xh, dt[:, 0], a, bmat.reshape(bsz, g, n),
                            cmat.reshape(bsz, g, n), cache["state"])
        y = (y + p["D"][None, :, None] * xh.float())[:, None]
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(state)

    yd = y.reshape(bsz, -1, di).to(x.dtype)
    out = layers.rms_norm(yd * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return out @ p["out_proj"]


def make_mamba_cache_spec(cfg: ModelConfig, batch: int, dtype) -> dict:
    """Per-layer shapes ``{"conv": ((batch, d_conv - 1, di + 2GN), dtype),
    "state": ((batch, H, P, N), fp32)}``."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    c = di + 2 * s.n_groups * s.d_state
    return {"conv": ((batch, s.d_conv - 1, c), dtype),
            "state": ((batch, s.num_heads(cfg.d_model), s.head_dim,
                       s.d_state), torch.float32)}
