"""Memory-efficient attention with a hand-written backward, in plain torch.

The port of ``repro.kernels.flash_vjp``: the forward saves only ``(out,
lse)``, and the backward recomputes each block's probabilities from q, k
and the saved log-sum-exp, accumulating dq, dk and dv over the same
block pairs.  One block-pair formulation covers causal (lower-triangular
pairs), sliding-window (pair pruning and an in-block mask), bidirectional
(the full grid), ``kv_len`` padding and the logit softcap (its tanh chain
rule in both passes).

This is the plain version of the two flash kernels of training: the
forward with its log-sum-exp (``csrc/flash_attention.cu``) and the
backward (``csrc/flash_attention_bwd.cu``).  The CPU training path runs
it (``ops.flash_attention`` routes here as the reference's does); on the
card only the tests and ``chip_smoke.py`` call it, through
``attention_fwd_lse`` and ``attention_bwd``, which take the kernels'
layouts and any sequence length.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _pairs(nq: int, nk: int, causal: bool, window: Optional[int],
           blk: int) -> List[Tuple[int, int]]:
    pairs = []
    for i in range(nq):
        for j in range(nk):
            if causal and j > i:
                continue
            if window is not None and (i - j) * blk >= window + blk:
                continue
            pairs.append((i, j))
    return pairs


def _block_mask(i, j, blk, causal, window, kv_len, q_offset):
    dev = kv_len.device
    q_pos = i * blk + torch.arange(blk, device=dev)[:, None] + q_offset
    k_pos = j * blk + torch.arange(blk, device=dev)[None, :]
    mask = k_pos < kv_len[:, None, None]                     # (B, bq, bk)
    if causal:
        mask = mask & (k_pos <= q_pos)[None]
    if window is not None:
        mask = mask & (k_pos > q_pos - window)[None]
    return mask[:, None, None]                               # (B,1,1,bq,bk)


def _sc_fwd(s, cap):
    if cap is None:
        return s
    return cap * torch.tanh(s / cap)


def _sc_bwd(s_capped, cap, ds):
    if cap is None:
        return ds
    return ds * (1.0 - (s_capped / cap) ** 2)


def _fwd(q, k, v, kv_len, causal, window, softcap, q_offset, scale, blk):
    """Grouped layouts: q (B, KV, G, Sq, D), k (B, KV, Sk, D), v (B, KV,
    Sk, DV).  Returns out (q's dtype) and lse (B, KV, G, Sq) fp32."""
    b, kvh, g, sq, d = q.shape
    sk = k.shape[2]
    dv = v.shape[-1]
    q32 = q.float() * scale
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvh, g, sq, dv), dtype=torch.float32,
                      device=q.device)
    for i, j in _pairs(sq // blk, sk // blk, causal, window, blk):
        rows, keys = slice(i * blk, (i + 1) * blk), slice(j * blk,
                                                           (j + 1) * blk)
        s = torch.einsum("bkgqd,bksd->bkgqs", q32[:, :, :, rows],
                         k[:, :, keys].float())
        s = _sc_fwd(s, softcap)
        mask = _block_mask(i, j, blk, causal, window, kv_len, q_offset)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        mi, li = m[..., rows], l[..., rows]
        m_new = torch.maximum(mi, s.amax(dim=-1))
        corr = torch.exp(mi - m_new)
        p = torch.exp(s - m_new[..., None])
        l[..., rows] = li * corr + p.sum(dim=-1)
        acc[..., rows, :] = acc[..., rows, :] * corr[..., None] + \
            torch.einsum("bkgqs,bksd->bkgqd", p, v[:, :, keys].float())
        m[..., rows] = m_new
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return out, lse


def _bwd_rule(causal, window, softcap, q_offset, scale, blk, res, dout):
    q, k, v, kv_len, out, lse = res
    b, kvh, g, sq, d = q.shape
    sk = k.shape[2]
    q32 = q.float() * scale
    k32, v32, g32 = k.float(), v.float(), dout.float()
    delta = torch.sum(g32 * out.float(), dim=-1)           # (B,KV,G,Sq)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv_ = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for i, j in _pairs(sq // blk, sk // blk, causal, window, blk):
        rows, keys = slice(i * blk, (i + 1) * blk), slice(j * blk,
                                                           (j + 1) * blk)
        qi, kj, vj = q32[:, :, :, rows], k32[:, :, keys], v32[:, :, keys]
        gi = g32[:, :, :, rows]
        s = torch.einsum("bkgqd,bksd->bkgqs", qi, kj)
        sc = _sc_fwd(s, softcap)
        mask = _block_mask(i, j, blk, causal, window, kv_len, q_offset)
        sc_m = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
        p = torch.exp(sc_m - lse[..., rows, None])          # (B,KV,G,bq,bk)
        dv_[:, :, keys] += torch.einsum("bkgqs,bkgqd->bksd", p, gi)
        dp = torch.einsum("bkgqd,bksd->bkgqs", gi, vj)
        ds = p * (dp - delta[..., rows, None])
        ds = _sc_bwd(sc, softcap, ds)
        ds = torch.where(mask, ds, torch.zeros_like(ds))
        dq[:, :, :, rows] += torch.einsum("bkgqs,bksd->bkgqd", ds, kj) * scale
        dk[:, :, keys] += torch.einsum("bkgqs,bkgqd->bksd", ds, qi)
    return dq.to(q.dtype), dk.to(k.dtype), dv_.to(v.dtype)


class FlashAttentionVJP(torch.autograd.Function):
    """``flash_attention_vjp`` of the reference: grouped layouts, the
    blocked forward and backward above."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, causal, window, softcap, q_offset,
                scale, blk):
        out, lse = _fwd(q, k, v, kv_len, causal, window, softcap, q_offset,
                        scale, blk)
        ctx.save_for_backward(q, k, v, kv_len, out, lse)
        ctx.args = (causal, window, softcap, q_offset, scale, blk)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = _bwd_rule(*ctx.args, ctx.saved_tensors, dout)
        return dq, dk, dv, None, None, None, None, None, None, None


def _group(q, k, v):
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    q_ = q.reshape(b, sq, kvh, h // kvh, d).permute(0, 2, 3, 1, 4)
    return q_, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)


def _lens(kv_len, b, sk, device):
    if kv_len is None:
        return torch.full((b,), sk, dtype=torch.int32, device=device)
    return kv_len.to(device=device, dtype=torch.int32)


def flash_attention_train(q, k, v, *, causal=True, window=None,
                          softcap=None, kv_len=None, q_offset=0,
                          scale=None, block=256):
    """(B,Sq,H,D)/(B,Sk,KV,D) wrapper around the grouped custom-VJP core."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    blk = min(block, sq, sk)
    assert sq % blk == 0 and sk % blk == 0, (sq, sk, blk)
    q_, k_, v_ = _group(q, k, v)
    out = FlashAttentionVJP.apply(q_, k_, v_, _lens(kv_len, b, sk, q.device),
                                  causal, window, softcap, q_offset, scale,
                                  blk)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv)


def _padded(x, n):
    return x if x.shape[1] == n else F.pad(x, (0, 0, 0, 0, 0, n - x.shape[1]))


def _blocked(q, k, v, kv_len, block):
    """The block and q, k, v padded to a multiple of it (the padded keys
    masked by ``kv_len``; the padded rows dropped by the caller)."""
    b, sq = q.shape[:2]
    sk = k.shape[1]
    blk = min(block, max(sq, sk))
    nq, nk = -(-sq // blk) * blk, -(-sk // blk) * blk
    lens = torch.clamp(_lens(kv_len, b, sk, q.device), max=sk)
    return blk, _padded(q, nq), _padded(k, nk), _padded(v, nk), lens


def attention_fwd_lse(q, k, v, *, causal=True, window=None, softcap=None,
                      kv_len=None, q_offset=0, scale=None, block=256):
    """The plain version of the flash forward with its log-sum-exp: ``(out
    (B, Sq, H, DV), lse (B, H, Sq) fp32)``, the kernel's layouts, at any
    Sq and Sk."""
    b, sq, h, d = q.shape
    dv = v.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    blk, qp, kp, vp, lens = _blocked(q, k, v, kv_len, block)
    q_, k_, v_ = _group(qp, kp, vp)
    out, lse = _fwd(q_, k_, v_, lens, causal, window, softcap, q_offset,
                    scale, blk)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, -1, h, dv)[:, :sq]
    return out, lse.reshape(b, h, -1)[:, :, :sq]


def attention_bwd(q, k, v, out, dout, lse, *, causal=True, window=None,
                  softcap=None, kv_len=None, q_offset=0, scale=None,
                  block=256):
    """The plain version of the flash backward: ``(dq, dk, dv)`` in the
    kernel's layouts from the forward's ``out`` and ``lse (B, H, Sq)``, at
    any Sq and Sk."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    blk, qp, kp, vp, lens = _blocked(q, k, v, kv_len, block)
    nq = qp.shape[1]
    q_, k_, v_ = _group(qp, kp, vp)
    o_ = _group(_padded(out, nq), kp, vp)[0]
    g_ = _group(_padded(dout, nq), kp, vp)[0]
    lse_ = F.pad(lse, (0, nq - sq), value=-NEG_INF).reshape(
        b, kvh, h // kvh, nq)
    scale = scale if scale is not None else d ** -0.5
    dq, dk, dv = _bwd_rule(causal, window, softcap, q_offset, scale, blk,
                           (q_, k_, v_, lens, o_, lse_), g_)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, nq, h, d)[:, :sq]
    return dq, dk.permute(0, 2, 1, 3)[:, :sk], dv.permute(0, 2, 1, 3)[:, :sk]


__all__ = ["flash_attention_train", "FlashAttentionVJP", "attention_fwd_lse",
           "attention_bwd"]
