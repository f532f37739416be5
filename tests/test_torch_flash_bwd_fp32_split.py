"""The fp32 flash backward's arithmetic, emulated in torch on the CPU.

``csrc/flash_attention_bwd.cu`` computes the fp32 gradients on the tensor
cores: each operand of its seven products is split into two TF32 halves
(``tf32::split``, ``test_torch_flash_fp32_split.split``: hi rounded to
TF32, lo the rest truncated) and each product is three (3xTF32: hi * hi'
+ hi * lo' + lo * hi' in fp32, ``mm3``), in the JAX
order (q * scale before its products, then the softcap, its chain and the
mask; dq = (dS K) * scale, dk = dS^T (q * scale)).  Its tiles:

* dK/dV: a block of 64 keys visits, head by head of its GQA group, the q
  tiles of ``KV_ROWS`` rows that its mask can reach, from the first such
  row rounded down to a tile; per tile S^T = K (q * scale)^T and dP^T = V
  dO^T, P^T and dS^T, then dV += P^T dO and dK += dS^T (q * scale);
* dQ: a block of ``DQ_ROWS`` q rows visits the key tiles of ``DQ_KEYS``
  keys its mask can reach; per tile S and dP, dS, then dQ += dS K.

This file repeats that arithmetic tile for tile, each step's product
taken alone and added to the running sum in fp32 (as the kernels do: the
tensor core's own accumulator truncates, so it never carries a sum across
steps) in the kernels' order (q tiles within a head, heads in order; key
tiles in order), and holds it to the port's plain backward
(``flash_vjp.attention_bwd``) at the card's bar for the fp32 backward,
1e-4 of the largest |gradient|, at narrow versions of ``chip_smoke.py``'s
``BWD_CASES`` at every head-dim pair; one TF32 product per multiply
misses that bar.  Nothing on the main path imports it.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_vjp
from test_torch_flash_fp32_split import mm1, mm3

BWD_FP32_TOL = 1e-4         # chip_smoke.py's bar: of the largest |gradient|
KEYS = 64                   # keys a dK/dV block
LOG2E = 1.4426950408889634
# the kernels' tiles by (D, DV) (csrc/flash_attention_bwd.cu's F32Bwd):
# q rows a dK/dV step; q rows and keys a dQ block and tile
KV_ROWS = {(16, 16): 64, (64, 64): 32, (128, 128): 64, (192, 128): 32,
           (256, 256): 16}
DQ_ROWS = {(16, 16): 64, (64, 64): 64, (128, 128): 128, (192, 128): 64,
           (256, 256): 64}
DQ_KEYS = {(16, 16): 64, (64, 64): 64, (128, 128): 32, (192, 128): 32,
           (256, 256): 16}


def _keep(q_pos, k_pos, length, causal, window):
    """The kernels' mask of (rows, keys) positions."""
    ok = (k_pos < length)[None, :].expand(len(q_pos), len(k_pos))
    if causal:
        ok = ok & (k_pos[None, :] <= q_pos[:, None])
    if window:
        ok = ok & (k_pos[None, :] > q_pos[:, None] - window)
    return ok


def _prob(x, lse, ok, softcap):
    """p = exp(sc - lse) of scaled scores x (0 where masked; the kernel's
    exp2 of log2 units), and the softcap's chain 1 - (sc/cap)^2."""
    f = torch.ones_like(x)
    if softcap:
        x = softcap * torch.tanh(x / softcap)
        f = 1 - (x / softcap) * (x / softcap)
    p = torch.exp2(x * LOG2E - (lse * LOG2E)[..., None])
    return torch.where(ok, p, torch.zeros_like(p)), f


def _rows(x, b, rows, h, n):
    """``n`` rows of head h from ``rows`` on, zeros past the end."""
    out = torch.zeros((n, x.shape[-1]))
    live = rows[rows < x.shape[1]]
    out[:len(live)] = x[b, live, h]
    return out


def emulate(q, k, v, out, dout, lse, *, causal=True, window=None,
            softcap=None, kv_len=None, q_offset=0, mm=mm3):
    """The kernels' (dq, dk, dv) on CPU fp32 tensors, tile for tile."""
    b_, sq, h_, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    dv_ = v.shape[-1]
    g_ = h_ // kvh
    scale = d ** -0.5
    lens = kv_len.tolist() if kv_len is not None else [sk] * b_
    delta = (dout * out).sum(-1).transpose(1, 2)            # (B, H, Sq)
    dq = torch.zeros_like(q)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    bq, rows_q, keys_q = (KV_ROWS[(d, dv_)], DQ_ROWS[(d, dv_)],
                          DQ_KEYS[(d, dv_)])
    for b in range(b_):
        length = min(lens[b], sk)
        # ---- dK/dV: a block of 64 keys of kv head kh
        for kh in range(kvh):
            for k0 in range(0, sk, KEYS):
                keys = torch.arange(k0, k0 + KEYS)
                kt, vt = _rows(k, b, keys, kh, KEYS), _rows(v, b, keys, kh,
                                                            KEYS)
                lo = max(0, k0 - q_offset) if causal else 0
                hi = (min(sq, k0 + KEYS - 1 + window - q_offset) if window
                      else sq)
                lo = lo // bq * bq
                acc_k, acc_v = torch.zeros((KEYS, d)), torch.zeros((KEYS,
                                                                    dv_))
                if k0 < length and lo < hi:
                    for h in range(kh * g_, (kh + 1) * g_):
                        for q0 in range(lo, hi, bq):
                            rows = torch.arange(q0, q0 + bq)
                            qs = _rows(q, b, rows, h, bq) * scale
                            gt = _rows(dout, b, rows, h, bq)
                            live = rows < sq
                            lt = torch.where(live, lse[b, h, rows.clamp(
                                max=sq - 1)], torch.tensor(1e30))
                            dt = torch.where(live, delta[b, h, rows.clamp(
                                max=sq - 1)], torch.tensor(0.0))
                            ok = _keep(q_offset + rows, keys, length, causal,
                                       window).T           # (keys, rows)
                            st = mm(kt, qs.T)
                            p, f = _prob(st.T, lt, ok.T, softcap)
                            dpt = mm(vt, gt.T)
                            dst = (p * f).T * (dpt - dt[None, :])
                            acc_v = acc_v + mm(p.T, gt)
                            acc_k = acc_k + mm(dst, qs)
                n = min(KEYS, sk - k0)
                dk[b, k0:k0 + n, kh] = acc_k[:n]
                dv[b, k0:k0 + n, kh] = acc_v[:n]
        # ---- dQ: a block of rows_q rows of head h
        for h in range(h_):
            kh = h // g_
            for row0 in range(0, sq, rows_q):
                rows = torch.arange(row0, row0 + rows_q)
                live = rows < sq
                qs = _rows(q, b, rows, h, rows_q) * scale
                gt = _rows(dout, b, rows, h, rows_q)
                lt = torch.where(live, lse[b, h, rows.clamp(max=sq - 1)],
                                 torch.tensor(1e30))
                dt = torch.where(live, delta[b, h, rows.clamp(max=sq - 1)],
                                 torch.tensor(0.0))
                q_hi = q_offset + min(row0 + rows_q, sq) - 1
                end = min(length, q_hi + 1) if causal else length
                first = (max(0, q_offset + row0 - window + 1) if window
                         else 0) // keys_q * keys_q
                acc = torch.zeros((rows_q, d))
                for k0 in range(first, end, keys_q):
                    keys = torch.arange(k0, k0 + keys_q)
                    kt = _rows(k, b, keys, kh, keys_q)
                    vt = _rows(v, b, keys, kh, keys_q)
                    ok = _keep(q_offset + rows, keys, length, causal, window)
                    p, f = _prob(mm(qs, kt.T), lt, ok, softcap)
                    ds = p * f * (mm(gt, vt.T) - dt[:, None])
                    acc = acc + mm(ds, kt)
                n = min(rows_q, sq - row0)
                dq[b, row0:row0 + n, h] = acc[:n] * scale
    return dq, dk, dv


# (B, Sq, Sk, H, KV, D, DV, causal, window, softcap, kv_len, q_offset):
# narrow versions of chip_smoke.py's BWD_CASES (llama's causal GQA; d16
# with a window and a softcap; gemma2-2b's window and softcap at D = 256,
# here with kv_len; gemma-7b's G = 1; deepseek's MLA (192, 128); G = 8),
# lengths that divide none of the tiles, and an int q_offset with a window
CASES = {
    "llama causal": (1, 200, 200, 4, 2, 128, 128, True, None, None, None, 0),
    "d16 window 16 softcap 50": (2, 150, 150, 4, 2, 16, 16, True, 16, 50.0,
                                 None, 0),
    "gemma2 window softcap kv_len": (1, 150, 150, 4, 2, 256, 256, True, 40,
                                     50.0, (131,), 0),
    "gemma-7b G = 1": (1, 100, 100, 2, 2, 256, 256, True, None, None, None,
                       0),
    "deepseek MLA": (1, 140, 140, 2, 2, 192, 128, True, None, None, None, 0),
    "g8": (1, 140, 140, 8, 1, 64, 64, True, None, None, None, 0),
    "bidirectional kv_len": (2, 90, 90, 4, 2, 64, 64, False, None, None,
                             (90, 57), 0),
    "q_offset 103 window 48": (1, 150, 253, 4, 2, 64, 64, True, 48, None,
                               None, 103),
}


def _case(name, seed=0):
    b, sq, sk, h, kvh, d, dv, causal, window, cap, lens, off = CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)) for shape in ((b, sq, h, d), (b, sk, kvh, d),
                                   (b, sk, kvh, dv), (b, sq, h, dv)))
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=off,
              kv_len=None if lens is None else torch.tensor(lens))
    out, lse = flash_vjp.attention_fwd_lse(q, k, v, **kw)
    return q, k, v, out, dout, lse, kw


def _worst(got, want):
    return max(float((g - w).abs().max() / w.abs().max())
               for g, w in zip(got, want))


@pytest.mark.parametrize("case", list(CASES))
def test_split_tf32_backward_meets_the_fp32_bar(case):
    """3xTF32 over the kernels' tiles is within 1e-4 of the largest
    |gradient| of the plain backward (in practice about 1e-6)."""
    q, k, v, out, dout, lse, kw = _case(case)
    want = flash_vjp.attention_bwd(q, k, v, out, dout, lse, **kw)
    got = emulate(q, k, v, out, dout, lse, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
    err = _worst(got, want)
    assert err <= BWD_FP32_TOL, err


@pytest.mark.parametrize("case", list(CASES))
def test_one_tf32_product_misses_the_fp32_bar(case):
    """Plain TF32 (each operand rounded once) moves the gradients past
    1e-4 of their largest value: why each product is three."""
    q, k, v, out, dout, lse, kw = _case(case)
    want = flash_vjp.attention_bwd(q, k, v, out, dout, lse, **kw)
    err = _worst(emulate(q, k, v, out, dout, lse, mm=mm1, **kw), want)
    assert err > BWD_FP32_TOL, err


def test_tiles_fit_shared_memory():
    """The kernels' tiles by pair: the dK/dV block's K and V, a 2-stage
    ring of (Q, dO, lse, delta) and the exchange tile, and the dQ block's
    Q and dO with a 2-stage ring of (K, V) (and, where two warps share 16
    rows, from D + DV = 320 on, their exchange tile), each within the 227
    KB a block may have, at rows padded to width + 8 floats."""
    for (d, dv), bq in KV_ROWS.items():
        lk, lv = d + 8, dv + 8
        kv = 4 * (KEYS * (lk + lv) + 2 * (bq * (lk + lv) + 2 * bq)
                  + KEYS * bq)
        rows, keys = DQ_ROWS[(d, dv)], DQ_KEYS[(d, dv)]
        dq = 4 * ((rows + 2 * keys) * (lk + lv)
                  + (rows * keys if d + dv >= 320 else 0))
        assert max(kv, dq) <= 227 * 1024, (d, dv, kv, dq)
        assert KEYS % bq == 0 and rows % 16 == 0 and keys % 8 == 0
