"""The fp32 flash kernel's arithmetic, emulated in torch on the CPU.

``csrc/flash_attention.cu`` computes fp32 attention on the tensor cores:
each operand of S = (q * scale) K^T and of O += P V is split into two TF32
halves, hi = tf32(a) (round to nearest, ties away) and lo = a - hi
truncated to TF32, and each product is hi * hi' + hi * lo' + lo * hi' in fp32 (3xTF32), over
64-row q tiles, 32-key kv tiles and splits of the keys that a second
kernel merges in split order.  This file repeats that arithmetic step for
step with TF32 rounding done by bit masking, and holds it to the port's
plain flash at the card's bar for fp32 attention, 2e-5, at narrow
versions of ``chip_smoke.py``'s fp32 cases; one TF32 product per
multiply misses that bar.  Nothing on the main path imports it.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa

FP32_ATTN_TOL = 2e-5        # chip_smoke.py's bar for fp32 attention
NEG = -1e30
ROWS, KEYS = 64, 32         # the kernel's q tile and kv tile


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: fp32 rounded to 10 mantissa bits, to nearest
    with ties away from zero (add half of the 13 dropped bits to the
    magnitude, then clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def truncate_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 with its 13 low mantissa bits cleared (toward zero)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x):
    """The kernel's split (``tf32::split``): x = hi + lo to about 2**-21."""
    hi = tf32(x)
    return hi, truncate_tf32(x - hi)


def mm3(a, b):
    """a @ b from split operands: the two small products, then the big
    one (products of TF32 halves are exact in fp32; sums are fp32)."""
    ah, al = split(a)
    bh, bl = split(b)
    return ah @ bh + (al @ bh + ah @ bl)


def mm1(a, b):
    """a @ b with each operand rounded to TF32 once: plain TF32."""
    return tf32(a) @ tf32(b)


def emulate(q, k, v, *, causal=True, window=None, softcap=None, kv_len=None,
            q_offset=0, splits=1, mm=mm3):
    """The kernel's forward on CPU fp32 tensors: per batch row and q tile,
    the key reach cut into ``splits`` splits of whole 32-key tiles, an
    online softmax over each split's tiles, the splits merged in order."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // kvh
    scale = d ** -0.5
    offs = (q_offset.tolist() if torch.is_tensor(q_offset)
            else [int(q_offset)] * b)
    lens = kv_len.tolist() if kv_len is not None else [sk] * b
    out = torch.zeros((b, sq, h, dv))
    for bi in range(b):
        kb = k[bi].repeat_interleave(g, dim=1).transpose(0, 1)  # (H, Sk, D)
        vb = v[bi].repeat_interleave(g, dim=1).transpose(0, 1)
        for row0 in range(0, sq, ROWS):
            n = min(ROWS, sq - row0)
            qs = q[bi, row0:row0 + n].transpose(0, 1) * scale     # (H, n, D)
            q_pos = offs[bi] + row0 + torch.arange(n)
            hi_key = min(lens[bi], int(q_pos[-1]) + 1) if causal else lens[bi]
            lo_key = max(0, int(q_pos[0]) - window + 1) if window else 0
            first = lo_key // KEYS * KEYS
            split_len = -(-max(hi_key - first, 1) // KEYS // splits) * KEYS
            states = []
            for sp in range(splits):
                lo = first + sp * split_len
                hi = min(hi_key, lo + split_len)
                m = torch.full((h, n), NEG)
                l = torch.zeros((h, n))
                acc = torch.zeros((h, n, dv))
                for k0 in range(lo, hi, KEYS):
                    keys = torch.arange(k0, k0 + KEYS)
                    kt = torch.zeros((h, KEYS, d))
                    vt = torch.zeros((h, KEYS, dv))
                    live = keys < sk
                    kt[:, live] = kb[:, keys[live]]
                    vt[:, live] = vb[:, keys[live]]
                    s = mm(qs, kt.transpose(1, 2))                  # (H, n, 32)
                    if softcap:
                        s = softcap * torch.tanh(s / softcap)
                    ok = (keys < lens[bi])[None, :].expand(n, KEYS)
                    if causal:
                        ok = ok & (keys[None, :] <= q_pos[:, None])
                    if window:
                        ok = ok & (keys[None, :] > q_pos[:, None] - window)
                    s = torch.where(ok, s, torch.tensor(NEG))
                    mn = torch.maximum(m, s.amax(-1))
                    c = torch.exp(m - mn)
                    p = torch.exp(s - mn[..., None])
                    l = l * c + p.sum(-1)
                    acc = acc * c[..., None] + mm(p, vt)
                    m = mn
                states.append((m, l, acc))
            mx = torch.stack([st[0] for st in states]).amax(0)
            lsum = sum(st[1] * torch.exp(st[0] - mx) for st in states)
            o = sum(st[2] * torch.exp(st[0] - mx)[..., None] for st in states)
            out[bi, row0:row0 + n] = (
                o / torch.clamp(lsum, min=1e-30)[..., None]).transpose(0, 1)
    return out


def _case(name, d, dv, seed=0):
    """Narrow versions of chip_smoke.py's fp32 flash cases (4/2 heads):
    the one-shot causal prefill, the ragged chunk under window 300 and
    softcap 50, serve-swap's chunk at 768 of 1024, and per-row offsets."""
    rng = np.random.default_rng(seed)
    b, sq, sk, off, kvl, window, cap = {
        "one-shot causal": (2, 128, 128, None, None, None, None),
        "chunk ragged window 300 softcap 50": (1, 200, 1024, (824,),
                                               (1024,), 300, 50.0),
        "chunk at 768 of 1024": (1, 256, 1024, (768,), (1024,), None,
                                 None),
        "per-row offsets": (3, 70, 600, (0, 200, 530), (70, 270, 600),
                            None, None),
    }[name]
    h, kvh = 4, 2
    q, k = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((b, sq, h, d), (b, sk, kvh, d)))
    v = torch.from_numpy(rng.normal(size=(b, sk, kvh, dv)).astype(np.float32))
    kw = dict(causal=True, window=window, softcap=cap)
    if off is not None:
        kw.update(q_offset=torch.tensor(off), kv_len=torch.tensor(kvl))
    return q, k, v, kw


CASES = ("one-shot causal", "chunk ragged window 300 softcap 50",
         "chunk at 768 of 1024", "per-row offsets")


@pytest.mark.parametrize("d,dv", [(16, 16), (64, 64), (64, 32)])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("splits", [1, 3])
def test_split_tf32_meets_the_fp32_bar(case, d, dv, splits):
    """3xTF32 over the kernel's tiles and splits is within 2e-5 of the
    plain fp32 flash."""
    q, k, v, kw = _case(case, d, dv)
    want = fa.flash_attention_plain(q, k, v, **kw)
    got = emulate(q, k, v, splits=splits, **kw)
    err = float((got - want).abs().max())
    assert err <= FP32_ATTN_TOL, err


@pytest.mark.parametrize("case", CASES)
def test_one_tf32_product_misses_the_fp32_bar(case):
    """Plain TF32 (each operand rounded once) moves the output far past
    2e-5: why the kernel takes three products."""
    q, k, v, kw = _case(case, 64, 64)
    want = fa.flash_attention_plain(q, k, v, **kw)
    err = float((emulate(q, k, v, mm=mm1, **kw) - want).abs().max())
    assert err > 10 * FP32_ATTN_TOL, err


def test_tf32_rounds_to_nearest_ties_away():
    """The bit-masking rounding: 10 mantissa bits kept, the 13 dropped
    ones rounded to nearest, a tie away from zero, either sign."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 3 * ulp / 2, 3.0e-3], dtype=torch.float32)
    got = tf32(x)
    assert got[0] == one + ulp and got[1] == -(one + ulp)
    assert got[2] == one and got[3] == one + 2 * ulp
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    hi, lo = split(x)
    assert (hi + lo - x).abs().max() <= 2.0 ** -21 * x.abs().max()
