"""Device time of the port's flash kernel at the families' prefill shapes,
for one or more checkouts side by side on one card.

    python3 scripts/flash_ab.py PARENT . . PARENT

Each argument is the root of a checkout (its ``src/repro_torch``); each is
run in a process of its own, in the order given, and prints one JSON line
``{"root": ..., "ms": {case: device ms}, "sm_mhz": {case: SM clock}}``, a
case the checkout cannot take as null; the SM clock is ``nvidia-smi``'s,
read right after the case's timing.  Run parent, change, change, parent
to see drift.  The timer is ``chip_smoke.Timer`` of this checkout (10
calls, the profiler's device records); the inputs are seeded, the same in
every process.  Needs a card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
GEMMA2 = dict(window=4096, softcap=50.0)
# case: (dtype, batch, q rows, keys, q_offset or None, heads, kv heads,
# q/k dim, v dim, options)
CASES = {
    "llama3-8b one-shot bf16": ("bf16", 8, 1024, 1024, None, 32, 8, 128, 128,
                                {}),
    "gemma2 one-shot bf16": ("bf16", 8, 1024, 1024, None, 8, 4, 256, 256,
                             GEMMA2),
    "gemma-7b one-shot bf16": ("bf16", 8, 1024, 1024, None, 16, 16, 256, 256,
                               {}),
    "chatglm3 one-shot bf16": ("bf16", 8, 1024, 1024, None, 32, 2, 128, 128,
                               {}),
    "granite one-shot bf16": ("bf16", 8, 1024, 1024, None, 16, 8, 64, 64, {}),
    "deepseek one-shot bf16": ("bf16", 8, 1024, 1024, None, 16, 16, 192, 128,
                               {}),
    "gemma2 chunk fp32 at 5888 of 6144": ("fp32", 1, 256, 6144, 5888, 8, 4,
                                          256, 256, GEMMA2),
    "granite chunk fp32 at 768 of 1024": ("fp32", 1, 256, 1024, 768, 16, 8,
                                          64, 64, {}),
}


def sm_clock() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def one(root: Path) -> tuple:
    """Times every case on the checkout at ``root``: (ms, SM clocks)."""
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.kernels import ops
    sys.path.insert(1, str(HERE))
    from chip_smoke import Timer
    if not Path(ops.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {ops.__file__}, not {root}'s")
    timer = Timer(torch, iters=10)
    out, clocks = {}, {}
    for i, (case, (dt, b, sq, sk, off, h, kvh, d, dv, kw)) in enumerate(
            CASES.items()):
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
                   for s in ((b, sq, h, d), (b, sk, kvh, d),
                             (b, sk, kvh, dv)))
        kwf = dict(causal=True, scale=d ** -0.5, **kw)
        if off is not None:
            kwf.update(q_offset=torch.full((b,), off, dtype=torch.int32,
                                           device="cuda"),
                       kv_len=torch.full((b,), off + sq, dtype=torch.int32,
                                         device="cuda"))
        try:
            ops.flash_attention(q, k, v, **kwf)
        except ValueError:          # a head-dim pair this checkout lacks
            out[case] = None
            continue
        out[case] = timer(lambda: ops.flash_attention(q, k, v, **kwf))
        clocks[case] = sm_clock()
        del q, k, v
    return out, clocks


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        root = Path(argv[1]).resolve()
        ms, clocks = one(root)
        print(json.dumps({"root": str(root), "ms": ms, "sm_mhz": clocks}),
              flush=True)
        return 0
    if not argv:
        raise SystemExit(__doc__)
    for root in argv:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
