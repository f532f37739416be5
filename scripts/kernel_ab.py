"""Device time of the port's flash kernels at the families' prefill
shapes, bf16 and fp32, of the fp32 flash backward at ``chip_smoke.py``'s
``BWD_CASES`` and of the RMSNorm backward at the train shape, for one or
more checkouts side by side on one card.

    python3 scripts/kernel_ab.py [-k TEXT] PARENT . . PARENT

``-k TEXT`` times only the cases whose name holds TEXT.  Each other
argument is the root of a checkout (its ``src/repro_torch``); each is
run in a process of its own, in the order given, and prints one JSON line
``{"root": ..., "ms": {case: device ms}, "by_kernel": {case: {kernel:
ms}}, "sdpa_ms": {case: ms}, "sm_mhz": {case: SM clock}}``, a case the
checkout cannot take as null, SDPA's time on each flash case's inputs
(``chip_smoke.sdpa_ms``; for a backward case SDPA's fp32 backward through
autograd, where there is no softcap and no window; the first process
only: it does not depend on the checkout); the SM clock is
``nvidia-smi``'s, read right after the case's timing.  Run parent,
change, change, parent to see drift.  The cases are the shapes
``chip_smoke.py`` of this checkout times, from its constants and the
configs; the timer is its ``Timer`` (10 calls, the profiler's device
records, which also give each case's ms by kernel); the inputs are
seeded, the same in every process.  Only the flash (forward and
backward) and RMSNorm libraries are built.  Needs a card.
"""
from __future__ import annotations

import functools
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
# the RMSNorm backward at llama3-8b's train shape: (form, dtype)
RMS_BWD_CASES = (("add_rmsnorm", "bf16"), ("rmsnorm", "bf16"),
                 ("add_rmsnorm", "fp32"), ("rmsnorm", "fp32"))


def flash_cases(cs):
    """case: (dtype, arch, batch, q rows, keys, q_offset or None, options),
    the flash shapes ``chip_smoke.py`` (``cs``) times, from its constants;
    each arch's heads and head dims come from its config."""
    g2 = dict(window=cs.GEMMA2_WINDOW, softcap=cs.GEMMA2_SOFTCAP)
    nc = dict(causal=False)
    llama, gemma2, granite = "llama3-8b", "gemma2-2b", "granite-moe-1b-a400m"
    one, chunk = (cs.SLOTS, cs.CTX, cs.CTX, None), (1, cs.CHUNK, cs.CTX,
                                                     cs.CTX - cs.CHUNK)
    rag = cs.RAGGED_CHUNK
    return {
        "llama3-8b one-shot bf16": ("bf16", llama, *one, {}),
        "gemma2 one-shot bf16": ("bf16", gemma2, *one, g2),
        "gemma-7b one-shot bf16": ("bf16", "gemma-7b", *one, {}),
        "chatglm3 one-shot bf16": ("bf16", "chatglm3-6b", *one, {}),
        "granite one-shot bf16": ("bf16", granite, *one, {}),
        "deepseek one-shot bf16": ("bf16", cs.DEEPSEEK, *one, {}),
        "serve-swap chunk fp32 at 768 of 1024": ("fp32", llama, *chunk, {}),
        "gemma2 chunk fp32 at 5888 of 6144": (
            "fp32", gemma2, 1, cs.CHUNK, cs.LONG_CTX,
            cs.LONG_CTX - cs.CHUNK, g2),
        "granite chunk fp32 at 768 of 1024": ("fp32", granite, *chunk, {}),
        "deepseek one-shot fp32 (1, 256)": (
            "fp32", cs.DEEPSEEK, 1, cs.CHUNK, cs.CHUNK, None, {}),
        "seamless encoder fp32 (8, 1024), not causal": (
            "fp32", cs.SEAMLESS, cs.SLOTS, cs.ENC_FRAMES, cs.ENC_FRAMES, None,
            nc),
        "seamless cross fp32 (8, 16) against 1024": (
            "fp32", cs.SEAMLESS, cs.SLOTS, cs.SEAMLESS_PROMPT, cs.ENC_FRAMES,
            None, nc),
        "seamless cross fp32 (8, 128) against 1024": (
            "fp32", cs.SEAMLESS, cs.SLOTS, cs.SEAMLESS_CROSS_Q,
            cs.ENC_FRAMES, None, nc),
        "seamless encoder ragged fp32 (8, 1000), not causal": (
            "fp32", cs.SEAMLESS, cs.SLOTS, 1000, 1000, None, nc),
        "seamless decoder self-prefill fp32 (8, 16)": (
            "fp32", cs.SEAMLESS, cs.SLOTS, cs.SEAMLESS_PROMPT,
            cs.SEAMLESS_PROMPT, None, {}),
        "llama3-8b one-shot fp32 (2, 1024)": ("fp32", llama, 2, cs.CTX,
                                              cs.CTX, None, {}),
        "llama3-8b chunk fp32 (1, 200) at 824, window 300 softcap 50": (
            "fp32", llama, 1, rag, cs.CTX, cs.CTX - rag,
            dict(window=300, softcap=50.0)),
    }


def head_dims(arch):
    """(heads, kv heads, q/k dim, v dim) of ``arch``'s attention."""
    from repro_torch.configs import get_config
    c = get_config(arch)
    if c.mla is not None:
        return (c.num_heads, c.num_heads, c.mla.qk_head_dim,
                c.mla.v_head_dim)
    return (c.num_heads, c.num_kv_heads, c.resolved_head_dim,
            c.resolved_head_dim)


def sm_clock() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def one(root: Path, with_sdpa: bool, only: str = "") -> tuple:
    """Times every case (whose name holds ``only``) on the checkout at
    ``root``: (ms, ms by kernel, SM clocks, SDPA's ms where asked)."""
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    sys.path.insert(1, str(HERE))
    import chip_smoke as cs
    if not Path(ops.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {ops.__file__}, not {root}'s")
    _build.build = functools.partial(
        _build.build, ("flash_attention", "flash_attention_bwd", "rmsnorm"))
    timer = cs.Timer(torch, iters=10)
    out, split, clocks, sdpa = {}, {}, {}, {}
    for i, (case, (dt, arch, b, sq, sk, off, kw)) in enumerate(
            flash_cases(cs).items()):
        if only not in case:
            continue
        h, kvh, d, dv = head_dims(arch)
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
                   for s in ((b, sq, h, d), (b, sk, kvh, d),
                             (b, sk, kvh, dv)))
        kwf = {"causal": True, "scale": d ** -0.5, **kw}
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
        split[case] = cs._by_kernel(timer.split)
        clocks[case] = sm_clock()
        if with_sdpa:
            sdpa[case] = cs.sdpa_ms(
                torch, timer, q, k, v, causal=kwf["causal"], q_offset=off,
                kv_len=kwf.get("kv_len"), window=kwf.get("window"))
        del q, k, v
    for i, (name, b, sq, h, kvh, d, dv, causal, window, cap,
            dts) in enumerate(cs.BWD_CASES):
        case = f"flash_attention_bwd {name} ({b}, {sq}) fp32"
        if "fp32" not in dts or only not in case:
            continue
        gen = torch.Generator(device="cuda").manual_seed(200 + i)
        q, k, v, dout = (torch.randn(s, generator=gen, device="cuda")
                         for s in ((b, sq, h, d), (b, sq, kvh, d),
                                   (b, sq, kvh, dv), (b, sq, h, dv)))
        kw = dict(causal=causal, window=window, softcap=cap)
        o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        out[case] = timer(lambda: fa.flash_attention_bwd_cuda(
            q, k, v, o, dout, lse, **kw))
        split[case] = cs._by_kernel(timer.split)
        clocks[case] = sm_clock()
        if with_sdpa and window is None and cap is None:
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                          for x in (q, k, v))
            o_l = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)
            g_l = dout.transpose(1, 2)
            sdpa[case] = timer(lambda: torch.autograd.grad(
                o_l, (qt, kt, vt), g_l, retain_graph=True))
            del o_l, qt, kt, vt
        del q, k, v, dout, o, lse
        torch.cuda.empty_cache()
    rows, width = cs.RMS_BWD_SHAPE
    for form, dt in RMS_BWD_CASES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        gen = torch.Generator(device="cuda").manual_seed(7)
        s, dy, ds = (torch.randn((rows, width), generator=gen,
                                 device="cuda").to(dtype) for _ in range(3))
        w = (1 + 0.1 * torch.randn((width,), generator=gen,
                                   device="cuda")).to(dtype)
        ds = ds if form == "add_rmsnorm" else None
        case = f"rmsnorm_bwd {form} ({rows}, {width}) {dt}"
        if only not in case:
            continue
        out[case] = timer(lambda: rn.rmsnorm_bwd_cuda(s, dy, w, 1e-5, ds=ds))
        split[case] = cs._by_kernel(timer.split)
        clocks[case] = sm_clock()
        del s, dy, ds, w
    return out, split, clocks, sdpa


def main(argv) -> int:
    only = ""
    if len(argv) >= 2 and argv[0] == "-k":
        only, argv = argv[1], argv[2:]
    if len(argv) == 2 and argv[0] in ("--one", "--one-sdpa"):
        root = Path(argv[1]).resolve()
        ms, split, clocks, sdpa = one(root, argv[0] == "--one-sdpa", only)
        print(json.dumps({"root": str(root), "ms": ms, "by_kernel": split,
                          "sdpa_ms": sdpa, "sm_mhz": clocks}), flush=True)
        return 0
    if not argv:
        raise SystemExit(__doc__)
    for i, root in enumerate(argv):
        subprocess.run([sys.executable, __file__, "-k", only,
                        "--one-sdpa" if i == 0 else "--one", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
