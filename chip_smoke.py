#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of RAGDoll on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # everything, as the acceptance run does

Phases, each of which fails the run (non-zero exit, no result line):

1. device  -- a CUDA card must be present; prints its name and power limit.
2. build   -- compiles every hand-written kernel from ``src/repro_torch``;
              prints the registers and spills of the redesigned attention
              kernels and their launch shapes at the main paths' sizes.
3. corpus  -- ``blob_corpus(1_000_000, 768)`` in 64 IVF partitions, a
              quarter of them spilled to disk under ``build/``.
4. kernels -- each kernel against its plain PyTorch version at the main
              paths' shapes, with its time, the plain version's, one
              library call's and the card's bound for the same work; the
              RMSNorm fused with the residual add (``add_rmsnorm``) also
              with its wrapper's host time per call.
5. model   -- a reduced llama on the card (kernels) against the same
              weights on the CPU (plain versions): logits and tokens of
              chunked prefill + paged decode, and of one-shot prefill +
              dense decode.
6. serve   -- llama3-8b at full width (bf16, seeded random weights) behind a
              threaded ``RagdollEngine`` with a paged, chunk-prefilled
              ``ContinuousGenerator``: 16 RAG requests, each checked for 32
              tokens and for its 5 retrieved chunks against an exact search.
7. serve-batch -- the same weights behind a ``RagdollEngine`` with the
              whole-batch ``Generator`` (one-shot prefill, dense cache),
              then behind ``SerialRAGEngine`` (the paper's serial baseline,
              as ``launch/serve.py --serial`` runs it): the same 16
              requests and checks.
8. serve-swap -- memory pressure: the same weights and 16 requests (the
              last 4 priority 1) through an int8-paged, chunk-prefilled
              ``ContinuousGenerator`` whose page budget is the device bytes
              of two worst-case bf16 requests, with a host pool for every
              slot and overlapped swaps, behind ``RagdollEngine(
              partial_swap=True)`` pumped single-threaded; at least one
              swap, every swap back in, nothing left parked, and every
              request's tokens equal to the same int8 generator's with
              pages for every slot and no host pool.
9. serve-prefix -- recurring RAG prompts: the same weights, the
              continuous path's generator at a ragged context of 1022
              (``CTX - 2``), 16 requests asking 4 queries 4 times each,
              pumped single-threaded, four runs: no prefix cache (the
              tokens to match); the radix prefix cache (fewer prompt tokens
              prefilled per join, prefix hits, copy-on-write copies); the
              cache under a device budget of one prompt's pages with a host
              pool (pages demoted and revived); and run 2's generator
              retargeted to 4 slots, half the pages and no cached device
              pages (the dropped pages' device bytes must come back), then
              the same requests again.  Every run's tokens must equal the
              first's, or leave them first at a near tie: where the two
              choices' logits, recomputed in fp32, lie within twice the bf16
              logits' own error of that row (a hit computes the prompt's
              last token in another matmul shape than a miss does, so bf16
              rounds it otherwise).
10. serve-streamed -- the paper's layer-streamed offloading on the same
              weights: a ``StreamedExecutor`` keeps ``top`` on the card and
              the 32 layers in pinned host memory (construction time,
              streamed bytes, the device bytes it holds, which must stay
              within ``top`` plus ``max_depth + 1`` layers); (a) a streamed
              whole-batch ``Generator`` on 8 of serve's prompts must give
              the resident one's tokens exactly; (b) the streamed paged,
              chunk-prefilled ``ContinuousGenerator`` behind a threaded
              ``RagdollEngine`` serves the 16 requests (p50, p95, tokens/s,
              passes, bytes staged) with serve's tokens, or leaves them
              first at a near tie witnessed in fp32 (joiners' chunks ride
              one padded call, other matmul shapes than serve's); then one
              layer's pinned copy rate, the mean decode pass against its
              copy bound, and one profiled decode pass: busy share, copy
              share and how much of the copy time overlaps a kernel.
11. store    -- recluster: a 100k x 768 store of its own in 16 partitions
              (4 spilled, 2 hot): exact ids equal the plain top-k before
              and after ``recluster``, the hot set empties, no spill file
              of the old layout survives, ``resident_bytes`` equals its
              resident partitions' bytes.
12. serve-placement -- the placement optimizer on the card, last (its
              partition cache releases partitions to disk): (a) the
              ``HardwareProfile`` fields measured here (bf16 matmul,
              device copy, total memory, host memory, pinned host-to-device
              copy, cold partition loads, numpy fp32 product) beside
              ``H100_HOST``, and one partition swept cold (pin, copy,
              kernel) and hot (kernel); (b) active profiling over batches
              of 1-8 with a real retrieval and a real generation batch of
              each, seeding the batch schedulers; (c) the continuous path
              (the serve generator) behind a threaded ``RagdollEngine(
              optimizer=..., policy_every=8)`` and (d) the whole-batch
              ``Generator`` behind ``RagdollEngine(optimizer=...)``, each
              serving 16 requests drawn from 4 queries: 32 tokens each,
              ids equal to the plain search at the probe width their batch
              was retrieved with, recall@5, the policy trace, the
              boundary's host time, ``metrics_snapshot``, p50 and p95 (the
              whole-batch p50 beside serve-batch's and serve-serial's);
              (e) 4 partitions promoted to the hot tier under a grant of
              their bytes: hot boards and a search at nprobe 16 bit-equal
              to the cold ones, a served batch with hot hits; (f) a page
              pool for 1024 requests' KV, which the card cannot hold,
              through ``OOMRecovery.run``: it must demote and succeed, and
              ``memory_allocated`` must come back to its level.

Each serving path is driven with the launch counts set to 0 just before its
16 measured requests and read just after; a kernel the path should run
that launched no time fails the run (serve-placement: each policy path,
and the hot tier's served batch for the two retrieval kernels).  serve,
serve-batch and serve-serial then each profile one decode step of their
model and print its device kernels, fused and with every residual add a
launch of its own.  The line before the last is
``{"kernels": [...]}`` (``launches``: the sum over the measured runs of
every path); the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import functools
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 rate and dense peaks (no sparsity)
HBM_BYTES_PER_S = 3.35e12
PEAK_FP32 = 67e12           # CUDA cores
PEAK_BF16 = 989e12          # tensor cores, bf16 in, fp32 accumulation

# llama3-8b serving shapes of the main paths
CTX, MAX_NEW, PAGE, CHUNK, SLOTS = 1024, 32, 16, 256, 8
HEADS, KV_HEADS, HEAD_DIM = 32, 8, 128
RAGGED_CHUNK = 200          # a prefill chunk shorter than the kernel's tiles
# short and long slots in one decode step: empty, partial and full splits
MIXED_LENGTHS = (1, 17, 300, 1056, 1, 17, 300, 1056)
SERIAL_BATCH = 4            # launch/serve.py --serial
N_REQ, WARMUP_REQ, PROFILE_REQ, TOP_K = 16, 2, 8, 5
CORPUS_N, CORPUS_DIM, PARTITIONS, SPILLED = 1_000_000, 768, 64, 16

FP32_ATTN_TOL = 2e-5        # fp32 pages: sum order only
TOPK_SCORE_TOL = 1e-4       # fp32 dot products of unit vectors
BF16_RTOL = 1.6e-2          # bf16 outputs: about one bf16 ulp (2**-7) twice
BF16_ATOL = 1e-5            # fp32 noise below a bf16 ulp near zero
RMSNORM_FP32_TOL = 1e-5
TIE_GAP = 1e-5              # ids must match where neighbours differ by more
MODEL_LOGIT_TOL = 1e-4      # reduced model, fp32, card vs CPU
P_ROUND = 2.0 ** -8         # bf16 attention kernels: P in bf16 (2**-9) vs fp32

# kernels each serving path must launch in its measured run
CONTINUOUS_KERNELS = ("rmsnorm", "paged_decode_attention", "retrieval_topk",
                      "retrieval_topk_merge", "flash_attention")
WHOLE_BATCH_KERNELS = ("rmsnorm", "flash_attention", "decode_attention",
                       "retrieval_topk", "retrieval_topk_merge")
SWAP_KERNELS = ("rmsnorm", "paged_decode_attention", "retrieval_topk",
                "retrieval_topk_merge", "flash_attention")
SWAP_PRIORITY_REQ = 4       # serve-swap: the last 4 requests are priority 1
# serve-prefix: a ragged context (a boundary-page copy at join, the
# donor's tail page detached copy-on-write on its first decode step), and
# 4 queries asked 4 times each, in three rounds, each served to its end:
# 8 requests (all misses: nothing is cached until a prefill ends), then
# queries 0 and 1 twice, then 2 and 3 twice (under a small cache budget
# the second round's inserts demote the prompts of 2 and 3, and the third
# round revives them).  The pool has room for the 4 cached prompts beside
# the 8 slots' worst cases, so a cached page never takes a slot's pages.
PREFIX_CTX = CTX - 2
PREFIX_ROUNDS = ((0, 1, 2, 3, 0, 1, 2, 3), (0, 0, 1, 1), (2, 2, 3, 3))
PREFIX_SLOTS_AFTER = 4      # run 4: slots after the retarget
# serve-placement: the placement optimizer on the card.  16 requests drawn
# from 4 queries (so the probe heat concentrates), active profiling over
# batches of 1-8, the continuous path's kernels on its policy path; a hot
# tier of 4 partitions under a probe of a quarter of the partitions; an
# OOM provoked by a page pool for 1024 requests' KV (142 GB in bf16)
SERVE_PLACEMENT_KERNELS = CONTINUOUS_KERNELS
PLACEMENT_QUERIES = 4
PLACEMENT_BATCHES = (1, 2, 4, 8)
HOT_N = 4
HOT_NPROBE = PARTITIONS // 4
OOM_BATCH = 1024
# the recluster check's store, apart from the shared one
RECLUSTER_N, RECLUSTER_PARTS, RECLUSTER_SPILLED, RECLUSTER_HOT = (
    100_000, 16, 4, 2)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---------------------------------------------------------------- timing
def _kernel_records(prof, torch):
    """(name, start us, duration us) of every device record of a trace."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name, e.time_range.start, e.time_range.elapsed_us())
            for e in prof.events() if e.device_type == cuda]


class Timer:
    """Device time of one call: the profiler's (CUPTI) records of the
    kernels the call launched, summed, averaged over ``iters`` calls; a
    trace short of any call's records is taken again.
    ``cold`` overwrites the 50 MB L2 (a 256 MiB device-to-device copy,
    left out of the sum) before each call, for inputs the main path finds
    cold: the KV pages of a layer and a freshly copied partition."""

    def __init__(self, torch, iters: int = 20):
        self.torch = torch
        self.iters = iters
        self.src = torch.empty(2 ** 28, dtype=torch.uint8, device="cuda")
        self.dst = torch.empty_like(self.src)
        # start the profiler's tracing before any kernel library loads its
        # module: a kernel first launched before the first session went
        # unrecorded on the card
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            self.dst.copy_(self.src)
            torch.cuda.synchronize()

    def __call__(self, fn, cold: bool = False) -> float:
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        def device_records(calls):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    if cold:
                        self.dst.copy_(self.src)
                    fn()
                torch.cuda.synchronize()
            return [r for r in _kernel_records(prof, torch)
                    if not (cold and r[0].startswith("Memcpy DtoD"))]

        fn()
        torch.cuda.synchronize()
        # a trace that lost records would read as a faster kernel: take
        # only a trace that holds every launch of every call (a one-call
        # trace that lost them all is taken again too)
        per_call = 0
        for _ in range(3):
            per_call = len(device_records(1))
            if per_call:
                break
        for _ in range(3):
            recs = device_records(self.iters)
            if len(recs) >= per_call * self.iters:
                break
        else:
            fail(f"the profiler recorded {len(recs)} device records for "
                 f"{self.iters} calls of {per_call}")
        us = sum(d for _, _, d in recs)
        if us <= 0:
            fail("the profiler recorded no device time")
        return us / self.iters / 1e3


def host_us(torch, fn, calls: int = 1000, rounds: int = 5) -> float:
    """Host microseconds per call of ``fn`` over ``calls`` calls with no
    synchronisation between them (the launch queue absorbs the kernels);
    the least of ``rounds`` such runs, since other work on a shared host
    only ever adds time."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best / calls * 1e6


@functools.lru_cache(maxsize=None)
def _triton_add_rmsnorm():
    """A Triton kernel of the fused norm (yardstick only), or None."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    try:
        import triton
        import triton.language as tl
    except ImportError:
        return None

    @triton.jit
    def add_rmsnorm_kernel(x_ptr, r_ptr, w_ptr, s_ptr, y_ptr, d, eps,
                           BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        offs = tl.arange(0, BLOCK)
        live = offs < d
        a = tl.load(x_ptr + row * d + offs, mask=live, other=0.0)
        b = tl.load(r_ptr + row * d + offs, mask=live, other=0.0)
        s = (a.to(tl.float32) + b.to(tl.float32)).to(s_ptr.dtype.element_ty)
        tl.store(s_ptr + row * d + offs, s, mask=live)
        sf = s.to(tl.float32)
        var = tl.sum(sf * sf, axis=0) / d
        wf = tl.load(w_ptr + offs, mask=live, other=0.0).to(tl.float32)
        tl.store(y_ptr + row * d + offs,
                 (sf * tl.rsqrt(var + eps) * wf).to(y_ptr.dtype.element_ty),
                 mask=live)

    return triton, add_rmsnorm_kernel


def triton_add_rmsnorm_us(torch, x, r, w):
    """Host microseconds per call of a Triton launch of the same fused
    norm, wrapper and output allocation included: the yardstick for the
    port's ctypes launch.  The port runs no Triton; None without it."""
    built = _triton_add_rmsnorm()
    if built is None:
        return None
    triton, kernel = built
    d = x.shape[-1]
    block = triton.next_power_of_2(d)

    def call():
        s, y = torch.empty_like(x), torch.empty_like(x)
        kernel[(x.shape[0],)](x, r, w, s, y, d, 1e-5, BLOCK=block,
                              num_warps=min(16, max(1, block // 256)))
        return s, y

    return host_us(torch, call)


def bound_ms(nbytes: float, ops: float, peak: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ comparisons
def check_close(name, got, want, *, atol, rtol=0.0) -> float:
    err = (got.double() - want.double()).abs()
    bad = err > atol + rtol * want.double().abs()
    if not bool(bad.any()) and bool(got.isfinite().all()):
        return float(err.max())
    atol = float(atol.max()) if hasattr(atol, "max") else atol
    fail(f"{name}: {int(bad.sum())} elements off (max err "
         f"{float(err.max()):.3e}, atol up to {atol}, rtol {rtol})")


def check_attention(name, got, want, wmean_abs_v) -> float:
    """bf16 attention kernels against their plain versions: the kernel
    rounds P to bf16 where the plain version keeps it fp32 (flash) or
    rounds the normalized P (decode), at most 2**-9 of the softmax-weighted
    mean of |v| per element; both round the output to bf16."""
    return check_close(name, got, want, atol=P_ROUND * wmean_abs_v.double()
                       + BF16_ATOL, rtol=BF16_RTOL)


def check_topk(name, got_s, got_i, want_s, want_i) -> float:
    err = check_close(name + " scores", got_s, want_s, atol=TOPK_SCORE_TOL)
    ws = want_s.double()
    close = (ws[:, 1:] - ws[:, :-1]).abs() <= TIE_GAP
    sep = ws.new_ones(ws.shape, dtype=bool)
    sep[:, 1:] &= ~close
    sep[:, :-1] &= ~close
    if not bool(((got_i.long() == want_i.long()) | ~sep).all()):
        fail(f"{name}: ids differ where scores are {TIE_GAP} apart")
    return err


# ----------------------------------------------------------------- phases
def phase_device(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"capability {torch.cuda.get_device_capability(0)} "
        f"count {torch.cuda.device_count()}")
    return name, smi


# the redesigned kernels' variants on the main paths (demangled names)
REDESIGNED = ("flash_wgmma_kernel<128,",
              "merge_kernel",
              "decode_kernel<__nv_bfloat16, __nv_bfloat16, 4, 4>",
              "decode_combine_kernel<__nv_bfloat16>",
              "topk_stream_kernel",
              "rmsnorm_kernel<__nv_bfloat16, __nv_bfloat16, true, 8>",
              "rmsnorm_kernel<__nv_bfloat16, __nv_bfloat16, false, 8>")


def ptxas_entries(log_text: str):
    """(kernel, registers, spill line) of each entry in a -Xptxas -v log."""
    out, name, spill = [], None, ""
    for line in log_text.splitlines():
        if "Function properties for" in line:
            name, spill = line.split("Function properties for", 1)[1].strip(), ""
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name is not None:
            out.append((name, line.split("Used", 1)[1].split(",")[0].strip(),
                        spill))
            name = None
    filt = shutil.which("c++filt")
    if filt and out:
        names = subprocess.run([filt], input="\n".join(n for n, _, _ in out),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
        if len(names) == len(out):
            out = [(n.replace("(anonymous namespace)::", ""), r, sp)
                   for n, (_, r, sp) in zip(names, out)]
    return out


def phase_build(torch):
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.decode_attention import DENSE_GRANULE
    t0 = time.perf_counter()
    libs = _build.build()
    t_nvcc = time.perf_counter() - t0
    for name, path in libs.items():
        if name == "rmsnorm":           # one line per variant: see below
            continue
        for line in (path.parent / f"{name}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] nvcc {t_nvcc:.1f} s for {sorted(libs)} "
        f"in {path.parent.relative_to(ROOT)}")
    # the redesigned kernels: registers and spills, and their launch shapes
    # at the main paths' sizes
    for name in ("flash_attention", "paged_attention", "decode_attention",
                 "topk_retrieval", "rmsnorm"):
        text = (libs[name].parent / f"{name}.log").read_text()
        for kern, regs, spill in ptxas_entries(text):
            if any(k in kern for k in REDESIGNED):
                log(f"[build] {kern[:150]}: {regs}; {spill}")
    for case, b, sq in (("one-shot", SLOTS, CTX), ("chunk", 1, CHUNK)):
        shp = fa.launch_shape(b, sq, HEADS, HEAD_DIM)
        log(f"[build] flash_wgmma_kernel {case} ({b} x {sq}): "
            f"{shp['blocks']} persistent blocks x {shp['threads']} threads "
            f"over {shp['items']} q tiles of {shp['rows']} rows, "
            f"{shp['consumers']} consumer warpgroup(s) of 64 rows, "
            f"{shp['stages']} K/V stages, {shp['smem']} B shared")
    warps, stages, unit = pa.launch_shape()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    total = CTX + MAX_NEW
    for kname, span, gran in (("paged_decode_kernel", -(-total // PAGE) * PAGE,
                               PAGE),
                              ("dense_decode_kernel", total, DENSE_GRANULE)):
        splits, split_len = pa.decode_splits(SLOTS, KV_HEADS, span, gran, sms)
        log(f"[build] {kname} ({SLOTS} slots x {span} tokens): grid "
            f"({KV_HEADS}, {SLOTS}, {splits}) x {warps * 32} threads, "
            f"{splits} splits of {split_len} tokens, {stages}-stage cp.async "
            f"ring of {unit} tokens; merge pass "
            f"{'grid (%d, %d)' % (KV_HEADS, SLOTS) if splits > 1 else 'none'}")


def phase_corpus(torch, store_root: Path):
    from repro_torch.retrieval import VectorStore
    from repro_torch.retrieval.synthetic import (ArrayEmbedder, blob_corpus,
                                                 perturb_queries)
    t0 = time.perf_counter()
    vecs = blob_corpus(CORPUS_N, CORPUS_DIM, clusters=PARTITIONS, seed=0)
    queries = perturb_queries(vecs, WARMUP_REQ + N_REQ + PROFILE_REQ,
                              seed=1)
    t1 = time.perf_counter()
    store = VectorStore.build([str(i) for i in range(CORPUS_N)],
                              ArrayEmbedder(vecs), num_partitions=PARTITIONS,
                              root=str(store_root), device="cuda")
    for pid in range(PARTITIONS - SPILLED, PARTITIONS):
        store.spill(pid)
    t2 = time.perf_counter()
    # exact answers for every query (the plain top-k over the whole corpus)
    from repro_torch.kernels import ops
    dev_vecs = torch.from_numpy(vecs).cuda()
    exact = ops.retrieval_topk(torch.from_numpy(queries).cuda(), dev_vecs,
                               TOP_K, impl="ref")
    del dev_vecs
    sizes = [len(p.doc_ids) for p in store.partitions.values()]
    log(f"[corpus] {CORPUS_N} x {CORPUS_DIM} fp32 "
        f"({vecs.nbytes / 1e9:.2f} GB) in {t1 - t0:.1f} s; {PARTITIONS} "
        f"k-means partitions ({min(sizes)}..{max(sizes)} rows) and "
        f"{SPILLED} spilled in {t2 - t1:.1f} s")
    del vecs
    return store, queries, exact


def _paged_case(torch, gen, *, q_dtype, kv_dtype, dead_slot=True,
                lengths=None):
    """The decode step's shapes: 8 slots over ctx + max_new tokens
    (``lengths``: the slots' kv_len in place of ctx+1 .. ctx+max_new)."""
    h, kvh, d = 32, 8, 128
    total = CTX + MAX_NEW
    nmax = -(-total // PAGE)
    pages = SLOTS * nmax + 1
    if kv_dtype == torch.int8:
        k = torch.randint(-127, 128, (pages, PAGE, kvh, d), generator=gen,
                          device="cuda", dtype=torch.int8)
        v = torch.randint(-127, 128, (pages, PAGE, kvh, d), generator=gen,
                          device="cuda", dtype=torch.int8)
        scales = [torch.rand((pages, kvh), generator=gen, device="cuda")
                  * 0.015 + 0.005 for _ in range(2)]
    else:
        k = torch.randn((pages, PAGE, kvh, d), generator=gen,
                        device="cuda").to(kv_dtype)
        v = torch.randn((pages, PAGE, kvh, d), generator=gen,
                        device="cuda").to(kv_dtype)
        scales = [None, None]
    q = torch.randn((SLOTS, h, d), generator=gen, device="cuda").to(q_dtype)
    perm = torch.randperm(pages - 1, generator=gen, device="cuda") + 1
    tab = perm[:SLOTS * nmax].reshape(SLOTS, nmax).to(torch.int32)
    kv_len = torch.randint(CTX + 1, total + 1, (SLOTS,), generator=gen,
                           device="cuda", dtype=torch.int32)
    if lengths is not None:
        kv_len = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    if dead_slot:                  # a finished slot riding the step
        tab[-1] = 0
        kv_len[-1] = total
    return q, k, v, tab, kv_len, scales


def _paged_bytes_ops(torch, q, k, tab, kv_len, window, scales):
    """Bytes the step must move and operations it does.  A K/V row is
    counted once however many live tokens map to it: the dead slot's
    table points every entry at trash page 0, so its 1056 tokens need
    one page's rows from memory."""
    b, h, d = q.shape
    kvh = k.shape[2]
    lens, tab = kv_len.long().cpu(), tab.long().cpu()
    rows, entries = [], 0           # (page * PAGE + offset) of live tokens
    for i in range(b):
        n = int(lens[i])
        lo = max(0, n - window) if window else 0
        pos = torch.arange(lo, n)
        rows.append(tab[i, pos // PAGE] * PAGE + pos % PAGE)
        entries += (n - 1) // PAGE - lo // PAGE + 1
    rows = torch.cat(rows)
    distinct = int(rows.unique().numel())
    nbytes = (2 * distinct * kvh * d * k.element_size()    # K and V rows
              + 2 * q.numel() * q.element_size()           # q in, out
              + entries * 4 + b * 4)                       # table, lengths
    if scales[0] is not None:
        nbytes += 2 * int((rows // PAGE).unique().numel()) * kvh * 4
    ops = 4 * int(rows.numel()) * h * d                    # q.k and p.v
    return nbytes, ops


def _flash_bytes_ops(torch, q, k, kv_len, q_offset, window):
    """Bytes of q, k, v and o, each moved once, and 4 * D flops per
    unmasked (query, key) pair and head (causal)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    offs = (q_offset.long().cpu() if torch.is_tensor(q_offset)
            else torch.full((b,), q_offset, dtype=torch.long))
    lens = (kv_len.long().cpu() if kv_len is not None
            else torch.full((b,), sk, dtype=torch.long))
    q_pos = offs[:, None] + torch.arange(sq)                   # (B, Sq)
    hi = torch.minimum(lens[:, None], q_pos + 1)
    lo = (q_pos - window + 1).clamp(min=0) if window else torch.zeros_like(hi)
    pairs = int((hi - lo).clamp(min=0).sum())
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() + 8 * b
    return nbytes, 4 * pairs * h * d


def _decode_bytes_ops(torch, q, k, kv_len, window):
    """The live K/V rows, q and o, moved once; 4 * D flops per live
    (token, head)."""
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    lens = kv_len.long().cpu().clamp(max=s)
    lo = (lens - window).clamp(min=0) if window else torch.zeros_like(lens)
    live = int((lens - lo).sum())
    nbytes = (2 * live * kvh * d * k.element_size()
              + 2 * q.numel() * q.element_size() + 4 * b)
    return nbytes, 4 * live * h * d


def phase_kernels(torch, timer, store, queries):
    """Each kernel against its plain version at the main path's shapes.
    Returns the JSON entries (launch counts filled in after serving)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = {}

    def report(name, case, got_err, ms, plain_ms, lib_ms, bound):
        b_ms, b_by = bound
        lib = "null" if lib_ms is None else f"{lib_ms:.4f}"
        log(f"[kernel] {name} {case}: max_abs_err {got_err:.3e} "
            f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib} "
            f"bound_ms {b_ms:.5f} ({b_by}) -> {b_ms / ms:.1%} of bound")
        return dict(max_abs_err=got_err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)

    # ---- rmsnorm: decode (8 rows) and a prefill chunk (256 rows)
    for t, dt in ((SLOTS, torch.bfloat16), (CHUNK, torch.bfloat16),
                  (SLOTS, torch.float32), (CHUNK, torch.float32)):
        x = torch.randn((t, 4096), generator=gen, device="cuda").to(dt)
        w = (1 + 0.1 * torch.randn((4096,), generator=gen,
                                   device="cuda")).to(dt)
        got = ops.rmsnorm(x, w, 1e-5)
        want = ops.rmsnorm(x, w, 1e-5, impl="ref")
        if dt == torch.float32:
            err = check_close("rmsnorm", got, want, atol=RMSNORM_FP32_TOL)
        else:
            err = check_close("rmsnorm", got, want, atol=BF16_ATOL,
                              rtol=BF16_RTOL)
        nbytes = 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
        r = report("rmsnorm", f"({t}, 4096) {str(dt)[6:]}", err,
                   timer(lambda: ops.rmsnorm(x, w, 1e-5)),
                   timer(lambda: ops.rmsnorm(x, w, 1e-5, impl="ref")),
                   timer(lambda: F.rms_norm(x, (4096,), w, 1e-5)),
                   bound_ms(nbytes, 4 * x.numel(), PEAK_FP32))

    # ---- add_rmsnorm: the residual add fused into the norm (64 of a
    # forward's 65 norms); its kernel is the rmsnorm entry's main-path case
    q_host = torch.from_numpy(queries[:SLOTS]).cuda()
    db_host = q_host[:3].clone()         # a 3-row database: host cost only
    topk_us = host_us(torch, lambda: ops.retrieval_topk(q_host, db_host,
                                                        TOP_K))
    for t, dt in ((SLOTS, torch.bfloat16), (CHUNK, torch.bfloat16),
                  (SLOTS, torch.float32), (CHUNK, torch.float32)):
        x = torch.randn((t, 4096), generator=gen, device="cuda").to(dt)
        res = torch.randn((t, 4096), generator=gen, device="cuda").to(dt)
        w = (1 + 0.1 * torch.randn((4096,), generator=gen,
                                   device="cuda")).to(dt)
        got_s, got = ops.add_rmsnorm(x, res, w, 1e-5)
        if not torch.equal(got_s, x + res):
            fail(f"add_rmsnorm ({t}, 4096) {dt}: s differs from x + r")
        want = ops.rmsnorm(got_s, w, 1e-5, impl="ref")
        if dt == torch.float32:
            err = check_close("add_rmsnorm", got, want, atol=RMSNORM_FP32_TOL)
        else:
            err = check_close("add_rmsnorm", got, want, atol=BF16_ATOL,
                              rtol=BF16_RTOL)
        # read x, r and w once, write s and y once.  A decode step's 8 rows
        # are launch-bound and just written (timed warm, as the plain norm
        # is); a prefill chunk's 256 rows are byte-bound (timed cold)
        nbytes = 4 * x.numel() * x.element_size() + w.numel() * w.element_size()
        cold = t == CHUNK
        case = f"({t}, 4096) {str(dt)[6:]}{', L2 flushed' if cold else ''}"
        r = report("rmsnorm", f"add_rmsnorm {case}", err,
                   timer(lambda: ops.add_rmsnorm(x, res, w, 1e-5), cold=cold),
                   timer(lambda: ops.add_rmsnorm(x, res, w, 1e-5,
                                                 impl="ref"), cold=cold),
                   timer(lambda: F.rms_norm(x + res, (4096,), w, 1e-5),
                         cold=cold),
                   bound_ms(nbytes, 5 * x.numel(), PEAK_FP32))
        fused_us = host_us(torch, lambda: ops.add_rmsnorm(x, res, w, 1e-5))
        plain_us = host_us(torch, lambda: ops.rmsnorm(x, w, 1e-5))
        tri = triton_add_rmsnorm_us(torch, x, res, w)
        log(f"[kernel] host us per call (least of 5 x 1000 calls, no "
            f"sync) at {case}: "
            f"add_rmsnorm {fused_us:.2f}, rmsnorm {plain_us:.2f}, "
            f"retrieval_topk {topk_us:.2f} (ctypes launches); a Triton "
            f"launch of the same fused norm (yardstick) "
            f"{'not measured' if tri is None else f'{tri:.2f}'}")
        if t == SLOTS and dt == torch.bfloat16:
            rows["rmsnorm"] = r

    # ---- paged decode attention: H=32, KV=8, D=128, page 16, 8 slots
    mixed = MIXED_LENGTHS
    cases = (("bf16 pages", torch.bfloat16, torch.bfloat16, None, None, None),
             ("fp32 pages", torch.float32, torch.float32, None, None, None),
             ("int8 pages + scales", torch.float32, torch.int8, None, None,
              None),
             ("int8 pages + scales, bf16 q (serve-swap)", torch.bfloat16,
              torch.int8, None, None, None),
             ("bf16 window 256 softcap 50", torch.bfloat16, torch.bfloat16,
              256, 50.0, None),
             (f"bf16 pages, kv_len {mixed}", torch.bfloat16, torch.bfloat16,
              None, None, mixed))
    for case, qdt, kvdt, window, cap, lengths in cases:
        q, k, v, tab, kv_len, (ks, vs) = _paged_case(
            torch, gen, q_dtype=qdt, kv_dtype=kvdt, lengths=lengths)
        kw = dict(window=window, softcap=cap, k_scale=ks, v_scale=vs)
        got = ops.paged_decode_attention(q, k, v, tab, kv_len, **kw)
        want = ops.paged_decode_attention(q, k, v, tab, kv_len, impl="ref",
                                          **kw)
        if qdt == torch.float32:
            err = check_close(f"paged {case}", got, want, atol=FP32_ATTN_TOL)
        else:
            err = check_close(f"paged {case}", got, want, atol=BF16_ATOL,
                              rtol=BF16_RTOL)
        lib_ms = None
        if kvdt == torch.bfloat16 and window is None:
            # yardstick: SDPA over the dense view, gathered beforehand
            from repro_torch.kernels import ref
            kd = ref.gather_paged_kv(k, tab).transpose(1, 2)
            vd = ref.gather_paged_kv(v, tab).transpose(1, 2)
            pos = torch.arange(kd.shape[2], device="cuda")
            mask = (pos[None, :] < kv_len[:, None])[:, None, None]
            qd = q[:, :, None]
            lib_ms = timer(lambda: F.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=mask, enable_gqa=True), cold=True)
        nbytes, nops = _paged_bytes_ops(torch, q, k, tab, kv_len, window,
                                        (ks, vs))
        r = report("paged_decode_attention", case, err,
                   timer(lambda: ops.paged_decode_attention(
                       q, k, v, tab, kv_len, **kw), cold=True),
                   timer(lambda: ops.paged_decode_attention(
                       q, k, v, tab, kv_len, impl="ref", **kw), cold=True),
                   lib_ms, bound_ms(nbytes, nops, PEAK_FP32))
        if case == "bf16 pages":
            rows["paged_decode_attention"] = r

    # ---- retrieval top-k: 8 queries against one partition, k = 5
    from repro_torch.kernels.topk_retrieval import launch_shape
    resident = sorted((len(p.doc_ids), pid)
                      for pid, p in store.partitions.items() if p.resident)
    pid = resident[len(resident) // 2][1]       # the median-sized partition
    part = torch.from_numpy(store.partitions[pid].embeddings).cuda()
    q8 = torch.from_numpy(queries[:SLOTS]).cuda()
    rng_db = torch.randn((1037, 768), generator=gen, device="cuda")
    shp = launch_shape(SLOTS, part.shape[0], CORPUS_DIM)
    log(f"[kernel] topk_stream_kernel ({SLOTS} x {CORPUS_DIM} against "
        f"{part.shape[0]} rows): grid ({shp['blocks']}, "
        f"{shp['query_tiles']}) x {shp['threads']} threads over tiles of "
        f"{shp['rows']} rows, one launch")
    topk_rows = {}
    for case, db, k in ((f"partition {pid} ({part.shape[0]} rows)", part,
                         TOP_K),
                        ("ragged 1037 rows", rng_db, TOP_K),
                        ("3 rows, k=5 > N", rng_db[:3], TOP_K),
                        ("ragged 1037 rows, k=64", rng_db, 64),
                        (f"partition {pid}, k=64", part, 64)):
        got_s, got_i = ops.retrieval_topk(q8, db, k)
        want_s, want_i = ops.retrieval_topk(q8, db, k, impl="ref")
        err = check_topk(f"topk {case}", got_s, got_i, want_s, want_i)
        if db.shape[0] < k and not bool((got_i[:, db.shape[0]:] == -1).all()):
            fail(f"topk {case}: missing the (-1e30, -1) tail")
        n = db.shape[0]
        nbytes = (q8.numel() + db.numel()) * 4 + q8.shape[0] * k * 8
        r = report("retrieval_topk", case, err,
                   timer(lambda: ops.retrieval_topk(q8, db, k), cold=True),
                   timer(lambda: ops.retrieval_topk(q8, db, k, impl="ref"),
                         cold=True),
                   timer(lambda: torch.topk(q8 @ db.T, min(k, n), dim=-1),
                         cold=True),
                   bound_ms(nbytes, 2 * q8.shape[0] * n * 768, PEAK_FP32))
        topk_rows[case] = r
        if db is part and k == TOP_K:
            rows["retrieval_topk"] = r
    r = topk_rows["ragged 1037 rows, k=64"]
    log(f"[kernel] retrieval_topk ragged 1037 rows, k=64: kernel "
        f"{r['ms']:.4f} ms, torch.topk(q8 @ db.T, 64) {r['library_ms']:.4f} "
        f"ms: {r['ms'] / r['library_ms']:.2f}x the library call")
    del part

    # ---- merge: (8, 64, 5) boards under a probe mask, two rows unprobed;
    # both selections (k rounds, the sorted warp list) timed at k = 5 and
    # k = 64 beside an empty launch, the floor of any launch
    from repro_torch.kernels import topk_retrieval as tk

    def merge_case(parts, k):
        s = torch.sort(torch.randn((SLOTS, parts, k), generator=gen,
                                   device="cuda"), dim=-1,
                       descending=True).values
        ids = torch.randint(0, CORPUS_N, (SLOTS, parts, k), generator=gen,
                            device="cuda", dtype=torch.int32)
        mask = torch.rand((SLOTS, parts), generator=gen,
                          device="cuda") < 0.25
        mask[1] = False
        mask[5] = False
        mask[5, min(7, parts - 1)] = True   # one probed board, short of k
        s[5, min(7, parts - 1), 2:] = ops.NEG_INF   # ... the sentinel tail
        ids[5, min(7, parts - 1), 2:] = -1
        return s, ids, mask

    def merge_exact(what, got, want):
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            fail(f"merge {what}: ids and scores must equal the plain "
                 "version's exactly")

    for parts, k in ((PARTITIONS, TOP_K), (PARTITIONS, 64), (8, 64),
                     (32, 16), (16, 32)):
        s, ids, mask = merge_case(parts, k)
        want = ops.retrieval_topk_merge(s, ids, mask, k, impl="ref")
        times = []
        for rounds in (True, False):
            if rounds and parts * k > tk.MERGE_ROUNDS_MAX:
                continue
            name = "k rounds" if rounds else "warp list"
            merge_exact(f"({SLOTS}, {parts}, {k}) {name}",
                        tk._merge_selection(s, ids, mask, k, rounds), want)
            ms = timer(lambda: tk._merge_selection(s, ids, mask, k, rounds))
            times.append(f"{name} {ms:.4f}")
        log(f"[kernel] retrieval_topk_merge ({SLOTS}, {parts}, {k}) "
            f"selection ms: {', '.join(times)}")
    # the launch floor: an (almost) empty kernel, a spin of zero cycles
    empty_ms = timer(lambda: torch.cuda._sleep(0))
    s, ids, mask = merge_case(PARTITIONS, TOP_K)
    got_s, got_i = ops.retrieval_topk_merge(s, ids, mask, TOP_K)
    want_s, want_i = ops.retrieval_topk_merge(s, ids, mask, TOP_K,
                                              impl="ref")
    merge_exact("main path case", (got_s, got_i), (want_s, want_i))
    err = check_topk("merge", got_s, got_i, want_s, want_i)
    if not (bool((got_i[1] == -1).all()) and bool((got_i[5, 2:] == -1).all())
            and bool((got_s[1] == ops.NEG_INF).all())):
        fail("merge: masked rows must come out as (-1e30, -1)")
    nbytes = s.numel() * 8 + mask.numel() + SLOTS * TOP_K * 8

    def lib_merge():
        flat = torch.where(mask[:, :, None], s, ops.NEG_INF).flatten(1)
        top = torch.topk(flat, TOP_K, dim=-1)
        return top.values, ids.flatten(1).gather(1, top.indices)

    rows["retrieval_topk_merge"] = report(
        "retrieval_topk_merge", f"({SLOTS}, {PARTITIONS}, {TOP_K})", err,
        timer(lambda: ops.retrieval_topk_merge(s, ids, mask, TOP_K)),
        timer(lambda: ops.retrieval_topk_merge(s, ids, mask, TOP_K,
                                               impl="ref")),
        timer(lib_merge), bound_ms(nbytes, SLOTS * PARTITIONS * TOP_K,
                                   PEAK_FP32))
    log(f"[kernel] empty launch (torch.cuda._sleep(0)): {empty_ms:.4f} ms "
        "device time, the floor under the merge's "
        f"{rows['retrieval_topk_merge']['ms']:.4f} ms")

    # ---- flash attention: one-shot prefill (8 x 1024, scalar offset 0)
    # and a prefill chunk (1 x 256 at 768 of a 1024 view, per-row offset);
    # serve-swap's int8 chunk attends in fp32; a prefix hit prefills a
    # suffix of 1 to 15 tokens deep in the context (per-row offsets, each
    # row's kv_len its offset + Sq)
    sdpa = F.scaled_dot_product_attention
    suffix = (1023, 1008, 1000, 0)
    flash_cases = (
        ("one-shot bf16 (8, 1024) causal", torch.bfloat16, SLOTS, CTX, CTX,
         0, None, None, None),
        ("chunk bf16 (1, 256) at 768 of 1024", torch.bfloat16, 1, CHUNK, CTX,
         CTX - CHUNK, CTX, None, None),
        ("one-shot fp32 (2, 1024) causal", torch.float32, 2, CTX, CTX, 0,
         None, None, None),
        ("chunk bf16 (1, 256) window 300 softcap 50", torch.bfloat16, 1,
         CHUNK, CTX, CTX - CHUNK, CTX, 300, 50.0),
        (f"chunk fp32 (1, {RAGGED_CHUNK}) ragged, window 300 softcap 50",
         torch.float32, 1, RAGGED_CHUNK, CTX, CTX - RAGGED_CHUNK, CTX, 300,
         50.0),
        ("chunk fp32 (1, 256) at 768 of 1024 (serve-swap, int8 pages)",
         torch.float32, 1, CHUNK, CTX, CTX - CHUNK, CTX, None, None),
        (f"prefix suffix bf16 (4, 1) at {suffix} of 1024", torch.bfloat16,
         4, 1, CTX, suffix, tuple(o + 1 for o in suffix), None, None),
        ("prefix suffix bf16 (4, 15) at (1009, 1008, 1000, 0) of 1024",
         torch.bfloat16, 4, 15, CTX, (1009, 1008, 1000, 0),
         (1024, 1023, 1015, 15), None, None))
    for case, dt, b, sq, sk, off, kvl, window, cap in flash_cases:
        q = torch.randn((b, sq, HEADS, HEAD_DIM), generator=gen,
                        device="cuda").to(dt)
        k = torch.randn((b, sk, KV_HEADS, HEAD_DIM), generator=gen,
                        device="cuda").to(dt)
        v = torch.randn((b, sk, KV_HEADS, HEAD_DIM), generator=gen,
                        device="cuda").to(dt)
        kw = dict(causal=True, window=window, softcap=cap)
        if kvl is not None:           # the chunked prefill's per-row call
            kw.update(q_offset=torch.tensor(off, dtype=torch.int32,
                                            device="cuda").expand(b),
                      kv_len=torch.tensor(kvl, dtype=torch.int32,
                                          device="cuda").expand(b))
        got = ops.flash_attention(q, k, v, **kw)
        want = ops.flash_attention(q, k, v, impl="ref", **kw)
        if dt == torch.float32:
            err = check_close(f"flash {case}", got, want, atol=FP32_ATTN_TOL)
        else:
            wmean = ops.flash_attention(q.float(), k.float(), v.float().abs(),
                                        impl="ref", **kw)
            err = check_attention(f"flash {case}", got, want, wmean)
        lib_ms = None
        if window is None and cap is None:
            # yardstick: SDPA with GQA, causal from the chunk's offset
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            if off == 0 and sq == sk:
                lib_ms = timer(lambda: sdpa(qt, kt, vt, is_causal=True,
                                            enable_gqa=True))
            else:
                q_pos = (kw["q_offset"][:, None]
                         + torch.arange(sq, device="cuda"))      # (B, Sq)
                k_pos = torch.arange(sk, device="cuda")
                mask = ((k_pos[None, None, :] <= q_pos[:, :, None])
                        & (k_pos < kw["kv_len"][:, None, None]))[:, None]
                lib_ms = timer(lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                            enable_gqa=True))
        nbytes, nops = _flash_bytes_ops(torch, q, k, kw.get("kv_len"),
                                        kw.get("q_offset", 0), window)
        r = report("flash_attention", case, err,
                   timer(lambda: ops.flash_attention(q, k, v, **kw)),
                   timer(lambda: ops.flash_attention(q, k, v, impl="ref",
                                                     **kw)),
                   lib_ms, bound_ms(nbytes, nops, PEAK_BF16
                                    if dt == torch.bfloat16 else PEAK_FP32))
        if case.startswith("one-shot bf16"):
            rows["flash_attention"] = r
        del q, k, v, got, want

    # ---- dense decode: 8 slots of ctx + max_new, one of them dead
    total = CTX + MAX_NEW
    for case, dt, window, cap, lengths in (
            ("bf16 cache", torch.bfloat16, None, None, None),
            ("fp32 cache", torch.float32, None, None, None),
            ("bf16 window 256 softcap 50", torch.bfloat16, 256, 50.0, None),
            (f"bf16 cache, kv_len {MIXED_LENGTHS}", torch.bfloat16, None,
             None, MIXED_LENGTHS)):
        q = torch.randn((SLOTS, HEADS, HEAD_DIM), generator=gen,
                        device="cuda").to(dt)
        k = torch.randn((SLOTS, total, KV_HEADS, HEAD_DIM), generator=gen,
                        device="cuda").to(dt)
        v = torch.randn((SLOTS, total, KV_HEADS, HEAD_DIM), generator=gen,
                        device="cuda").to(dt)
        kv_len = torch.randint(CTX + 1, total + 1, (SLOTS,), generator=gen,
                               device="cuda", dtype=torch.int32)
        if lengths is not None:
            kv_len = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        kv_len[-1] = total               # a finished slot riding the step
        kw = dict(window=window, softcap=cap)
        got = ops.decode_attention(q, k, v, kv_len, **kw)
        want = ops.decode_attention(q, k, v, kv_len, impl="ref", **kw)
        if dt == torch.float32:
            err = check_close(f"decode {case}", got, want, atol=FP32_ATTN_TOL)
        else:
            wmean = ops.decode_attention(q.float(), k.float(),
                                         v.float().abs(), kv_len, impl="ref",
                                         **kw)
            err = check_attention(f"decode {case}", got, want, wmean)
        lib_ms = None
        if window is None:
            # yardstick: SDPA over the dense cache, masked to kv_len
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)
            mask = (torch.arange(total, device="cuda")[None, :]
                    < kv_len[:, None])[:, None, None]
            qd = q[:, :, None]
            lib_ms = timer(lambda: sdpa(qd, kt, vt, attn_mask=mask,
                                        enable_gqa=True), cold=True)
        nbytes, nops = _decode_bytes_ops(torch, q, k, kv_len, window)
        r = report("decode_attention", case, err,
                   timer(lambda: ops.decode_attention(q, k, v, kv_len, **kw),
                         cold=True),
                   timer(lambda: ops.decode_attention(q, k, v, kv_len,
                                                      impl="ref", **kw),
                         cold=True),
                   lib_ms, bound_ms(nbytes, nops, PEAK_FP32))
        if case == "bf16 cache":
            rows["decode_attention"] = r
        del q, k, v, got, want
    torch.cuda.synchronize()
    return rows


def phase_model(torch):
    """A reduced llama: the kernels on the card against the plain versions
    on the CPU, same fp32 weights: chunked prefill then paged decode, and
    one-shot prefill then dense decode."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, init_cache
    cfg = get_config("llama3-8b").reduced(num_layers=2)
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    p_cpu = cpu.init(seed=3, dtype=torch.float32)

    def to_dev(t):
        if isinstance(t, dict):
            return {k: to_dev(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_dev(v) for v in t]
        return t.cuda()

    p_gpu = to_dev(p_cpu)
    ctx, chunk, page, steps = 40, 16, 8, 8
    nmax = -(-(ctx + steps) // page)
    tab = torch.arange(1, 2 * nmax + 1, dtype=torch.int32).reshape(2, nmax)
    tab[1] = tab[1].flip(0)
    g = torch.Generator().manual_seed(4)
    prompts = torch.randint(2, cfg.vocab_size, (2, ctx), generator=g,
                            dtype=torch.int32)
    paged, dense = {}, {}
    for dev, model, params in (("cpu", cpu, p_cpu), ("cuda", gpu, p_gpu)):
        cache = init_cache(cfg, 2 * nmax + 1, page, torch.float32, dev)
        t = tab.to(dev)
        last = []
        for slot in range(2):
            for off in range(0, ctx, chunk):
                c = min(chunk, ctx - off)
                lg = model.chunk_prefill(
                    params, prompts[slot:slot + 1, off:off + c].to(dev), cache,
                    torch.full((1,), off, dtype=torch.int32, device=dev),
                    t[slot:slot + 1], kv_span=ctx)
            last.append(lg[0])
        out = [torch.stack(last)]
        cur = out[-1].argmax(-1).to(torch.int32)
        for s in range(steps):
            pos = torch.full((2,), ctx + s, dtype=torch.int32, device=dev)
            out.append(model.decode(params, cur[:, None], cache, pos, t,
                                    kv_span=ctx + steps))
            cur = out[-1].argmax(-1).to(torch.int32)
        paged[dev] = torch.stack(out).cpu()
        # one-shot prefill into a dense cache, then dense decode
        cache = init_cache(cfg, 2, ctx + steps, torch.float32, dev)
        out = [model.prefill(params, prompts.to(dev), cache)]
        cur = out[-1].argmax(-1).to(torch.int32)
        for s in range(steps - 1):
            pos = torch.full((2,), ctx + s, dtype=torch.int32, device=dev)
            out.append(model.decode(params, cur[:, None], cache, pos))
            cur = out[-1].argmax(-1).to(torch.int32)
        dense[dev] = torch.stack(out).cpu()
    for name, logits, what in (
            ("chunked prefill + paged decode", paged,
             f"chunked prefill + {steps} paged decode steps"),
            ("one-shot prefill + dense decode", dense,
             f"one-shot prefill + {steps - 1} dense decode steps")):
        err = check_close(f"reduced model logits, {name}", logits["cuda"],
                          logits["cpu"], atol=MODEL_LOGIT_TOL)
        if not torch.equal(logits["cuda"].argmax(-1),
                           logits["cpu"].argmax(-1)):
            fail(f"reduced model, {name}: greedy tokens differ between "
                 "card and CPU")
        log(f"[model] {cfg.name}: {what}, card (kernels) vs CPU (plain): "
            f"max logit err {err:.3e} (tol {MODEL_LOGIT_TOL}), greedy "
            "tokens equal")


def build_weights(torch):
    """Full-width llama3-8b, seeded random bf16 weights, built once on the
    card and shared by every serving phase."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = get_config("llama3-8b")
    t0 = time.perf_counter()
    params = Model(cfg, device="cuda").init(seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    nparams = sum(t.numel() for t in _leaves(params))
    log(f"[weights] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads x "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
        f"{nparams / 1e9:.2f} B bf16 params in "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, params


def check_requests(torch, tag, reqs, exact, vocab) -> None:
    """Fails unless all ``N_REQ`` requests came back, each with
    ``MAX_NEW`` tokens and the exact top-5 of the full corpus."""
    if len(reqs) != N_REQ:
        fail(f"[{tag}] {len(reqs)} of {N_REQ} requests came back")
    ex_s, ex_i = exact
    for r in reqs:
        qi = int(r.query[1:])            # QueryEmbedder: "q<i>" -> query i
        toks = r.output.split()
        if len(toks) != MAX_NEW or not all(
                0 <= int(t[3:]) < vocab for t in toks):
            fail(f"[{tag}] request {r.rid}: {len(toks)} tokens, want "
                 f"{MAX_NEW}")
        got = torch.tensor([[int(c) for c in r.retrieved]])
        if got.shape[1] != TOP_K:
            fail(f"[{tag}] request {r.rid}: {got.shape[1]} chunks, want "
                 f"{TOP_K}")
        # exact search (nprobe=None): the ids of the plain full-corpus top-k
        check_topk(f"[{tag}] request {r.rid} retrieval",
                   ex_s[qi:qi + 1].cpu(), got,
                   ex_s[qi:qi + 1].cpu(), ex_i[qi:qi + 1].cpu())


def _watch_threads():
    """The errors of worker threads that die from here on."""
    errors = []
    threading.excepthook = lambda a: errors.append(
        f"{a.thread.name}: {a.exc_type.__name__}: {a.exc_value}")
    return errors


def _submit_and_drain(eng, rids, t_limit, tag, errors, query_of=None):
    """Submit requests ``rids`` (request ``i`` asks ``q<query_of(i)>``,
    default ``q<i>``) to a started engine and wait for all of them; fails
    as soon as a worker thread has died."""
    from repro_torch.serving import Request
    for i in rids:
        qi = i if query_of is None else query_of(i)
        eng.submit(Request(rid=i, query=f"q{qi}", arrival=time.perf_counter(),
                           top_k=TOP_K, max_new_tokens=MAX_NEW))
    deadline = time.monotonic() + t_limit
    while True:
        try:
            return eng.drain(rids[-1] + 1, timeout=5.0)
        except TimeoutError:
            if errors:
                fail(f"[{tag}] worker thread died: {errors}")
            if time.monotonic() > deadline:
                raise


def serve_path(torch, eng, tag, kernels, exact, smi, vocab, *,
               stats=None, step_hist=None, layers=None, executor=None,
               profile=True):
    """Warm up, serve the 16 measured requests with the launch counts set to
    0 just before and read just after, then (``profile``) a profiled batch.
    Fails unless every request has ``MAX_NEW`` tokens and the exact top-5
    and every kernel in ``kernels`` launched.  ``layers``: a whole-batch
    path, whose prefill batches are its flash launches over the layers.
    ``executor``: a streamed generator's, whose passes and staged bytes in
    the measured run are printed.  Returns the measured run's numbers."""
    from repro_torch.kernels import ops
    from repro_torch.serving import percentile
    errors = _watch_threads()

    def serve(rids, t_limit):
        return _submit_and_drain(eng, rids, t_limit, tag, errors)

    eng.start()
    try:
        t0 = time.perf_counter()
        serve(list(range(WARMUP_REQ)), 300)
        log(f"[{tag}] warm-up: {WARMUP_REQ} requests in "
            f"{time.perf_counter() - t0:.1f} s")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if step_hist is not None:
            steps_before, secs_before = step_hist.count, step_hist.total
        if stats is not None:
            stats.reset()                    # the measured window only
        if executor is not None:
            passes0, staged0 = executor.passes, executor.staged_bytes
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = serve(list(range(WARMUP_REQ, WARMUP_REQ + N_REQ)), 600)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        retrieval = stats.snapshot() if stats is not None else None
        if executor is not None:
            passes = executor.passes - passes0
            staged = executor.staged_bytes - staged0
        first = WARMUP_REQ + N_REQ
        if profile:
            # a further batch under the profiler: where the device time goes
            from torch.profiler import ProfilerActivity, profile as trace
            t0 = time.perf_counter()
            with trace(activities=[ProfilerActivity.CUDA]) as prof:
                serve(list(range(first, first + PROFILE_REQ)), 600)
                torch.cuda.synchronize()
                window = time.perf_counter() - t0   # not the profiler's stop
            log(f"[profile {tag}] stopping the profiler took "
                f"{time.perf_counter() - t0 - window:.2f} s more")
    finally:
        eng.stop()
    if errors:
        fail(f"[{tag}] worker thread died: {errors}")

    reqs = sorted((r for r in done if WARMUP_REQ <= r.rid < first),
                  key=lambda r: r.rid)
    check_requests(torch, tag, reqs, exact, vocab)
    missing = [n for n in kernels if counts[n] == 0]
    if missing:
        fail(f"[{tag}] kernels never launched on this path: {missing}")
    lat = [r.latency for r in reqs]
    p50, p95 = percentile(lat, 50), percentile(lat, 95)
    toks = N_REQ * MAX_NEW
    log(f"[{tag}] {N_REQ}/{N_REQ} requests served, {MAX_NEW} tokens and "
        f"{TOP_K} exact chunks each, in {wall:.3f} s on {smi}")
    extra = ""
    if step_hist is not None:
        steps = step_hist.count - steps_before
        step_ms = (step_hist.total - secs_before) / max(steps, 1) * 1e3
        extra += f"; {steps} generator steps, mean {step_ms:.1f} ms"
    if layers is not None:
        extra += f"; {counts['flash_attention'] // layers} prefill batches"
    log(f"[{tag}] latency p50 {p50:.3f} s p95 {p95:.3f} s; "
        f"{toks / wall:.1f} output tokens/s{extra}; peak device memory "
        f"{peak / 2 ** 30:.2f} GiB ({smi})")
    if retrieval is not None:
        log(f"[{tag}] retrieval of the {N_REQ} requests: {retrieval}")
    if executor is not None:
        log(f"[{tag}] {passes} streamed passes, {staged} B staged host to "
            f"device ({staged / max(passes, 1) / 1e9:.3f} GB a pass)")
    log(f"[{tag}] launches on this path: {json.dumps(counts)}")
    if profile:
        breakdown(tag, _kernel_records(prof, torch), window, smi)
    return dict(counts=counts, p50=p50, tokens_s=toks / wall,
                outputs={r.rid: r.output for r in reqs}, reqs=reqs)


def decode_step_kernels(torch, tag, model, params, cache, block_tab=None,
                        span=None) -> None:
    """Profiles one decode step of ``SLOTS`` slots at position ``CTX`` and
    prints its device kernels (copies and memsets left out), then the same
    step with every residual add a launch of its own; fails unless fusing
    the adds into the norms saved at least one launch per fused norm."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import layers
    cur = torch.zeros((SLOTS, 1), dtype=torch.int32, device="cuda")
    pos = torch.full((SLOTS,), CTX, dtype=torch.int32, device="cuda")

    def count() -> int:
        """The median kernel count of three profiled steps: one trace can
        read a few kernels off."""
        model.decode(params, cur, cache, pos, block_tab, kv_span=span)
        torch.cuda.synchronize()
        counts = []
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                model.decode(params, cur, cache, pos, block_tab, kv_span=span)
                torch.cuda.synchronize()
            names = [name for name, _, _ in _kernel_records(prof, torch)]
            counts.append(sum(1 for name in names
                              if not name.startswith(("Memcpy", "Memset"))))
        return sorted(counts)[1]

    fused = count()
    add_rms_norm = layers.add_rms_norm

    def unfused(x, r, w, eps):
        s = x + r
        return s, layers.rms_norm(s, w, eps)

    layers.add_rms_norm = unfused
    try:
        apart = count()
    finally:
        layers.add_rms_norm = add_rms_norm
    saved = 2 * model.cfg.num_layers      # every norm but layer 0's norm1
    log(f"[{tag}] one decode step ({SLOTS} slots): {fused} device kernels; "
        f"{apart} with each residual add a launch of its own: "
        f"{apart - fused} fewer")
    if apart - fused < saved:
        fail(f"[{tag}] fusing the residual adds saved {apart - fused} "
             f"launches a decode step, want at least {saved}")


class QueryEmbedder:
    """Maps request text ``q<i>`` to the i-th perturbed corpus query."""

    def __init__(self, queries):
        self.queries = queries
        self.dim = queries.shape[1]

    def embed(self, texts):
        return self.queries[[int(t[1:]) for t in texts]]


def phase_serve(torch, cfg, params, store, queries, exact, smi: str):
    """The continuous path: a paged, chunk-prefilled ContinuousGenerator."""
    from repro_torch.core.scheduler import BacklogScheduler
    from repro_torch.serving import (ContinuousGenerator, GeneratorConfig,
                                     RagdollEngine)
    gen = ContinuousGenerator(
        cfg, params, GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW,
                                     dtype=torch.bfloat16),
        num_slots=SLOTS, paged=True, page_size=PAGE, prefill_chunk=CHUNK,
        device="cuda")
    eng = RagdollEngine(store, QueryEmbedder(queries), gen,
                        BacklogScheduler(max_batch=SLOTS),
                        BacklogScheduler(max_batch=SLOTS),
                        initial_partitions=PARTITIONS - SPILLED,
                        device="cuda")
    out = serve_path(torch, eng, "serve", CONTINUOUS_KERNELS, exact, smi,
                     cfg.vocab_size, stats=eng.retrieval_stats,
                     step_hist=eng.registry.histogram("decode.step_seconds"))
    decode_step_kernels(torch, "serve", gen.model, params, gen.cache,
                        gen.kv.device_tab(), gen._total)
    return out


def phase_serve_batch(torch, cfg, params, store, queries, exact, smi: str,
                      paged_outputs):
    """The whole-batch path: a Generator (one-shot prefill, dense cache)
    behind RagdollEngine, then behind SerialRAGEngine."""
    from repro_torch.core.scheduler import BacklogScheduler
    from repro_torch.models.model import init_cache
    from repro_torch.serving import (Generator, GeneratorConfig,
                                     RagdollEngine, SerialRAGEngine)
    g = GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW,
                        dtype=torch.bfloat16)
    results = {}
    for tag in ("serve-batch", "serve-serial"):
        gen = Generator(cfg, params, g, device="cuda")
        emb = QueryEmbedder(queries)
        if tag == "serve-batch":
            eng = RagdollEngine(store, emb, gen,
                                BacklogScheduler(max_batch=SLOTS),
                                BacklogScheduler(max_batch=SLOTS),
                                initial_partitions=PARTITIONS - SPILLED,
                                device="cuda")
            stats = eng.retrieval_stats
        else:
            eng = SerialRAGEngine(store, emb, gen, batch_size=SERIAL_BATCH,
                                  device="cuda")
            stats = None
        results[tag] = serve_path(torch, eng, tag, WHOLE_BATCH_KERNELS,
                                  exact, smi, cfg.vocab_size, stats=stats,
                                  layers=cfg.num_layers)
        cache = init_cache(cfg, SLOTS, CTX + MAX_NEW, torch.bfloat16, "cuda")
        decode_step_kernels(torch, tag, gen.model, params, cache)
        del cache
    ratio = results["serve-serial"]["p50"] / results["serve-batch"]["p50"]
    log(f"[serve-serial] p50 serial / ragdoll (whole-batch) = {ratio:.3f} "
        f"({smi})")
    same = sum(paged_outputs[rid] == out
               for rid, out in results["serve-batch"]["outputs"].items())
    log(f"[serve-batch] information only: {same}/{N_REQ} requests got the "
        f"same {MAX_NEW} tokens from the whole-batch and the paged paths "
        "(bf16 rounding differs between their kernels; token identity is "
        "held in fp32 on the CPU)")
    return results


def _swap_generator(torch, cfg, params, page_budget, host_pages):
    from repro_torch.serving import ContinuousGenerator, GeneratorConfig
    return ContinuousGenerator(
        cfg, params, GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW,
                                     dtype=torch.bfloat16),
        num_slots=SLOTS, paged=True, page_size=PAGE, prefill_chunk=CHUNK,
        kv_format="int8", page_budget=page_budget,
        host_page_budget=host_pages, overlap_swap=True, device="cuda")


def _pump(eng, rids, tag="serve-swap", query_of=None,
          priority_req=SWAP_PRIORITY_REQ):
    """fig8's deterministic drive: retrieve the batch, then pump the
    engine single-threaded until every request is done.  Request ``i``
    asks ``q<query_of(i)>`` (default ``q<i>``); the last ``priority_req``
    are priority 1."""
    from repro_torch.serving import Request
    reqs = [Request(rid=i, query=f"q{i if query_of is None else query_of(i)}",
                    arrival=time.perf_counter(), top_k=TOP_K,
                    max_new_tokens=MAX_NEW,
                    priority=int(i >= rids[-1] + 1 - priority_req))
            for i in rids]
    eng._retrieve_batch(reqs)
    eng.pipeline.context_queue.put_many(reqs)
    target = len(eng.completed) + len(reqs)
    guard = 0
    while eng.pump_once() < target:
        guard += 1
        if guard > 400 * len(reqs):
            fail(f"[{tag}] the pump stalled")
    return reqs


def phase_serve_swap(torch, cfg, params, store, queries, exact, smi: str):
    """Memory pressure: int8 pages under the device-byte grant of two
    worst-case bf16 requests, a host pool for every slot, overlapped
    swaps and partial-swap preemption by the priority scheduler, driven
    through ``pump_once``; the same int8 generator with pages for every
    slot and no host pool gives the tokens to match."""
    from repro_torch.core.scheduler import BacklogScheduler
    from repro_torch.kernels import ops
    from repro_torch.serving import RagdollEngine, percentile
    worst = -(-(CTX + MAX_NEW) // PAGE)
    bf16_page = PAGE * cfg.kv_cache_bytes_per_token(2)
    int8_page = (PAGE * cfg.kv_cache_bytes_per_token(1)
                 + cfg.kv_scale_bytes_per_page())
    budget = (2 * worst * bf16_page) // int8_page
    rids = list(range(N_REQ))
    results = {}
    for label, pages, host in (("no preemption", SLOTS * worst, 0),
                               ("swap", budget, SLOTS * worst)):
        gen = _swap_generator(torch, cfg, params, pages, host)
        eng = RagdollEngine(store, QueryEmbedder(queries), gen,
                            BacklogScheduler(max_batch=N_REQ),
                            BacklogScheduler(max_batch=SLOTS),
                            initial_partitions=PARTITIONS - SPILLED,
                            partial_swap=True, device="cuda")
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            reqs = _pump(eng, rids)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            done = sorted(eng.completed, key=lambda r: r.rid)
            check_requests(torch, f"serve-swap {label}", done, exact,
                           cfg.vocab_size)
            kv = gen.kv
            if gen.parked_slots or kv.outstanding or kv.pool.inflight_pages:
                fail(f"[serve-swap {label}] left {gen.parked_slots} parked, "
                     f"{kv.outstanding} copies queued")
            lat = {c: [r.latency for r in done if r.priority == c]
                   for c in (0, 1)}
            log(f"[serve-swap] {label}: {N_REQ}/{N_REQ} requests, "
                f"{MAX_NEW} tokens and {TOP_K} exact chunks each, in "
                f"{wall:.3f} s, {N_REQ * MAX_NEW / wall:.1f} output tokens/s;"
                f" page budget {kv.pool.capacity} int8 pages "
                f"({kv.page_nbytes(gen.cache)} B each), host pages "
                f"{kv.host.capacity}; peak device memory "
                f"{peak / 2 ** 30:.2f} GiB ({smi})")
            log(f"[serve-swap] {label}: swaps out {gen.swap_outs} in "
                f"{gen.swap_ins}, swap bytes out {kv.swap_out_bytes} in "
                f"{kv.swap_in_bytes}, swap_stall_s {kv.swap_stall_s:.4f}, "
                f"peak_in_flight {gen.peak_in_flight}; latency priority 1 "
                f"p50 {percentile(lat[1], 50):.3f} s p95 "
                f"{percentile(lat[1], 95):.3f} s, priority 0 p50 "
                f"{percentile(lat[0], 50):.3f} s p95 "
                f"{percentile(lat[0], 95):.3f} s ({smi})")
            results[label] = dict(counts=counts, outputs={
                r.rid: r.output for r in done})
            if label == "swap":
                if not gen.swap_outs >= 1 or gen.swap_ins != gen.swap_outs:
                    fail(f"[serve-swap] swaps out {gen.swap_outs} in "
                         f"{gen.swap_ins}: want at least one, all back in")
                missing = [n for n in SWAP_KERNELS if counts[n] == 0]
                if missing:
                    fail(f"[serve-swap] kernels never launched on this "
                         f"path: {missing}")
                log(f"[serve-swap] launches on this path: "
                    f"{json.dumps(counts)}")
                # where the device time goes: a further batch, profiled
                from torch.profiler import ProfilerActivity, profile
                t0 = time.perf_counter()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    _pump(eng, list(range(N_REQ, N_REQ + PROFILE_REQ)))
                    torch.cuda.synchronize()
                    window = time.perf_counter() - t0
                log(f"[profile serve-swap] stopping the profiler took "
                    f"{time.perf_counter() - t0 - window:.2f} s more")
                breakdown("serve-swap", _kernel_records(prof, torch),
                          window, smi)
                decode_step_kernels(torch, "serve-swap", gen.model, params,
                                    gen.cache, gen.kv.device_tab(),
                                    gen._total)
        finally:
            eng.streamer.close()
        del gen, eng
    if results["swap"]["outputs"] != results["no preemption"]["outputs"]:
        diff = [rid for rid, out in results["swap"]["outputs"].items()
                if out != results["no preemption"]["outputs"][rid]]
        fail(f"[serve-swap] requests {diff} got other tokens with "
             "preemption than without")
    log(f"[serve-swap] {N_REQ}/{N_REQ} requests: the same {MAX_NEW} tokens "
        "with preemption as without")
    return results["swap"]["counts"]


def _prefix_generator(torch, cfg, params, **kw):
    from repro_torch.serving import ContinuousGenerator, GeneratorConfig
    return ContinuousGenerator(
        cfg, params, GeneratorConfig(ctx_len=PREFIX_CTX,
                                     max_new_tokens=MAX_NEW,
                                     dtype=torch.bfloat16),
        num_slots=SLOTS, paged=True, page_size=PAGE, prefill_chunk=CHUNK,
        device="cuda", **kw)


def _near_tie(torch, cfg, params, fp32, req, got: str, ctx=PREFIX_CTX):
    """Where ``got`` first leaves ``req``'s tokens (run 1's): the prompt
    and run 1's tokens before that point go through one-shot prefill with
    the bf16 weights and with ``fp32``, their cast.  Returns (position,
    run 1's token, the other token, their fp32 logit gap, the largest
    bf16-fp32 logit difference of that row)."""
    from repro_torch.models.model import Model, init_cache
    from repro_torch.serving.generator import HashTokenizer
    want = [int(t[3:]) for t in req.output.split()]
    other = [int(t[3:]) for t in got.split()]
    t = next(i for i, (a, b) in enumerate(zip(want, other)) if a != b)
    toks = HashTokenizer(cfg.vocab_size).encode(req.prompt, ctx)
    ids = torch.tensor([list(toks) + want[:t]], dtype=torch.int32,
                       device="cuda")
    model = Model(cfg, device="cuda")
    rows = {}
    with torch.no_grad():
        for name, p in (("bf16", params), ("fp32", fp32)):
            cache = init_cache(cfg, 1, ids.shape[1], p["embed"].dtype,
                               "cuda")
            rows[name] = model.prefill(p, ids, cache)[0].float()
            del cache
    gap = float(rows["fp32"][want[t]] - rows["fp32"][other[t]])
    err = float((rows["bf16"] - rows["fp32"]).abs().max())
    return t, want[t], other[t], gap, err


def phase_serve_prefix(torch, cfg, params, store, queries, exact, smi: str):
    """Recurring prompts through the radix prefix cache, four runs on the
    continuous path's generator at ``PREFIX_CTX`` with the bf16 weights
    (see the module docstring).  Returns the launch counts of each run.

    Every run must give run 1's tokens, or leave them first at a near
    tie.  A prefix hit prefills its suffix (1 token here) where a miss
    prefills the last 254 tokens of the prompt in one chunk, and run 4
    decodes 4 rows where the others decode 8: other matmul shapes, so in
    bf16 other roundings.  So a request whose tokens differ is recomputed
    (``_near_tie``) up to its first other token, and the two choices'
    fp32 logits must lie within twice the bf16 logits' largest error in
    that row: within what bf16 rounding alone can turn."""
    from repro_torch.core.scheduler import BacklogScheduler
    from repro_torch.kernels import ops
    from repro_torch.serving import RagdollEngine, percentile
    worst = -(-(PREFIX_CTX + MAX_NEW) // PAGE)
    prompt_pages = -(-PREFIX_CTX // PAGE)
    order = [q for rnd in PREFIX_ROUNDS for q in rnd]
    pages = SLOTS * worst + len(set(order)) * prompt_pages
    if len(order) != N_REQ:
        fail(f"[serve-prefix] {len(order)} requests in PREFIX_ROUNDS")

    def engine(gen):
        return RagdollEngine(store, QueryEmbedder(queries), gen,
                             BacklogScheduler(max_batch=N_REQ),
                             BacklogScheduler(max_batch=SLOTS),
                             initial_partitions=PARTITIONS - SPILLED,
                             device="cuda")

    def serve(label, gen, eng):
        tag = f"serve-prefix {label}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = (gen.joins, gen.prefill_tokens, gen.prefix_hit_tokens,
                  gen.cow_copies)
        stats0 = (vars(gen.prefix.stats).copy() if gen.prefix is not None
                  else {})
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        reqs, first = [], 0
        for rnd in PREFIX_ROUNDS:
            reqs += _pump(eng, list(range(first, first + len(rnd))),
                          tag=tag, query_of=order.__getitem__,
                          priority_req=0)
            first += len(rnd)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        check_requests(torch, tag, reqs, exact, cfg.vocab_size)
        missing = [n for n in CONTINUOUS_KERNELS if counts[n] == 0]
        if missing:
            fail(f"[{tag}] kernels never launched on this path: {missing}")
        joins, prefilled, hits, cow = (
            now - was for now, was in zip(
                (gen.joins, gen.prefill_tokens, gen.prefix_hit_tokens,
                 gen.cow_copies), before))
        stats = ({k: v - stats0[k] for k, v in vars(gen.prefix.stats).items()}
                 if gen.prefix is not None else {})
        lat = [r.latency for r in reqs]
        per_join = prefilled / max(joins, 1)
        log(f"[{tag}] {N_REQ}/{N_REQ} requests, {MAX_NEW} tokens and {TOP_K}"
            f" exact chunks each, in {wall:.3f} s: "
            f"{N_REQ * MAX_NEW / wall:.1f} output tokens/s, p50 "
            f"{percentile(lat, 50):.3f} s; {joins} joins, {prefilled} prompt "
            f"tokens prefilled ({per_join:.1f} a join), hit tokens {hits}, "
            f"CoW copies {cow}, pages demoted "
            f"{stats.get('demoted_pages', 0)} revived "
            f"{stats.get('revived_pages', 0)}; {gen.num_slots} slots, "
            f"{gen.kv.pool.capacity} pages; peak device memory "
            f"{peak / 2 ** 30:.2f} GiB ({smi})")
        log(f"[{tag}] launches: {json.dumps(counts)}")
        return dict(outputs={r.rid: r.output for r in reqs}, reqs=reqs,
                    counts=counts,
                    per_join=per_join, hits=hits, cow=cow, stats=stats)

    runs = {}
    gen = _prefix_generator(torch, cfg, params, page_budget=pages)
    eng = engine(gen)
    try:
        runs["off"] = serve("cache off", gen, eng)
    finally:
        eng.streamer.close()
    del gen, eng
    cached_gen = _prefix_generator(torch, cfg, params,
                                   page_budget=pages, prefix_cache=True)
    cached_eng = engine(cached_gen)
    try:
        runs["on"] = serve("cache on", cached_gen, cached_eng)
        gen = _prefix_generator(torch, cfg, params,
                                page_budget=pages, prefix_cache=True,
                                prefix_page_budget=prompt_pages)
        eng = engine(gen)
        try:
            runs["budget"] = serve(f"cache budget {prompt_pages} pages",
                                   gen, eng)
        finally:
            eng.streamer.close()
        del gen, eng
        # run 4: the placement's knobs on run 2's generator
        kv = cached_gen.kv
        page_bytes = kv.page_nbytes(cached_gen.cache)
        pages_before = kv.pool.capacity
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        applied = cached_gen.retarget(num_slots=PREFIX_SLOTS_AFTER,
                                      page_budget=SLOTS * worst // 2,
                                      prefix_page_budget=0)
        torch.cuda.synchronize()
        freed = mem_before - torch.cuda.memory_allocated()
        dropped = (pages_before - kv.pool.capacity) * page_bytes
        log(f"[serve-prefix retarget] {applied}: {pages_before} -> "
            f"{kv.pool.capacity} pages ({page_bytes} B each), cached "
            f"device pages {cached_gen.prefix.device_pages}, host "
            f"{cached_gen.prefix.host_pages}; device memory allocated fell "
            f"by {freed} B for {dropped} B of dropped pages ({smi})")
        if dropped <= 0 or freed < 0.9 * dropped:
            fail(f"[serve-prefix retarget] dropped {dropped} B of pages, "
                 f"device memory fell by {freed} B: want at least 90 %")
        if (applied.get("slots") != PREFIX_SLOTS_AFTER
                or cached_gen.prefix.device_pages != 0):
            fail(f"[serve-prefix retarget] applied {applied}, "
                 f"{cached_gen.prefix.device_pages} cached device pages")
        runs["retarget"] = serve(
            f"retargeted to {PREFIX_SLOTS_AFTER} slots", cached_gen,
            cached_eng)
    finally:
        cached_eng.streamer.close()
    del cached_gen, cached_eng
    want = {r.rid: r for r in runs["off"]["reqs"]}
    fp32, ties = None, 0
    for label, run in runs.items():
        for rid, out in run["outputs"].items():
            if out == want[rid].output:
                continue
            if fp32 is None:
                fp32 = _cast(params, torch.float32)
            t, a, b, gap, err = _near_tie(torch, cfg, params, fp32,
                                          want[rid], out)
            msg = (f"[serve-prefix {label}] request {rid} "
                   f"({want[rid].query}): first other token at {t}, "
                   f"{b} for run 1's {a}; fp32 logit gap {gap:.6f}, "
                   f"bf16 logits off fp32 by up to {err:.6f} in that row")
            if abs(gap) > 2 * err:
                fail(f"{msg}: not a near tie")
            log(f"{msg}: a near tie ({smi})")
            ties += 1
    del fp32
    on, off, budget = runs["on"], runs["off"], runs["budget"]
    if not (on["per_join"] < off["per_join"] and on["hits"] > 0
            and on["cow"] > 0):
        fail(f"[serve-prefix] with the cache: {on['per_join']:.1f} prompt "
             f"tokens a join (without: {off['per_join']:.1f}), hit tokens "
             f"{on['hits']}, CoW copies {on['cow']}: want fewer, > 0, > 0")
    if not (budget["stats"]["demoted_pages"] > 0
            and budget["stats"]["revived_pages"] > 0):
        fail(f"[serve-prefix] under the budget: {budget['stats']}: want "
             "pages demoted and revived")
    log(f"[serve-prefix] {N_REQ}/{N_REQ} requests in each of four runs: "
        f"the same {MAX_NEW} tokens as without the prefix cache, but for "
        f"{ties} that leave them at a near tie")
    return [run["counts"] for run in runs.values()]


# -------------------------------------------------------- serve-streamed
def _union(intervals):
    """The merged ``[start, end]`` intervals of ``intervals``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def h2d_overlap(records):
    """Host-to-device copies of a trace: their count, time (us) and the
    share of it that runs while a kernel runs."""
    h2d = [(s, s + d) for n, s, d in records if n.startswith("Memcpy HtoD")]
    kernels = _union((s, s + d) for n, s, d in records
                     if not n.startswith(("Memcpy", "Memset")))
    total = sum(b - a for a, b in h2d)
    over = sum(max(0.0, min(b, e) - max(a, c))
               for a, b in h2d for c, e in kernels)
    return len(h2d), total, (over / total if total else 0.0)


def phase_serve_streamed(torch, cfg, params, store, queries, exact, smi: str,
                         serve_run):
    """The paper's layer-streamed offloading on the serve weights: the 32
    layers in pinned host memory, ``top`` on the card, a ring of
    ``max_depth + 1`` layer slots.  (a) a streamed whole-batch
    ``Generator`` on 8 of serve's prompts gives the resident one's tokens
    exactly; (b) the streamed paged, chunk-prefilled continuous generator
    behind a threaded ``RagdollEngine`` serves the 16 requests with
    serve's tokens, or leaves them first at an fp32-witnessed near tie
    (joiners' chunks ride one padded call: other matmul shapes than
    serve's batch=1 chunks); then one layer's pinned copy rate, the mean
    decode pass against its copy bound, and one profiled decode pass.
    Returns (b)'s launch counts."""
    import gc
    from repro_torch.core.prefetch import PrefetchPolicy
    from repro_torch.core.scheduler import BacklogScheduler
    from repro_torch.serving import (ContinuousGenerator, Generator,
                                     GeneratorConfig, RagdollEngine)
    policy = PrefetchPolicy()
    g = GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW,
                        dtype=torch.bfloat16)
    top_bytes = sum(t.numel() * t.element_size()
                    for k, t in params.items() if k != "blocks")

    def build(make):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        gen = make()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ex = gen.exec
        # the executor's share: a paged generator also allocates its pool
        pool = gen.kv.pool_nbytes(gen.cache) if getattr(gen, "kv", None) \
            else 0
        grown = torch.cuda.memory_allocated() - before - pool
        bound = top_bytes + (policy.max_depth + 1) * ex.layer_bytes
        log(f"[serve-streamed] executor built in {secs:.1f} s: "
            f"{ex.n_layers - ex.resident} of {ex.n_layers} layers, "
            f"{ex.streamed_bytes} B, in pinned host memory; it holds "
            f"{ex.device_nbytes} B on the device (top {top_bytes} B + "
            f"{ex.ring_slots} ring slots), allocated device memory grew by "
            f"{grown} B besides the {pool} B KV pool; bound: top + {policy.max_depth + 1} layers = "
            f"{bound:.0f} B ({smi})")
        if ex.resident or ex.streamed_bytes != ex.n_layers * ex.layer_bytes:
            fail("[serve-streamed] a layer stayed resident on the card")
        if max(ex.device_nbytes, grown) > bound:
            fail(f"[serve-streamed] the executor holds more than top + "
                 f"{policy.max_depth + 1} layers")
        return gen

    # (a) whole-batch
    prompts = [r.prompt for r in serve_run["reqs"][:SLOTS]]
    gen = build(lambda: Generator(cfg, params, g, streamed=True,
                                  policy=policy, device="cuda"))
    t0 = time.perf_counter()
    got = gen.generate(prompts)
    torch.cuda.synchronize()
    t_streamed = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = Generator(cfg, params, g, device="cuda").generate(prompts)
    torch.cuda.synchronize()
    t_resident = time.perf_counter() - t0
    same = sum(a == b for a, b in zip(got, want))
    log(f"[serve-streamed batch] {len(prompts)} prompts, {MAX_NEW} tokens "
        f"each: streamed {t_streamed:.2f} s ({gen.exec.passes} passes), "
        f"resident {t_resident:.2f} s; {same}/{len(prompts)} token rows "
        f"equal ({smi})")
    if got != want:
        fail("[serve-streamed batch] streamed tokens differ from the "
             "resident Generator's on the same weights")
    del gen
    gc.collect()

    # (b) continuous, behind the threaded engine
    gen = build(lambda: ContinuousGenerator(
        cfg, params, g, num_slots=SLOTS, streamed=True, policy=policy,
        paged=True, page_size=PAGE, prefill_chunk=CHUNK, device="cuda"))
    ex = gen.exec
    eng = RagdollEngine(store, QueryEmbedder(queries), gen,
                        BacklogScheduler(max_batch=SLOTS),
                        BacklogScheduler(max_batch=SLOTS),
                        initial_partitions=PARTITIONS - SPILLED,
                        device="cuda")
    out = serve_path(torch, eng, "serve-streamed", CONTINUOUS_KERNELS, exact,
                     smi, cfg.vocab_size, stats=eng.retrieval_stats,
                     step_hist=eng.registry.histogram("decode.step_seconds"),
                     executor=ex, profile=False)
    want = {r.rid: r for r in serve_run["reqs"]}
    fp32, ties = None, 0
    for rid, got_out in out["outputs"].items():
        if got_out == want[rid].output:
            continue
        if fp32 is None:
            fp32 = _cast(params, torch.float32)
        t, a, b, gap, err = _near_tie(torch, cfg, params, fp32, want[rid],
                                      got_out, ctx=CTX)
        msg = (f"[serve-streamed] request {rid} ({want[rid].query}): first "
               f"other token at {t}, {b} for serve's {a}; fp32 logit gap "
               f"{gap:.6f}, bf16 logits off fp32 by up to {err:.6f} in that "
               "row")
        if abs(gap) > 2 * err:
            fail(f"{msg}: not a near tie")
        log(f"{msg}: a near tie ({smi})")
        ties += 1
    del fp32
    log(f"[serve-streamed] {N_REQ}/{N_REQ} requests: serve's {MAX_NEW} "
        f"tokens, but for {ties} that leave them at a near tie")

    # one layer's pinned copy, and decode passes against their copy bound
    torch.cuda.synchronize()
    host = ex._host[0]
    slot = ex._ring[0, :host.numel()]
    copy_ms = _events_ms(torch, lambda: slot.copy_(host, non_blocking=True),
                         5)
    rate = host.numel() / (copy_ms / 1e3)
    cur = torch.zeros((SLOTS, 1), dtype=torch.int32, device="cuda")
    pos = torch.full((SLOTS,), CTX, dtype=torch.int32, device="cuda")
    tab = gen.kv.device_tab()            # drained: every row all trash

    def decode_pass():
        ex.decode(cur, gen.cache, pos, block_tab=tab, kv_span=gen._total)

    decode_pass()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        decode_pass()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    pass_s = statistics.mean(times)
    bound_s = ex.streamed_bytes / rate
    depth = policy.depth("decode", ex.free_bytes, ex.layer_bytes)
    log(f"[serve-streamed] one {host.numel()} B layer pinned host to device: "
        f"{copy_ms:.3f} ms, {rate / 1e9:.2f} GB/s; a decode pass of {SLOTS} "
        f"rows at depth {depth}: {pass_s * 1e3:.1f} ms (mean of 3) against "
        f"a copy bound of {bound_s * 1e3:.1f} ms ({ex.streamed_bytes} B at "
        f"that rate): the bound is {bound_s / pass_s:.1%} of it ({smi})")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_pass()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    records = _kernel_records(prof, torch)
    breakdown("serve-streamed", records, window, smi,
              what=f"one decode pass at depth {depth}")
    copies, h2d_us, share = h2d_overlap(records)
    log(f"[profile serve-streamed] {copies} host to device copies recorded "
        f"of the {ex.n_layers} layers the pass staged: "
        f"{h2d_us / 1e3:.1f} ms ({h2d_us / 1e6 / window:.1%} of the window),"
        f" {share:.1%} of it while a kernel runs; queue depth {depth} decode, "
        f"{policy.depth('prefill', ex.free_bytes, ex.layer_bytes)} prefill "
        f"({smi})")
    del gen, eng, ex, slot, host
    gc.collect()
    return out["counts"]


def phase_store_recluster(torch, store_root: Path, smi: str) -> None:
    """A store of its own (the shared one stays as it is): exact search
    against the plain top-k over its corpus before and after
    ``recluster``, with 2 partitions promoted to the hot tier before; the
    recluster must empty the hot set, remove the spill files and keep
    ``resident_bytes`` equal to its resident partitions' bytes."""
    from repro_torch.kernels import ops
    from repro_torch.retrieval import HotPartitionSet, VectorStore
    from repro_torch.retrieval.synthetic import (ArrayEmbedder, blob_corpus,
                                                 perturb_queries)
    t0 = time.perf_counter()
    vecs = blob_corpus(RECLUSTER_N, CORPUS_DIM, clusters=RECLUSTER_PARTS,
                       seed=2)
    queries = perturb_queries(vecs, SLOTS, seed=3)
    store = VectorStore.build([str(i) for i in range(RECLUSTER_N)],
                              ArrayEmbedder(vecs),
                              num_partitions=RECLUSTER_PARTS,
                              root=str(store_root), device="cuda")
    for pid in range(RECLUSTER_PARTS - RECLUSTER_SPILLED, RECLUSTER_PARTS):
        store.spill(pid)
    spilled = [p.path for p in store.partitions.values() if p.path]
    hot = HotPartitionSet(store, device="cuda")
    hot.retarget(sum(store.partitions[p].nbytes
                     for p in range(RECLUSTER_HOT)),
                 list(range(RECLUSTER_HOT)))
    if hot.pids() != list(range(RECLUSTER_HOT)):
        fail(f"[store] hot set {hot.pids()}, want {RECLUSTER_HOT} promoted")
    want_s, want_i = ops.retrieval_topk(torch.from_numpy(queries).cuda(),
                                        torch.from_numpy(vecs).cuda(), TOP_K,
                                        impl="ref")
    want_s, want_i = want_s.cpu(), want_i.cpu()

    def check(label):
        s, i = store.search(queries, TOP_K, hot=hot)
        check_topk(f"[store {label}]", torch.from_numpy(s),
                   torch.from_numpy(i), want_s, want_i)
        resident = sum(store.partitions[p].nbytes
                       for p in store.resident_set())
        if store.resident_bytes() != resident:
            fail(f"[store {label}] resident_bytes {store.resident_bytes()}, "
                 f"its resident partitions hold {resident} B")
        return resident

    before = check("before recluster")
    hot_bytes = hot.device_bytes()
    t1 = time.perf_counter()
    store.recluster(num_partitions=RECLUSTER_PARTS, seed=1)
    t_recluster = time.perf_counter() - t1
    if hot.pids() or hot.device_bytes():
        fail(f"[store] the hot set kept {hot.pids()} across a recluster")
    if any(os.path.exists(p) for p in spilled):
        fail("[store] a spill file of the old layout survived the recluster")
    after = check("after recluster")
    log(f"[store] {RECLUSTER_N} x {CORPUS_DIM} in {RECLUSTER_PARTS} "
        f"partitions, {RECLUSTER_SPILLED} spilled, {RECLUSTER_HOT} hot "
        f"({hot_bytes} B on the card): exact ids equal the plain top-k "
        f"before and after recluster(num_partitions={RECLUSTER_PARTS}, "
        f"seed=1) ({t_recluster:.2f} s; layout {store.layout_version}); hot "
        f"set emptied ({hot.demotions} demotions); resident_bytes {before} "
        f"-> {after} B, equal to its resident partitions'; "
        f"{time.perf_counter() - t0:.1f} s in all ({smi})")


# ------------------------------------------------------- serve-placement
def _events_ms(torch, fn, iters: int) -> float:
    """Device ms a call: CUDA events around ``iters`` calls, after one.
    A rate needs no split by kernel, so no profiler trace (which can drop
    a record) is taken."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _host_s(torch, fn, reps: int) -> float:
    """Median wall seconds of ``fn`` (each run ends in a synchronize)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _evict(path: str) -> None:
    """Drop a file's pages from the page cache (written back first)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)


def measure_hardware(torch, store, queries, smi: str):
    """The ``HardwareProfile`` fields measured on this card and host, as
    the reference defines them, printed beside ``H100_HOST``; then the
    real time of one cold partition sweep (pin, copy and kernel) and of
    one hot sweep (kernel only) against one partition."""
    import dataclasses

    import numpy as np
    from repro_torch.core.costmodel import H100_HOST
    from repro_torch.kernels import ops
    m, k, n = 8192, 4096, 14336           # llama3-8b's prefill up-projection
    a = torch.randn(m, k, dtype=torch.bfloat16, device="cuda")
    b = torch.randn(k, n, dtype=torch.bfloat16, device="cuda")
    gpu_flops = 2 * m * k * n / (_events_ms(torch, lambda: a @ b, 20) / 1e3)
    del a, b
    src = torch.empty(2 ** 30, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    # a copy reads and writes each byte: the device's memory rate
    hbm = 2 * src.numel() / (_events_ms(torch, lambda: dst.copy_(src), 10)
                             / 1e3)
    del src, dst
    host = torch.empty(2 ** 28, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(2 ** 28, dtype=torch.uint8, device="cuda")
    pcie = host.numel() / (_events_ms(
        torch, lambda: dev.copy_(host, non_blocking=True), 10) / 1e3)
    del host, dev
    cpu_mem = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    spilled = [pid for pid, p in sorted(store.partitions.items())
               if not p.resident][:4]
    read, raw = [], []
    for pid in spilled:                  # the store's own partition load
        p = store.partitions[pid]
        _evict(p.path)
        read.append(p.nbytes / store.load(pid))
        store.release(pid)
    for pid in spilled:                  # the bare np.load
        path = store.partitions[pid].path
        _evict(path)
        t0 = time.perf_counter()
        arr = np.load(path)
        raw.append(arr.nbytes / (time.perf_counter() - t0))
        del arr
    rng = np.random.default_rng(0)
    rows = CORPUS_N // PARTITIONS
    hq = rng.standard_normal((SLOTS, CORPUS_DIM)).astype(np.float32)
    hdb = rng.standard_normal((CORPUS_DIM, rows)).astype(np.float32)
    times = []
    for _ in range(50):
        t0 = time.perf_counter()
        hq @ hdb
        times.append(time.perf_counter() - t0)
    cpu_flops = 2 * SLOTS * CORPUS_DIM * rows / statistics.median(times)
    prof = dataclasses.replace(
        H100_HOST, gpu_flops=gpu_flops,
        gpu_mem=float(torch.cuda.get_device_properties(0).total_memory),
        gpu_hbm_bw=hbm, cpu_mem=float(cpu_mem), pcie_bw=pcie,
        disk_read_bw=statistics.median(read), cpu_flops=cpu_flops,
        disk_raw_bw=statistics.median(raw))
    for name in ("gpu_flops", "gpu_mem", "gpu_hbm_bw", "cpu_mem", "pcie_bw",
                 "disk_read_bw", "cpu_flops", "disk_raw_bw"):
        log(f"[profile-hw] {name}: measured {getattr(prof, name):.6g}, "
            f"H100_HOST {getattr(H100_HOST, name):.6g} ({smi})")
    # cold: pinned staging, the copy and the kernel; hot: the kernel alone;
    # on the host-resident partition nearest the mean size
    part = min((p for p in store.partitions.values() if p.resident),
               key=lambda p: abs(p.embeddings.shape[0] - rows))
    qd = torch.from_numpy(queries[:SLOTS]).cuda()

    def cold():
        emb = store._to_device(part.embeddings)
        ids = store._to_device(part.doc_ids)
        s, i = ops.retrieval_topk(qd, emb, TOP_K)
        return s, ids[i.long()]

    dev_emb = torch.from_numpy(part.embeddings).cuda()
    cold_s = _host_s(torch, cold, 10)
    hot_s = _host_s(torch, lambda: ops.retrieval_topk(qd, dev_emb, TOP_K), 10)
    del dev_emb
    log(f"[profile-hw] one partition ({part.embeddings.shape[0]} x "
        f"{CORPUS_DIM} fp32, {part.nbytes} B) at ({SLOTS}, {CORPUS_DIM}): "
        f"cold sweep (pin + copy + kernel) {cold_s * 1e3:.3f} ms, hot sweep "
        f"(kernel) {hot_s * 1e3:.3f} ms ({smi})")
    return prof, cold_s, hot_s


def _policy_engine(store, queries, gen, opt, profile):
    """A ``RagdollEngine`` on a recording view of the shared store that
    notes each retrieval batch's probe width and each policy boundary's
    host time; its schedulers seeded by active profiling."""
    from repro_torch.core.scheduler import BacklogScheduler
    from repro_torch.serving import RagdollEngine

    class RecordingStore:
        """The store, recording the probe width of every search."""

        def __init__(self, inner):
            self.inner = inner
            self.nprobes = []

        def __getattr__(self, name):
            return getattr(self.inner, name)

        def search(self, q, top_k, **kw):
            self.nprobes.append(kw.get("nprobe"))
            return self.inner.search(q, top_k, **kw)

    class PolicyEngine(RagdollEngine):
        def _retrieve_batch(self, reqs):
            out = super()._retrieve_batch(reqs)
            # only this thread searches: the last search is this batch's
            self.batches.append((self.store.nprobes[-1],
                                 [r.rid for r in reqs]))
            return out

        def _gen_boundary(self):
            t0 = time.perf_counter()
            super()._gen_boundary()
            self.boundary_s.append(time.perf_counter() - t0)

    ret = BacklogScheduler(max_batch=SLOTS)
    ret.seed(profile.ret_samples)
    gsched = BacklogScheduler(max_batch=SLOTS)
    gsched.seed(profile.gen_samples)
    eng = PolicyEngine(RecordingStore(store), QueryEmbedder(queries), gen,
                       ret, gsched, optimizer=opt,
                       initial_partitions=PARTITIONS - SPILLED,
                       policy_every=8, device="cuda")
    eng.batches, eng.boundary_s = [], []
    return eng


def serve_policy(torch, eng, tag, kernels, store, queries, exact, smi, vocab,
                 step_hist=None):
    """Serve ``WARMUP_REQ`` requests, then the 16 measured ones with the
    launch counts set to 0 just before and read just after; request ``i``
    asks query ``i % PLACEMENT_QUERIES``.  Fails unless every request has
    ``MAX_NEW`` tokens and the ids of the plain search at the probe width
    its batch was retrieved with, and every kernel in ``kernels``
    launched.  Prints the policy trace, the boundary's host time, the
    metrics snapshot, p50, p95, tokens/s and recall@5 against the exact
    search."""
    from repro_torch.kernels import ops
    from repro_torch.serving import percentile
    errors = _watch_threads()

    def serve(rids, t_limit):
        return _submit_and_drain(eng, rids, t_limit, tag, errors,
                                 query_of=lambda i: i % PLACEMENT_QUERIES)

    eng.start()
    try:
        serve(list(range(WARMUP_REQ)), 300)
        torch.cuda.synchronize()
        n_events = len(eng.policy_trace)
        n_bound = len(eng.boundary_s)
        if step_hist is not None:
            steps0, secs0 = step_hist.count, step_hist.total
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = serve(list(range(WARMUP_REQ, WARMUP_REQ + N_REQ)), 600)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
    finally:
        eng.stop()
    if errors:
        fail(f"[{tag}] worker thread died: {errors}")
    reqs = sorted((r for r in done if r.rid >= WARMUP_REQ),
                  key=lambda r: r.rid)
    if len(reqs) != N_REQ:
        fail(f"[{tag}] {len(reqs)} of {N_REQ} requests came back")
    probe_of = {rid: nprobe for nprobe, rids in eng.batches for rid in rids}
    plain, hits = {}, 0
    ex_s, ex_i = exact
    for r in reqs:
        qi = r.rid % PLACEMENT_QUERIES
        toks = r.output.split()
        if len(toks) != MAX_NEW or not all(0 <= int(t[3:]) < vocab
                                           for t in toks):
            fail(f"[{tag}] request {r.rid}: {len(toks)} tokens, want "
                 f"{MAX_NEW}")
        nprobe = probe_of[r.rid]
        if (qi, nprobe) not in plain:
            s, i = store.search(queries[qi:qi + 1], TOP_K, nprobe=nprobe,
                                impl="ref")
            plain[qi, nprobe] = (torch.from_numpy(s), torch.from_numpy(i))
        want_s, want_i = plain[qi, nprobe]
        got = torch.tensor([[int(c) for c in r.retrieved]])
        if got.shape[1] != TOP_K:
            fail(f"[{tag}] request {r.rid}: {got.shape[1]} chunks")
        check_topk(f"[{tag}] request {r.rid} retrieval at nprobe {nprobe}",
                   want_s, got, want_s, want_i)
        hits += len(set(got[0].tolist()) & set(ex_i[qi].cpu().tolist()))
    missing = [n for n in kernels if counts[n] == 0]
    if missing:
        fail(f"[{tag}] kernels never launched on this path: {missing}")
    trace = eng.policy_trace[n_events:]
    bound = eng.boundary_s[n_bound:]
    if not trace:
        fail(f"[{tag}] no policy boundary ran in the measured window")
    rows, last = [], None
    for ev in trace:
        row = (ev.gen_batch, ev.gen_slots, ev.kv_pages, ev.kv_host_pages,
               ev.nprobe, ev.resident_partitions, ev.hot_partitions,
               ev.hot_bytes, ev.c_gpu, ev.w_gpu)
        if rows and row == last:
            rows[-1][1] += 1
        else:
            rows.append([row, 1])
        last = row
    for row, n in rows:
        log(f"[{tag}] policy x{n}: gen_batch {row[0]}, slots {row[1]}, pages "
            f"{row[2]}, host pages {row[3]}, nprobe {row[4]}, resident "
            f"partitions {row[5]}, hot partitions {row[6]} ({row[7]} B); "
            f"c_gpu {row[8]}, w_gpu {row[9]}")
    lat = [r.latency for r in reqs]
    p50, p95 = percentile(lat, 50), percentile(lat, 95)
    share = ""
    if step_hist is not None:
        steps = step_hist.count - steps0
        step_s = step_hist.total - secs0
        share = (f"; {steps} generator steps, mean "
                 f"{step_s / max(steps, 1) * 1e3:.1f} ms; boundaries "
                 f"{sum(bound) / max(step_s + sum(bound), 1e-9):.2%} of the "
                 f"pump's step + boundary time")
    fit = eng.gen_scheduler
    log(f"[{tag}] {len(bound)} policy boundaries in the measured window: "
        f"host time mean {statistics.mean(bound) * 1e3:.2f} ms, max "
        f"{max(bound) * 1e3:.2f} ms{share}; the generation scheduler's fit "
        f"at the end T(B) = {fit.a:.4g} * B^{fit.c:.3f} over "
        f"{len(fit.samples)} samples ({smi})")
    probes = sorted({probe_of[r.rid] for r in reqs}, key=str)
    log(f"[{tag}] {N_REQ}/{N_REQ} requests served, {MAX_NEW} tokens each, "
        f"ids equal to the plain search at their batch's nprobe {probes}; "
        f"recall@{TOP_K} against the exact search "
        f"{hits / (N_REQ * TOP_K):.3f}; in {wall:.3f} s: p50 {p50:.3f} s "
        f"p95 {p95:.3f} s, {N_REQ * MAX_NEW / wall:.1f} output tokens/s "
        f"({smi})")
    snap = eng.metrics_snapshot()
    log(f"[{tag}] metrics_snapshot gauges: "
        f"{json.dumps(snap['gauges'], sort_keys=True)}")
    log(f"[{tag}] launches on this path: {json.dumps(counts)}")
    return dict(counts=counts, p50=p50, tokens_s=N_REQ * MAX_NEW / wall)


def phase_serve_placement(torch, cfg, params, store, queries, exact,
                          smi: str, baselines):
    """The placement slice on the card (see the module docstring): the
    measured profile, active profiling, both policy paths (printed beside
    ``baselines``, this run's serve, serve-batch and serve-serial), the
    hot tier and the OOM ladder.  Returns the launch counts of its
    measured runs."""
    import gc

    import numpy as np
    from repro_torch.core.costmodel import CostModel, ModelProfile
    from repro_torch.core.placement import Placement, PlacementOptimizer
    from repro_torch.core.profiler import ActiveProfiler
    from repro_torch.core.scheduler import BacklogScheduler
    from repro_torch.ft import OOMRecovery
    from repro_torch.kernels import ops
    from repro_torch.retrieval.cache import HotPartitionSet
    from repro_torch.serving import (ContinuousGenerator, Generator,
                                     GeneratorConfig, RagdollEngine, Request)
    from repro_torch.serving.kvpool import PagedKVCache
    tag = "serve-placement"
    # 1. the profile
    profile_hw, cold_s, hot_s = measure_hardware(torch, store, queries, smi)
    mp = ModelProfile.from_config(cfg, kv_format="bf16")

    def optimizer():
        cost = CostModel(profile_hw, mp,
                         partition_bytes=store.partition_bytes(),
                         num_partitions=PARTITIONS, db_dim=CORPUS_DIM,
                         chunks_per_partition=CORPUS_N / PARTITIONS,
                         partition_mem_overhead=1.0)
        return PlacementOptimizer(cost, avg_ctx_len=CTX, avg_out_len=MAX_NEW,
                                  kv_page_size=PAGE)

    opt = optimizer()
    log(f"[{tag}] the cost model prices a partition sweep of {SLOTS} queries "
        f"at {opt.cost.partition_search_time(SLOTS) * 1e3:.3f} ms (host FLOP/s"
        f") cold and {opt.cost.device_search_time(SLOTS) * 1e3:.3f} ms hot; "
        f"measured {cold_s * 1e3:.3f} and {hot_s * 1e3:.3f} ms ({smi})")
    # 2. active profiling: real retrieval and generation batches of B
    g = GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW,
                        dtype=torch.bfloat16)
    batch_gen = Generator(cfg, params, g, device="cuda")

    def measure(p):
        b = p.gen_batch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, ids = store.search(queries[:b], TOP_K, nprobe=p.nprobe)
        t_ret = time.perf_counter() - t0
        prompts = [" ".join(ch) + f" q{i}"
                   for i, ch in enumerate(store.get_chunks(ids))]
        t0 = time.perf_counter()
        batch_gen.generate(prompts)
        torch.cuda.synchronize()
        return t_ret, time.perf_counter() - t0

    measure(Placement(1.0, 0.0, 1.0, 0.0, PARTITIONS, 1))      # warm-up
    t0 = time.perf_counter()
    prof = ActiveProfiler(opt, batches=PLACEMENT_BATCHES).profile(
        measure=measure)
    for (b, t_gen), (_, t_ret) in zip(prof.gen_samples, prof.ret_samples):
        p = prof.placements[int(b)]
        log(f"[{tag}] active profiling B {int(b)}: t_ret {t_ret:.4f} s, t_gen "
            f"{t_gen:.4f} s; placement w_gpu {p.w_gpu} c_gpu {p.c_gpu} "
            f"resident {p.resident_partitions} nprobe {p.nprobe} ({smi})")
    log(f"[{tag}] active profiling took {time.perf_counter() - t0:.1f} s; "
        f"best batch {prof.best_batch}")
    results = {}
    # 3. the continuous path with the policy
    gen = ContinuousGenerator(cfg, params, g, num_slots=SLOTS, paged=True,
                              page_size=PAGE, prefill_chunk=CHUNK,
                              device="cuda")
    eng = _policy_engine(store, queries, gen, opt, prof)
    results["continuous"] = serve_policy(
        torch, eng, f"{tag} continuous", SERVE_PLACEMENT_KERNELS, store,
        queries, exact, smi, cfg.vocab_size,
        step_hist=eng.registry.histogram("decode.step_seconds"))
    del gen, eng
    # 4. the whole-batch path with the policy
    eng = _policy_engine(store, queries, batch_gen, optimizer(), prof)
    results["whole-batch"] = serve_policy(
        torch, eng, f"{tag} whole-batch", WHOLE_BATCH_KERNELS, store,
        queries, exact, smi, cfg.vocab_size)
    del eng
    for path, without in (("continuous", ("serve",)),
                          ("whole-batch", ("serve-batch", "serve-serial"))):
        got = results[path]
        log(f"[{tag}] {path}: p50 {got['p50']:.3f} s, {got['tokens_s']:.1f} "
            "tokens/s with the policy; " + ", ".join(
                f"{name} p50 {baselines[name]['p50']:.3f} s, "
                f"{baselines[name]['tokens_s']:.1f} tokens/s"
                for name in without) + f" ({smi})")
    p50 = results["whole-batch"]["p50"]
    base, serial = (baselines["serve-batch"]["p50"],
                    baselines["serve-serial"]["p50"])
    log(f"[{tag}] serial / ragdoll p50 {serial / p50:.3f} with the policy, "
        f"{serial / base:.3f} without ({smi})")
    # 5. the hot tier on the card, under a probe mask
    qs = queries[:PLACEMENT_QUERIES]
    pids, mask = store.probe(qs, HOT_NPROBE)
    hot_pids = pids[:HOT_N]
    grant = sum(store.partitions[pid].nbytes for pid in hot_pids)
    hot = HotPartitionSet(store, device="cuda")
    hot.retarget(grant, hot_pids)
    if hot.pids() != sorted(hot_pids) or hot.device_bytes() != grant:
        fail(f"[{tag}] hot tier holds {hot.pids()} ({hot.device_bytes()} B) "
             f"under a grant of {hot_pids} ({grant} B)")
    hot_boards = store.sweep_boards(qs, hot_pids, TOP_K, hot=hot)
    cold_boards = store.sweep_boards(qs, hot_pids, TOP_K)
    if not all(torch.equal(h, c)
               for h, c in zip(hot_boards[:2], cold_boards[:2])):
        fail(f"[{tag}] hot sweep differs from the cold sweep")
    hot_search = store.search(qs, TOP_K, nprobe=HOT_NPROBE, hot=hot)
    cold_search = store.search(qs, TOP_K, nprobe=HOT_NPROBE)
    if not all(np.array_equal(h, c)
               for h, c in zip(hot_search, cold_search)):
        fail(f"[{tag}] hot search differs from the cold search")
    t_hot = _host_s(torch, lambda: store.search(qs, TOP_K, nprobe=HOT_NPROBE,
                                                hot=hot), 3)
    t_cold = _host_s(torch, lambda: store.search(qs, TOP_K,
                                                 nprobe=HOT_NPROBE), 3)
    log(f"[{tag}] hot tier: {HOT_N} partitions {hot.pids()} ({grant} B) "
        f"promoted; boards and the search at nprobe {HOT_NPROBE} "
        f"({int(mask.sum(1).max())} of {PARTITIONS} partitions a query, "
        f"{len(pids)} in the union) bit-equal to the cold ones; search "
        f"{t_hot:.4f} s hot, {t_cold:.4f} s cold ({smi})")
    served = RagdollEngine(store, QueryEmbedder(queries), batch_gen,
                           BacklogScheduler(max_batch=SLOTS),
                           BacklogScheduler(max_batch=SLOTS), device="cuda")
    try:
        served.nprobe = HOT_NPROBE
        served.hot.retarget(grant, hot_pids)
        reqs = [Request(rid=i, query=f"q{i % PLACEMENT_QUERIES}",
                        arrival=time.perf_counter(), top_k=TOP_K,
                        max_new_tokens=MAX_NEW) for i in range(SLOTS)]
        ops.reset_launch_counts()
        served._retrieve_batch(reqs)
        served._generate_batch(reqs)
        results["hot"] = dict(counts=ops.launch_counts())
        stats = served.retrieval_stats
    finally:
        served.streamer.close()
    if not (stats.hot_hits > 0 and all(len(r.output.split()) == MAX_NEW
                                       for r in reqs)):
        fail(f"[{tag}] served batch: hot_hits {stats.hot_hits}")
    for name in ("retrieval_topk", "retrieval_topk_merge"):
        if results["hot"]["counts"][name] == 0:
            fail(f"[{tag}] the hot batch never launched {name}")
    log(f"[{tag}] a served batch of {SLOTS} at nprobe {HOT_NPROBE}: hot_hits "
        f"{stats.hot_hits} of {stats.partitions_searched} partitions "
        f"searched, {stats.partitions_pruned} pruned")
    del hot, served
    # 6. the OOM ladder on the card
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    start = Placement(1.0, 0.0, 1.0, 0.0, 0, OOM_BATCH, nprobe=PARTITIONS)
    ooms = []

    def page_pool(p):
        pages = opt.kv_page_budget(p, PAGE)
        kv = PagedKVCache(cfg, SLOTS, CTX + MAX_NEW, PAGE, num_pages=pages,
                          dtype=torch.bfloat16, device="cuda")
        try:
            pools = kv.init_stacked()
        except torch.OutOfMemoryError:
            ooms.append(pages)
            raise
        torch.cuda.synchronize()
        nbytes = kv.pool_nbytes(pools)
        del pools
        return pages, nbytes

    rec = OOMRecovery(opt)
    (pages, nbytes), final = rec.run(page_pool, start)
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    if not rec.history or not ooms:
        fail(f"[{tag}] the ladder saw no out-of-memory error")
    if after != before:
        fail(f"[{tag}] memory allocated {before} B before the ladder, "
             f"{after} B after")
    for i, p in enumerate(rec.history):
        log(f"[{tag}] OOM ladder rung {i}: c_gpu {p.c_gpu:.2f} c_cpu "
            f"{p.c_cpu:.2f} w_gpu {p.w_gpu:.2f} gen_batch {p.gen_batch}: "
            f"{opt.kv_page_budget(p, PAGE)} pages, torch.OutOfMemoryError")
    log(f"[{tag}] OOM ladder: succeeded at c_gpu {final.c_gpu:.2f} c_cpu "
        f"{final.c_cpu:.2f} w_gpu {final.w_gpu:.2f} gen_batch "
        f"{final.gen_batch}: {pages} pages, {nbytes / 2 ** 30:.2f} GiB; "
        f"memory allocated {before} B before and after ({smi})")
    return [r["counts"] for r in results.values()]

CATEGORIES = (
    # the split kernels and their merge passes (*_decode_combine_kernel)
    ("paged decode attention", ("paged_decode_",)),
    ("dense decode attention", ("dense_decode_",)),
    ("flash attention (prefill)", ("flash_wgmma_kernel", "flash_fp32_kernel")),
    ("rmsnorm", ("rmsnorm_kernel",)),
    ("retrieval top-k and merge", ("topk_stream_kernel", "merge_kernel")),
    ("matmul (projections, MLP, lm_head)",
     ("gemm", "xmma", "nvjet", "cutlass")),
    ("copy host to device", ("Memcpy HtoD",)),
    ("copy device to host", ("Memcpy DtoH",)),
)


def breakdown(tag, records, window_s: float, smi: str,
              what: str = f"{PROFILE_REQ} requests") -> None:
    """Device busy share of a serving window (``what``) and its time by
    kind."""
    if not records:
        log(f"[profile {tag}] the profiler recorded no device activity: "
            "not measured")
        return
    busy, cur = 0.0, None
    for start, end in sorted((s, s + d) for _, s, d in records):
        if cur is None or start > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    busy = (busy + cur[1] - cur[0]) / 1e6
    cats, names = {}, {}
    for name, _, d in records:
        label = next((lab for lab, keys in CATEGORIES
                      if any(k.lower() in name.lower() for k in keys)),
                     "other (elementwise, indexing, reductions, memset)")
        cats[label] = cats.get(label, 0.0) + d / 1e6
        names[name] = names.get(name, 0.0) + d / 1e6
    total = sum(cats.values())
    log(f"[profile {tag}] {what}: wall {window_s:.2f} s, "
        f"device busy {busy:.2f} s ({busy / window_s:.1%}), idle "
        f"{1 - busy / window_s:.1%} ({smi})")
    for label, t in sorted(cats.items(), key=lambda kv: -kv[1]):
        log(f"[profile {tag}]   {t:8.3f} s {t / total:6.1%}  {label}")
    for name, t in sorted(names.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile {tag}]   top {t:8.3f} s  {name[:110]}")


def _cast(tree, dtype):
    """A parameter tree in ``dtype`` (the same tensors where they are)."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


SOURCES = {
    "rmsnorm": ("cuda", "src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:22"),
    "flash_attention": ("cuda", "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:88"),
    "decode_attention": ("cuda", "src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:76"),
    "paged_decode_attention": ("cuda", "src/repro_torch/csrc/paged_attention.cu",
                               "src/repro/kernels/paged_attention.py:124"),
    "retrieval_topk": ("cuda", "src/repro_torch/csrc/topk_retrieval.cu",
                       "src/repro/kernels/topk_retrieval.py:58"),
    "retrieval_topk_merge": ("cuda", "src/repro_torch/csrc/topk_retrieval.cu",
                             "src/repro/kernels/topk_retrieval.py:146"),
}


def main() -> int:
    import torch
    t_start = time.perf_counter()
    name, smi = phase_device(torch)
    phase_build(torch)
    store_root = ROOT / "build" / "smoke_corpus"
    recluster_root = ROOT / "build" / "smoke_recluster"
    shutil.rmtree(store_root, ignore_errors=True)
    shutil.rmtree(recluster_root, ignore_errors=True)
    try:
        store, queries, exact = phase_corpus(torch, store_root)
        rows = phase_kernels(torch, Timer(torch), store, queries)
        phase_model(torch)
        cfg, params = build_weights(torch)
        paged = phase_serve(torch, cfg, params, store, queries, exact, smi)
        batch = phase_serve_batch(torch, cfg, params, store, queries, exact,
                                  smi, paged["outputs"])
        swap = phase_serve_swap(torch, cfg, params, store, queries, exact,
                                smi)
        prefix = phase_serve_prefix(torch, cfg, params, store, queries,
                                    exact, smi)
        streamed = phase_serve_streamed(torch, cfg, params, store, queries,
                                        exact, smi, paged)
        phase_store_recluster(torch, recluster_root, smi)
        # last: its partition cache releases partitions to disk
        placement = phase_serve_placement(torch, cfg, params, store, queries,
                                          exact, smi, dict(batch, serve=paged))
    finally:
        shutil.rmtree(store_root, ignore_errors=True)
        shutil.rmtree(recluster_root, ignore_errors=True)
    runs = ([paged["counts"], swap] + [r["counts"] for r in batch.values()]
            + prefix + [streamed] + placement)
    kernels = []
    for kname, (route, source, replaces) in SOURCES.items():
        kernels.append(dict(name=kname, route=route, source=source,
                            replaces=replaces,
                            launches=sum(c[kname] for c in runs),
                            **rows[kname]))
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
