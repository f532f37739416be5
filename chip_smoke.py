#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of RAGDoll on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # everything, as the acceptance run does

Phases, each of which fails the run (non-zero exit, no result line):

1. device  -- a CUDA card must be present; prints its name and power limit.
2. build   -- compiles every hand-written kernel from ``src/repro_torch``
              (on a thread, while the corpus is made); prints the
              registers and spills of the redesigned attention kernels
              and their launch shapes at the main paths' sizes.
3. corpus  -- ``blob_corpus(1_000_000, 768)`` in 64 IVF partitions, a
              quarter of them spilled to disk under ``build/``.
4. kernels -- each kernel against its plain PyTorch version at the main
              paths' shapes, with its time, the plain version's, one
              library call's and the card's bound for the same work; the
              RMSNorm fused with the residual add (``add_rmsnorm``) also
              with its wrapper's host time per call; the fp32 flash kernel
              (3xTF32, its own row ``flash_attention_fp32``) against its
              3xTF32 bound (``PEAK_TF32 / 3``) with the CUDA cores' bound
              and its device ms by kernel beside it.
4a. train-kernels -- the training kernels against their plain versions:
              the flash backward (``csrc/flash_attention_bwd.cu``; bf16 on
              wgmma, fp32 on 3xTF32 ``mma.sync``, its own row
              ``flash_attention_bwd_fp32`` against its 3xTF32 bound with
              the CUDA cores' beside it) at llama3-8b's shapes (B = 4, S = 2048, 32/8 x 128,
              causal) in bf16 and fp32, then at D = 64, bidirectional, a
              window of 4096 with softcap 50 (S = 6144) and a ragged S, and
              at every head-dim pair the families train at, bf16 and fp32:
              D = 16 (window 16, softcap 50), gemma2-2b's 8/4 x 256 at
              (1, 6144) (window 4096, softcap 50), gemma-7b's 16/16 x 256
              at (2, 4096), deepseek's 16/16 x (192, 128) at (2, 4096) and
              G = 8 (64/8 x 128) at (1, 4096), against the plain
              ``flash_vjp`` passes, two calls bit-equal; the RMSNorm
              backward, both forms, at (8192, 4096) in bf16 and fp32 (two
              calls bit-equal, its device ms by kernel); the
              flash forward's ms with and without its log-sum-exp.  Kernel,
              plain, library (SDPA's and ``F.rms_norm``'s backward through
              autograd) and bound ms (the backward's: FlashAttention-2's 5
              products; the 7 the kernel runs beside it).
4b. mesh   -- the mesh paths (``Model(ctx=...)``, the train step, the
              MoE over a mesh) on a one-rank NCCL group, a (data=1,
              model=1) mesh: llama3-8b at full width and depth 2 in bf16,
              one train step from one seeded init and batch, its loss and
              every updated leaf bit-equal to the unsharded step's (each on
              a fresh AdamW state; over a group of one every collective is
              the identity); prefill and 8 decode steps on the dense cache,
              the tokens equal to the unsharded run's; flash forward and
              backward, RMSNorm and dense decode launched by the mesh's
              runs.  granite-moe-1b-a400m at full width in fp32: the
              tensor-parallel ``moe_forward(ctx=...)`` equal to the local
              MoE, ``moe_forward_ep`` at ``capacity_factor`` 8 within 1e-5
              of it and at 1.25 within 1e-5 of the same function on the
              CPU, its dropped rows the same.
5. model   -- a reduced llama on the card (kernels) against the same
              weights on the CPU (plain versions): logits and tokens of
              chunked prefill + paged decode, and of one-shot prefill +
              dense decode.
5-train. train -- llama3-8b at full width through the port's training
              path (``Model.loss_fn``, ``make_train_step``, remat on): (a)
              one layer in fp32 at batch 1 x 256, card against CPU, the
              loss and every gradient leaf; (b) 4 layers, bf16 weights and
              fp32 master state, 8 AdamW steps on ``SyntheticLM`` at batch
              4 x 2048: the loss falls, both backward kernels and the flash
              and RMSNorm forwards launch; step ms, tokens/s, MFU, peak
              memory, one profiled step's idle share; (c) the checkpoint of
              step 4 restored into a fresh state gives step 5's loss and
              parameters exactly.
5-train-families. train-families -- gemma2-2b (one local and one
              global layer, batch 1 x 6144), gemma-7b (one layer, 1 x
              4096) and deepseek-v2-lite (its dense MLA layer, 1 x 2048)
              at full width: the fp32 config at 1 x 256 card against CPU
              (loss and every gradient leaf), then 3 steps in bf16 with
              fp32 AdamW state (every loss finite, the flash backward once
              per attention layer and step); then ``launch/train.py``'s
              default reduced llama (head dim 16, fp32) for 20 steps on
              the card (the fp32 backward launched, the loss down).  Each
              fp32 card-against-CPU check is profiled: its forward must run
              ``flash_tf32_kernel`` and its backward ``dkdv_tf32_kernel``
              and ``dq_tf32_kernel``.
5a. family-kernels -- the attention kernels at the shapes of gemma2-2b
              (8/4 heads x 256, window 4096, softcap 50: paged and dense
              decode at kv_len 4100-6200, a prefill chunk at q_offset
              5888, where the window masks; bf16, int8 pages and the fp32
              chunk), gemma-7b (16/16 x 256), chatglm3-6b (32/2 x 128) and
              granite-moe-1b-a400m (16/8 x 64), and the fused RMSNorm at
              widths 2304, 3072 and 1024, each against its plain version
              with kernel, plain, library (SDPA, ``F.rms_norm``) and bound
              ms; they go into the ``kernels`` line as ``shapes``.
5b. family-models -- each of the four at full width and one pattern
              repeat of depth: card fp32 logits against CPU fp32 logits
              (chunked prefill + paged decode, one-shot prefill + dense
              decode), and card bf16 chunked + paged against one-shot +
              dense (both printed against card fp32).
5c. serve-gemma2 -- gemma2-2b at full width and depth (26 layers, seeded
              bf16 weights) behind ``RagdollEngine``: the paged,
              chunk-prefilled generator serves 16 requests at ctx 1024
              (p50, p95, tokens/s; one profiled decode step's kernels and
              busy share), the whole-batch ``Generator`` serves them again
              and every request's tokens must be equal or part at an
              fp32-witnessed near tie; then 4 requests at ctx 6144 on both
              paths (the 4096 window masks in prefill and decode), held the
              same way; then 4 requests over int8 pages.
5d. serve-families -- gemma-7b, chatglm3-6b and granite-moe-1b-a400m at
              full width and depth, one after the other: 8 requests of 16
              tokens on the paged and on the whole-batch path; gemma-7b and
              chatglm3 held to the whole-batch tokens, granite to its
              paged path with the weights cast to fp32 (its whole-batch
              prefill takes the capacity path, which drops rows; the
              drops of one prefill are printed).
5e. serve-deepseek -- deepseek-v2-lite-16b at full width and depth 14
              of its 27 (cut for time; MLA, a dense first layer, 13 MoE
              layers of 64 experts top 6 and 2 shared): 8 requests of 16 tokens at ctx
              1024 on the whole-batch path (the capacity path's drops
              printed) and the dense continuous path (no paged path: it
              must raise), the latter held to the whole-batch
              ``Generator`` run a request at a time (the exact grouped
              GEMM, as a join) but at near ties witnessed in fp32 cast a
              layer at a time; one profiled decode step; one 1024-token
              join and one layer's exact grouped GEMM timed; then streamed
              at 9 layers (the prefix and 8 MoE layers): 2 requests x 4
              tokens equal to the resident run's, flash and RMSNorm
              launched in the streamed run itself (its counts alone), a
              decode pass against its copy bound.  The family-kernel phase
              holds the flash kernel at its q/k 192, v 128 (bf16 and fp32),
              RMSNorm at 512 and 2048, and the exact MoE path's bf16
              products to fp32 at granite's and deepseek's expert shapes;
              the model phase holds deepseek at depth 2 and mamba2 at
              depth 1, card fp32 against CPU fp32.
5f. serve-mamba2 -- mamba2-370m at full width and depth (48 SSD layers):
              the same two paths, held to each other at near ties, a
              profiled step, the paged refusal, streamed at 8 layers
              (RMSNorm launched in the streamed run).
5g. serve-jamba -- jamba-1.5-large-398b at full width and depth 4 (its
              four layer kinds; 45.95 GB of bf16 weights): the whole-batch
              and dense continuous paths behind ``RagdollEngine``, 8
              requests of 16 tokens, the continuous tokens held to the
              whole-batch ``Generator`` a request at a time at near ties
              witnessed in fp32 (a MoE layer cast an expert at a time);
              one 8-prompt prefill's capacity-path drops; the paged
              refusal; a profiled step; a 1024-token join timed with its
              peak memory; then streamed at depth 4 through a ring of 2
              slots of the largest layer, the card's copy of the layers
              dropped once the executor has pinned its own (flash, dense
              decode and RMSNorm launched in the streamed run).  The
              family-kernel phase holds both decode kernels at its 64/8
              heads x 128 (G = 8), the flash kernel there and RMSNorm at
              8192 and 16384 (bf16, fp32); the model phase holds jamba at
              depth 4 with 2 experts (every width full), card fp32 against
              CPU fp32.
5h. serve-llama70b -- llama3-70b at full width and depth 4: the paged,
              chunk-prefilled path (the G = 8 paged decode) and the
              whole-batch path (the G = 8 dense decode), 8 requests of 16
              tokens, held to each other at fp32-witnessed near ties; the
              model phase holds it at one layer, card fp32 against CPU
              fp32.
5i. serve-seamless -- seamless-m4t-medium (the embed frontend's
              encoder-decoder: 12 bidirectional encoder layers, 12 decoder
              layers with cross attention, 16/16 heads x 64) at full width
              and depth through ``Model``, the one path the reference
              serves it on: 8 requests of 1024 seeded encoder frames and a
              16-token prompt, 32 greedy tokens; each request's tokens equal
              to its tokens run alone but at fp32-witnessed near ties;
              ``Generator``, ``PagedKVCache`` and ``StreamedExecutor``
              refuse it.  The family-kernel phase holds the flash kernel
              never causal at 16/16 x 64 (the encoder's (8, 1024) and
              (8, 1000), the cross (8, 128) against (8, 1024); bf16, fp32)
              and both decode kernels at G = 1, D = 64 (the cross read at
              1024 and 1000 frames, the self read at 17-160); the model
              phase holds it at 2 + 2 layers, card fp32 against CPU fp32.
5j. serve-chameleon -- chameleon-34b (embedding inputs, no token table)
              at full width and depth (48 layers, 67.5 GB of bf16 weights
              seeded on the card once every earlier family is freed): 8
              prompts of 1024 embeddings, 16 decode steps over stub
              embeddings, every step's logits on 2 rows within twice the
              bf16 one-shot prefill's error of fp32 (both a layer at a
              time); then its first 8 layers resident and streamed, the
              logits equal.  The model phase holds it at 2 layers.
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
              pages for every slot and no host pool; the profiled batch
              must run ``flash_tf32_kernel`` (the int8 chunk attends in
              fp32), whose share of the busy time is printed.
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
              the resident one's 8 tokens exactly; (b) the streamed paged,
              chunk-prefilled ``ContinuousGenerator`` behind a threaded
              ``RagdollEngine`` serves 8 of the 16 requests, no warm-up
              first (p50, p95, tokens/s, passes, bytes staged) with
              serve's tokens, or leaves them
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
12. serve-sharded -- sharded retrieval on the shared store: (a)
              ``ShardedIVFStore`` over 2 and 4 shards, exact and at nprobe
              16, bit-equal to the single-host search (each shard's sweep
              ms, both searches' ms), then each shard's hot tier under its
              share of a grant of 16 partitions' bytes: only its own
              partitions, the hot search bit-equal to the cold one; (b) a
              one-rank NCCL group: ``sharded_topk_merge`` of the 4 shards'
              boards equal to the local merge, ``distributed_topk`` over
              the 1M rows with one top-k's ids, the all-gather's ms beside
              the cost model's; (c) ``RagdollEngine(retrieval_shards=4)``
              with the optimizer on ``H100_HOST`` and the serve generator:
              16 requests with the single-host search's ids at each
              batch's nprobe and serve's tokens but at fp32-witnessed near
              ties (where the chunks are serve's), each shard's budgets
              and hot partitions after the last boundary.
13. serve-placement -- the placement optimizer on the card, last (its
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

After serve-batch, a ``[sim]`` line (printed, not gated): the port's
simulator on ``H100_HOST`` for the same burst, whole-batch ragdoll and
the serial baseline, each predicted p50 beside the measured one.  The
kernels phase also holds the merge at the cross-shard shapes (8, 2, 5)
and (8, 4, 5) against its plain version.

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

import collections
import concurrent.futures
import contextlib
import functools
import json
import os
import re
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
PEAK_TF32 = 494.7e12        # tensor cores, TF32 in, fp32 accumulation
# fp32-exact attention on the tensor cores (the fp32 flash kernel) takes
# three TF32 products a product (3xTF32): its bound is at a third of the
# TF32 peak; the CUDA cores' bound (PEAK_FP32) is printed beside it
PEAK_FP32_ATTN = PEAK_TF32 / 3

# llama3-8b serving shapes of the main paths
CTX, MAX_NEW, PAGE, CHUNK, SLOTS = 1024, 32, 16, 256, 8
HEADS, KV_HEADS, HEAD_DIM = 32, 8, 128
RAGGED_CHUNK = 200          # a prefill chunk shorter than the kernel's tiles
# short and long slots in one decode step: empty, partial and full splits
MIXED_LENGTHS = (1, 17, 300, 1056, 1, 17, 300, 1056)
SERIAL_BATCH = 4            # launch/serve.py --serial
N_REQ, WARMUP_REQ, PROFILE_REQ, TOP_K = 16, 2, 8, 5
# serve-streamed, cut for time: its whole-batch check takes 8 tokens a
# prompt, and its engine run no warm-up (2 requests took 14-15 s at the
# copy bound) and 8 of serve's requests (16 took 32-38 s)
STREAMED_BATCH_NEW, STREAMED_REQS = 8, 8
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
# (int8 pages: the chunked prefill attends over the fp32 dequantized
# gather, through the fp32 flash kernel)
SWAP_KERNELS = ("rmsnorm", "paged_decode_attention", "retrieval_topk",
                "retrieval_topk_merge", "flash_attention_fp32")
SWAP_PRIORITY_REQ = 4       # serve-swap: the last 4 requests are priority 1
# serve-swap profiles a batch of 2 (8 took 17 s, and as long again to stop
# the profiler: 4338 kernels a step over int8 pages)
SWAP_PROFILE_REQ = 2
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
# serve-sharded: the shared store over 2 and 4 retrieval shards, at nprobe
# 16 and exact; a hot grant of 16 partitions' bytes split across the
# shards; the engine with 4 shards
SHARD_COUNTS = (2, 4)
SHARDED_NPROBE = 16
SHARDED_HOT = 16
ENGINE_SHARDS = 4
SHARDED_KERNELS = CONTINUOUS_KERNELS
# the attention families: gemma2-2b's window and attention softcap; its
# long prompts (the window masks only past 4096 tokens); serve-families'
# requests and tokens each; full-width fp32 logits card vs CPU (sums of
# 1024-4096 terms in other orders than the CPU's, scaled by the softcaps);
# card bf16 chunked + paged against card bf16 one-shot + dense, as a share
# of the largest logit (a check that the two bf16 paths compute one
# function, not a bound on bf16; bf16 against fp32 is printed, not held:
# a MoE's bf16 router input turns near-tied top-k choices, whole experts)
FAMILY_ARCHS = ("gemma2-2b", "gemma-7b", "chatglm3-6b",
                "granite-moe-1b-a400m")
GEMMA2_WINDOW, GEMMA2_SOFTCAP = 4096, 50.0
LONG_CTX, LONG_REQ = 6144, 4
FAMILY_REQ, FAMILY_NEW = 8, 16
FAMILY_LOGIT_TOL = 1e-3
# the exact MoE path's bf16 x bf16 -> fp32 products against the same
# products of fp32 copies, over the largest |value|: fp32 rounding (a
# product rounded to bf16 is about 2e-3 off)
MOE_PRODUCT_TOL = 1e-5
BF16_MODEL_REL = 0.1
# the dense-cache families: deepseek-v2-lite's MLA over a dense
# first layer and 26 MoE layers (64 experts top 6, 2 shared), mamba2-370m's
# 48 SSD layers; neither has a paged path.  Card fp32 against CPU fp32 at
# full width and a cut depth; serving at full depth; streamed at 9 layers
# (deepseek: the prefix and 8 MoE layers) and 8 (mamba2, cut from 48 for
# time), 2 requests x 4 tokens each
DEEPSEEK, MAMBA2 = "deepseek-v2-lite-16b", "mamba2-370m"
LLAMA70B, JAMBA = "llama3-70b", "jamba-1.5-large-398b"
DENSE_MODEL_DEPTH = {DEEPSEEK: 2, MAMBA2: 1, JAMBA: 4}
DEEPSEEK_STREAMED_DEPTH = 9
# serve-deepseek: the prefix and 13 MoE layers of 27 (cut for time: the
# phase took 52.6 s at 27 on the H100)
DEEPSEEK_SERVE_DEPTH = 14
MAMBA2_STREAMED_DEPTH = 8
STREAMED_REQ, STREAMED_NEW = 2, 4
DEEPSEEK_KERNELS = ("rmsnorm", "flash_attention", "retrieval_topk",
                    "retrieval_topk_merge")
MAMBA2_KERNELS = ("rmsnorm", "retrieval_topk", "retrieval_topk_merge")
# the streamed generators (no retrieval)
DEEPSEEK_STREAMED_KERNELS = ("rmsnorm", "flash_attention")
MAMBA2_STREAMED_KERNELS = ("rmsnorm",)
# G = 8 (64/8 heads x 128): llama3-70b, the paper's 70B model, on the
# paged path at depth 4 (11.05 GB of bf16 weights), and jamba-1.5-large's
# hybrid on the dense paths at depth 4 (45.95 GB: its four layer kinds,
# (mamba, dense), (mamba, moe), (mamba, dense), (attn, moe); one 8-layer
# block is 90.26 GB, more than the card).  Card fp32 against CPU fp32:
# llama3-70b at one layer, as the other attention families (its second
# layer took about 10 of the check's 45 s: cut for time), jamba at depth 4
# with its experts cut to 2 (top 2; every width full: 16 experts in fp32
# are 92 GB).  jamba streams its 4 layers through a ring of 2 slots of its
# largest layer (max_depth 1)
LLAMA70B_DEPTH, JAMBA_DEPTH = 4, 4
LONG_DECODE = 32_000        # one row's kv_len: the dense kernel's splits
# the fp32 witness casts a MoE layer an expert at a time where its experts
# in fp32 pass this (jamba: 40.3 GB a layer; deepseek's 2.2 GB cast whole)
EXPERT_STACKS = ("w_gate", "w_up", "w_down")
EXPERTWISE_BYTES = 4 << 30
JAMBA_MODEL_EXPERTS = 2
JAMBA_STREAMED_KERNELS = ("rmsnorm", "flash_attention", "decode_attention")
# the embed frontend: seamless-m4t-medium's encoder-decoder (16/16 heads x
# 64: G = 1; 12 + 12 layers) and chameleon-34b's embedding inputs (64/8 x
# 128, 48 layers, 67.5 GB of bf16 weights: the most the card holds).
# serve-seamless: 8 requests of 1024 seeded encoder frames, a 16-token
# decoder prompt and 32 greedy tokens; the kernel rows hold the cross
# attention at the served 16 rows and at the decoder's 1024 x 0.125 rows
# against 1024 frames, the causal self-prefill at 16, and the self decode
# at 17-160 tokens.  serve-chameleon: 8 prompts of 1024
# embeddings and 16 decode steps over seeded stub embeddings, every step
# held to fp32 on 2 rows; streamed at 8 layers (cut for host memory and
# time), 2 rows x 4 steps.  The model checks take seamless at 2 + 2 layers
# and chameleon at 2, card fp32 against CPU fp32
SEAMLESS, CHAMELEON = "seamless-m4t-medium", "chameleon-34b"
ENC_FRAMES, SEAMLESS_PROMPT, SEAMLESS_NEW = 1024, 16, 32
SEAMLESS_CROSS_Q = 128
SEAMLESS_SELF_LENS = (17, 37, 57, 77, 97, 117, 137, 160)
CHAMELEON_STEPS, CHAMELEON_WITNESS = 16, (0, 5)
CHAMELEON_STREAMED_DEPTH, CHAMELEON_STREAMED_STEPS = 8, 4
ENCDEC_MODEL_LAYERS = 2
EMBED_KERNELS = ("rmsnorm", "flash_attention", "decode_attention")
# the recluster check's store, apart from the shared one
RECLUSTER_N, RECLUSTER_PARTS, RECLUSTER_SPILLED, RECLUSTER_HOT = (
    100_000, 16, 4, 2)


T_START = time.perf_counter()


def log(msg: str) -> None:
    """A line of the run's log, after the seconds since the script began."""
    print(f"{time.perf_counter() - T_START:7.1f} {msg}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---------------------------------------------------------------- timing
def _kernel_records(prof, torch):
    """(name, start us, duration us) of every device record of a trace,
    read from the profiler's raw records: its event tree, which
    ``prof.events()`` builds on first use, took 8-21 s for a profiled
    serving batch."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns() / 1e3, e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


class Timer:
    """Device time of one call: the profiler's (CUPTI) records of the
    kernels the call launched, summed, averaged over ``iters`` calls; a
    trace short of any kernel's records is taken again, and after three
    short traces the call is timed by CUDA events (logged), once it is
    seen to launch device work at all.  ``split`` holds the last call's
    ms by kernel (None when events timed it).
    ``cold`` overwrites the 50 MB L2 (a 256 MiB device-to-device copy,
    left out of the sum) before each call, for inputs the main path finds
    cold: the KV pages of a layer and a freshly copied partition."""

    def __init__(self, torch, iters: int = 20):
        self.torch = torch
        self.iters = iters
        self.split = None
        self.src = torch.empty(2 ** 28, dtype=torch.uint8, device="cuda")
        self.dst = torch.empty_like(self.src)
        # start the profiler's tracing before any kernel library loads its
        # module: a kernel first launched before the first session went
        # unrecorded on the card
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            self.dst.copy_(self.src)
            torch.cuda.synchronize()

    def __call__(self, fn, cold: bool = False, iters: int = 0) -> float:
        """``iters`` calls a trace, the timer's own number when 0."""
        torch = self.torch
        iters = iters or self.iters
        from torch.profiler import ProfilerActivity, profile

        def device_records(calls):
            # a trace can lose its first device record (after the train
            # phases every trace did, PERF.md §6): an empty spin kernel
            # launched first takes that place, and is left out where it
            # survives
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda._sleep(0)
                for _ in range(calls):
                    if cold:
                        self.dst.copy_(self.src)
                    fn()
                torch.cuda.synchronize()
            recs = sorted(_kernel_records(prof, torch), key=lambda r: r[1])
            if recs and "spin_kernel" in recs[0][0]:
                recs.pop(0)
            return [r for r in recs
                    if not (cold and r[0].startswith("Memcpy DtoD"))]

        fn()
        torch.cuda.synchronize()
        self.split = None
        # a trace that lost records would read as a faster kernel: take
        # only a trace that holds every launch of every call, kernel by
        # kernel (a one-call trace can lose a record too: each kernel seen
        # in either trace must appear at least once a call; a one-call
        # trace that lost them all is taken again)
        one = collections.Counter()
        for _ in range(3):
            one = collections.Counter(r[0] for r in device_records(1))
            if one:
                break
        else:
            # the call must be seen to launch device work: a kernel's
            # launch count, or a trace of 64 calls (a trace loses about 10
            # records at its ends, PERF.md §7)
            if not (self._counts_launch(fn) or any(
                    device_records(max(iters, 64)) for _ in range(3))):
                fail("the profiler recorded no device work of a call in "
                     "three one-call and three 64-call traces, and it "
                     "launched no kernel of the port")
            log("[timer] the profiler kept no device record of one call in "
                "three traces: this call is timed by CUDA events instead")
            return self._events_ms(fn, cold, iters)
        for _ in range(3):
            recs = device_records(iters)
            seen = collections.Counter(r[0] for r in recs)
            short = {n: (seen[n], iters * max(one[n], 1))
                     for n in one.keys() | seen.keys()
                     if seen[n] < iters * max(one[n], 1)}
            if not short:
                break
        else:
            log(f"[timer] three traces of {iters} calls kept too few records "
                f"of {len(short)} kernel(s) (kept, wanted: "
                f"{ {n[:60]: c for n, c in short.items()} }): this call is "
                "timed by CUDA events instead")
            return self._events_ms(fn, cold, iters)
        us = sum(d for _, _, d in recs)
        if us <= 0:
            fail("the profiler recorded no device time")
        split = collections.Counter()
        for kname, _, d in recs:
            split[kname] += d / iters / 1e3
        self.split = dict(split)
        return us / iters / 1e3

    def _counts_launch(self, fn) -> bool:
        """Whether a call of ``fn`` adds to a kernel's launch count."""
        from repro_torch.kernels import ops
        before = sum(ops.launch_counts().values())
        fn()
        self.torch.cuda.synchronize()
        return sum(ops.launch_counts().values()) > before

    def _events_ms(self, fn, cold: bool, iters: int) -> float:
        """Device ms a call by CUDA events: around the ``iters`` calls
        back to back, or around each call after its L2 flush when
        ``cold``.  The gaps between kernels count too, so this never
        reads below the profiler's sum."""
        torch = self.torch
        if not cold:
            return _events_ms(torch, fn, iters)
        ms = 0.0
        for _ in range(iters):
            self.dst.copy_(self.src)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ms += start.elapsed_time(end)
        return ms / iters


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


def sdpa_ms(torch, timer, q, k, v, *, causal=True, q_offset=None,
            kv_len=None, window=None):
    """SDPA's device ms on the flash kernel's inputs ((B, S, heads, D),
    GQA): a one-shot call as ``is_causal``, else each row's reach (causal
    from ``q_offset``, an int or (B,), below ``kv_len`` (B,), inside
    ``window``) as a boolean mask; no softcap."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if q_offset is None and kv_len is None and window is None:
        return timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))
    b, sq, sk = q.shape[0], q.shape[1], k.shape[1]
    off = (q_offset if torch.is_tensor(q_offset) else torch.full(
        (b,), q_offset or 0, dtype=torch.int32, device="cuda"))
    q_pos = off[:, None] + torch.arange(sq, device="cuda")      # (B, Sq)
    k_pos = torch.arange(sk, device="cuda")[None, None, :]
    live = torch.ones((b, sq, sk), dtype=torch.bool, device="cuda")
    if causal:
        live &= k_pos <= q_pos[:, :, None]
    if kv_len is not None:
        live &= k_pos < kv_len[:, None, None]
    if window:
        live &= k_pos > q_pos[:, :, None] - window
    mask = live[:, None]
    return timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))


def _by_kernel(split):
    """``Timer.split`` keyed by the kernels' short names, ms rounded."""
    return {(m.group(0) if (m := re.search(r"\w+_kernel", n)) else n[:40]):
            round(t, 4) for n, t in (split or {}).items()}


def fp32_flash_extra(tag, case, split, ms, nbytes, nops, smi=""):
    """The fp32 flash kernel beside its second bound, the CUDA cores'
    (its first is 3xTF32's, ``PEAK_FP32_ATTN``), and the timed call's
    device ms by kernel (the split blocks, then their merge): logged, and
    returned for the ``kernels`` line."""
    cc_ms, cc_by = bound_ms(nbytes, nops, PEAK_FP32)
    by_kernel = _by_kernel(split)
    log(f"{tag} flash_attention_fp32 {case}: CUDA-core bound {cc_ms:.5f} ms "
        f"({cc_by}) -> {cc_ms / ms:.1%} of it; device ms by kernel "
        f"{json.dumps(by_kernel) if split else 'not recorded (events)'}"
        + (f" ({smi})" if smi else ""))
    return dict(bound_cuda_cores_ms=cc_ms, ms_by_kernel=by_kernel)


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
REDESIGNED = ("flash_wgmma_kernel<128,", "flash_wgmma_kernel<192,",
              "flash_tf32_kernel<16, 128>", "flash_tf32_kernel<32, 256>",
              "rmsnorm_bwd_kernel<__nv_bfloat16, __nv_bfloat16, 8, 2, false>",
              "rmsnorm_bwd_kernel<float, float, 8, 2, false>",
              "dkdv_wgmma_kernel<", "dq_wgmma_kernel<",
              "dkdv_tf32_kernel<", "dq_tf32_kernel<",
              "merge_kernel",
              "decode_kernel<__nv_bfloat16, __nv_bfloat16, 4, 4>",
              "decode_kernel<__nv_bfloat16, __nv_bfloat16, 8, 4>",
              "decode_kernel<float, float, 8, 4>",
              "decode_kernel<__nv_bfloat16, __nv_bfloat16, 1, 2>",
              "decode_kernel<float, float, 1, 2>",
              "decode_combine_kernel<__nv_bfloat16>",
              "topk_stream_kernel",
              "rmsnorm_kernel<__nv_bfloat16, __nv_bfloat16, true, 8, 2>",
              "rmsnorm_kernel<__nv_bfloat16, __nv_bfloat16, false, 8, 2>",
              "rmsnorm_kernel<float, float, false, 4, 4>")


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


def phase_build(torch, built=None):
    """The kernels' libraries (``built``: a build already started, whose
    result this waits for), their registers, spills and launch shapes."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.decode_attention import DENSE_GRANULE
    libs = built.result() if built is not None else _build.build()
    t_nvcc = max(_build.SECONDS.values(), default=0.0)
    for name, path in libs.items():
        if name == "rmsnorm":           # one line per variant: see below
            continue
        for line in (path.parent / f"{name}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] nvcc {t_nvcc:.1f} s from its start for {sorted(libs)} "
        f"in {path.parent.relative_to(ROOT)}; each process's seconds "
        f"{json.dumps(_build.SECONDS)}")
    # the redesigned kernels: registers and spills, and their launch shapes
    # at the main paths' sizes
    for name in ("flash_attention", "flash_attention_bwd", "paged_attention",
                 "decode_attention", "topk_retrieval", "rmsnorm"):
        text = (libs[name].parent / f"{name}.log").read_text()
        for kern, regs, spill in ptxas_entries(text):
            if any(k in kern for k in REDESIGNED):
                log(f"[build] {kern[:150]}: {regs}; {spill}")
        # ptxas serialises every wgmma of a kernel (warning C7513) when a
        # register an in-flight one reads is written
        if name.startswith("flash_attention") and "C7513" in text:
            fail(f"ptxas serialised the wgmma instructions of {name} "
                 f"(C7513): {[l for l in text.splitlines() if 'C7513' in l]}")
    for case, b, sq, h, d, dv in (
            ("one-shot", SLOTS, CTX, HEADS, HEAD_DIM, HEAD_DIM),
            ("chunk", 1, CHUNK, HEADS, HEAD_DIM, HEAD_DIM),
            ("deepseek one-shot, 16 heads, q/k 192, v 128", SLOTS, CTX, 16,
             192, 128),
            ("seamless encoder, 16 heads x 64", SLOTS, ENC_FRAMES, 16, 64, 64),
            ("seamless cross and self-prefill, served prompt", SLOTS,
             SEAMLESS_PROMPT, 16, 64, 64),
            ("seamless cross, 16 heads x 64", SLOTS, SEAMLESS_CROSS_Q, 16, 64,
             64)):
        shp = fa.launch_shape(b, sq, h, d, dv)
        log(f"[build] flash_wgmma_kernel {case} ({b} x {sq}): "
            f"{shp['blocks']} persistent blocks x {shp['threads']} threads "
            f"over {shp['items']} q tiles of {shp['rows']} rows, "
            f"{shp['consumers']} consumer warpgroup(s) of 64 rows, "
            f"{shp['stages']} K/V stages, {shp['smem']} B shared")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # the fp32 kernel at the serving chunks it was cut for
    for case, h, sk, window, d in (
            ("serve-swap chunk, 32 heads x 128", HEADS, CTX, None, HEAD_DIM),
            ("gemma2 deep int8 chunk, 8 heads x 256, window 4096", 8,
             LONG_CTX, GEMMA2_WINDOW, 256)):
        shp = fa.fp32_shape(d, d)
        splits, split_len = fa.fp32_splits(1, CHUNK, h, sk, True, window,
                                           shp["rows"], shp["keys"],
                                           shp["per_sm"] * sms)
        log(f"[build] flash_tf32_kernel {case} (1 x {CHUNK} against {sk}): "
            f"{-(-CHUNK // shp['rows']) * h * splits} blocks x "
            f"{shp['threads']} threads ({shp['per_sm']} an SM, "
            f"{shp['smem']} B shared), {splits} splits of {split_len} keys "
            f"in {shp['keys']}-key tiles; merge pass "
            + (f"grid ({CHUNK}, {h}, 1)" if splits > 1 else "none"))
    warps, stages, unit = pa.launch_shape()
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


def _flash_bytes_ops(torch, q, k, kv_len, q_offset, window, dv=None,
                     causal=True):
    """Bytes of q, k, v and o, each moved once, and 2 * (D + DV) flops per
    unmasked (query, key) pair and head; ``dv`` defaults to D."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    dv = d if dv is None else dv
    offs = (q_offset.long().cpu() if torch.is_tensor(q_offset)
            else torch.full((b,), q_offset, dtype=torch.long))
    lens = (kv_len.long().cpu() if kv_len is not None
            else torch.full((b,), sk, dtype=torch.long))
    q_pos = offs[:, None] + torch.arange(sq)                   # (B, Sq)
    hi = (torch.minimum(lens[:, None], q_pos + 1) if causal
          else lens[:, None].expand(b, sq))
    lo = (q_pos - window + 1).clamp(min=0) if window else torch.zeros_like(hi)
    pairs = int((hi - lo).clamp(min=0).sum())
    nbytes = ((b * sq * h + b * sk * kvh) * (d + dv) * q.element_size()
              + 8 * b)
    return nbytes, 2 * pairs * h * (d + dv)


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
    # the cross-shard merge of serve-sharded: (8, S, 5) boards, S = 2 and
    # 4, rows of 10 and 20 entries (the unaligned rows' scalar loads),
    # under the all-true mask the sharded store passes and under a probe
    # mask; held to the plain version exactly, timed beside it and
    # beside where + topk + gather
    for parts in SHARD_COUNTS:
        s, ids, mask = merge_case(parts, TOP_K)
        full = torch.ones_like(mask)
        for what, m in (("probe mask", mask), ("all-true mask", full)):
            got = ops.retrieval_topk_merge(s, ids, m, TOP_K)
            want = ops.retrieval_topk_merge(s, ids, m, TOP_K, impl="ref")
            merge_exact(f"({SLOTS}, {parts}, {TOP_K}) {what}", got, want)

        def lib_cross():
            flat = torch.where(full[:, :, None], s, ops.NEG_INF).flatten(1)
            top = torch.topk(flat, TOP_K, dim=-1)
            return top.values, ids.flatten(1).gather(1, top.indices)

        nbytes = s.numel() * 8 + full.numel() + SLOTS * TOP_K * 8
        b_ms, b_by = bound_ms(nbytes, SLOTS * parts * TOP_K, PEAK_FP32)
        log(f"[kernel] retrieval_topk_merge ({SLOTS}, {parts}, {TOP_K}) "
            f"all-true mask (the cross-shard merge): exact; kernel_ms "
            f"{timer(lambda: ops.retrieval_topk_merge(s, ids, full, TOP_K)):.4f}"
            f" plain_ms "
            f"{timer(lambda: ops.retrieval_topk_merge(s, ids, full, TOP_K, impl='ref')):.4f}"
            f" library_ms {timer(lib_cross):.4f} (where + topk + gather) "
            f"bound_ms {b_ms:.7f} ({b_by})")
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
            lib_ms = sdpa_ms(torch, timer, q, k, v,
                             q_offset=kw.get("q_offset"),
                             kv_len=kw.get("kv_len"))
        nbytes, nops = _flash_bytes_ops(torch, q, k, kw.get("kv_len"),
                                        kw.get("q_offset", 0), window)
        fp32 = dt == torch.float32
        ms = timer(lambda: ops.flash_attention(q, k, v, **kw))
        split = timer.split
        r = report("flash_attention_fp32" if fp32 else "flash_attention",
                   case, err, ms,
                   timer(lambda: ops.flash_attention(q, k, v, impl="ref",
                                                     **kw)),
                   lib_ms, bound_ms(nbytes, nops,
                                    PEAK_FP32_ATTN if fp32 else PEAK_BF16))
        if fp32:
            r.update(fp32_flash_extra("[kernel]", case, split, ms, nbytes,
                                      nops))
        if case.startswith("one-shot bf16"):
            rows["flash_attention"] = r
        if case.startswith("chunk fp32 (1, 256) at 768"):
            rows["flash_attention_fp32"] = r
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


def _to_dev(t, dev="cuda"):
    if isinstance(t, dict):
        return {k: _to_dev(v, dev) for k, v in t.items()}
    if isinstance(t, list):
        return [_to_dev(v, dev) for v in t]
    return t.to(dev)


def _model_logits(torch, cfg, model, params, dev, prompts, *, ctx, chunk,
                  page, steps, dtype=None, force=None):
    """Logits of two rows of ``prompts`` on ``dev``: chunked prefill then
    ``steps`` paged decode steps, and one-shot prefill then ``steps - 1``
    dense decode steps; each step feeds the row's greedy token, or
    ``force`` (the paged, the dense tokens: (steps, 2) each).  Returns the
    (paged, dense) logits on the CPU and the tokens fed."""
    from repro_torch.models.model import init_cache
    dtype = dtype or torch.float32
    nmax = -(-(ctx + steps) // page)
    tab = torch.arange(1, 2 * nmax + 1, dtype=torch.int32).reshape(2, nmax)
    tab[1] = tab[1].flip(0)
    cache = init_cache(cfg, 2 * nmax + 1, page, dtype, dev)
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
    fed = {"paged": [], "dense": []}

    def next_tok(kind, logits, s):
        cur = (logits.argmax(-1).to(torch.int32) if force is None
               else force[kind][s].to(dev))
        fed[kind].append(cur.cpu())
        return cur

    cur = next_tok("paged", out[-1], 0)
    for s in range(steps):
        pos = torch.full((2,), ctx + s, dtype=torch.int32, device=dev)
        out.append(model.decode(params, cur[:, None], cache, pos, t,
                                kv_span=ctx + steps))
        if s + 1 < steps:
            cur = next_tok("paged", out[-1], s + 1)
    paged = torch.stack(out).float().cpu()
    del cache
    dense, fed["dense"] = _dense_logits(
        torch, cfg, model, params, dev, prompts, ctx=ctx, steps=steps,
        dtype=dtype, force=None if force is None else force["dense"])
    return paged, dense, {k: torch.stack(v) for k, v in fed.items()}


def _dense_logits(torch, cfg, model, params, dev, prompts, *, ctx, steps,
                  dtype=None, force=None):
    """Logits of one-shot prefill into a dense cache, then ``steps - 1``
    dense decode steps, each fed the rows' greedy tokens or ``force``
    ((steps - 1, 2) tokens).  Returns the logits on the CPU and the list
    of tokens fed."""
    from repro_torch.models.model import init_cache
    cache = init_cache(cfg, 2, ctx + steps, dtype or torch.float32, dev)
    out = [model.prefill(params, prompts.to(dev), cache)]
    fed = []

    def next_tok(logits, s):
        cur = (logits.argmax(-1).to(torch.int32) if force is None
               else force[s].to(dev))
        fed.append(cur.cpu())
        return cur

    cur = next_tok(out[-1], 0)
    for s in range(steps - 1):
        pos = torch.full((2,), ctx + s, dtype=torch.int32, device=dev)
        out.append(model.decode(params, cur[:, None], cache, pos))
        if s + 2 < steps:
            cur = next_tok(out[-1], s + 1)
    return torch.stack(out).float().cpu(), fed


def phase_model(torch):
    """A reduced llama: the kernels on the card against the plain versions
    on the CPU, same fp32 weights: chunked prefill then paged decode, and
    one-shot prefill then dense decode."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = get_config("llama3-8b").reduced(num_layers=2)
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    p_cpu = cpu.init(seed=3, dtype=torch.float32)
    p_gpu = _to_dev(p_cpu)
    ctx, chunk, page, steps = 40, 16, 8, 8
    g = torch.Generator().manual_seed(4)
    prompts = torch.randint(2, cfg.vocab_size, (2, ctx), generator=g,
                            dtype=torch.int32)
    paged, dense = {}, {}
    for dev, model, params in (("cpu", cpu, p_cpu), ("cuda", gpu, p_gpu)):
        paged[dev], dense[dev], _ = _model_logits(
            torch, cfg, model, params, dev, prompts, ctx=ctx, chunk=chunk,
            page=page, steps=steps)
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


# ------------------------------------------------------------ training
TRAIN_DEPTH = 4             # llama3-8b at full width, 4 of its 32 layers
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
TRAIN_STEPS, TRAIN_CKPT_STEP = 8, 4
# Adam's first steps move every weight by about lr: 1e-3 and 3e-4 with 2
# warmup steps took the loss to 24.3 and 23.0 at step 5 (PR 25)
TRAIN_LR = 1e-4
TRAIN_CHECK_SEQ = 256       # (a): card fp32 against CPU fp32, one layer
TRAIN_GRAD_TOL = 5e-4       # (a): per leaf, of its largest |gradient|
BWD_FP32_TOL, BWD_BF16_TOL = 1e-4, 2e-2   # of the largest |gradient|
TRAIN_KERNELS = ("rmsnorm", "flash_attention", "flash_attention_bwd",
                 "rmsnorm_bwd")
# (name, B, S, H, KV, D, DV, causal, window, softcap, dtypes): llama3-8b's
# training shapes first (the kernels line's row), then D = 64 (granite's
# and seamless's heads), bidirectional (seamless's encoder), a window
# and a softcap (gemma2's), a ragged S; then every head-dim pair the
# families train at, in both dtypes: D = 16 (the reduced configs),
# gemma2-2b's and gemma-7b's D = 256, deepseek's MLA (192, 128), and
# G = 8 (llama3-70b's and jamba's 64/8 heads)
BWD_CASES = (
    ("llama3-8b", 4, 2048, 32, 8, 128, 128, True, None, None,
     ("bf16", "fp32")),
    ("d64", 4, 2048, 16, 8, 64, 64, True, None, None, ("bf16",)),
    ("bidirectional", 4, 2048, 32, 8, 128, 128, False, None, None,
     ("bf16",)),
    ("window 4096 softcap 50", 1, 6144, 32, 8, 128, 128, True, 4096, 50.0,
     ("bf16",)),
    ("ragged S 2000", 4, 2000, 32, 8, 128, 128, True, None, None, ("bf16",)),
    ("d16 window 16 softcap 50", 8, 1024, 4, 2, 16, 16, True, 16, 50.0,
     ("bf16", "fp32")),
    ("gemma2-2b window 4096 softcap 50", 1, 6144, 8, 4, 256, 256, True, 4096,
     50.0, ("bf16", "fp32")),
    ("gemma-7b", 2, 4096, 16, 16, 256, 256, True, None, None,
     ("bf16", "fp32")),
    ("deepseek-v2-lite MLA", 2, 4096, 16, 16, 192, 128, True, None, None,
     ("bf16", "fp32")),
    ("g8", 1, 4096, 64, 8, 128, 128, True, None, None, ("bf16", "fp32")),
)
RMS_BWD_SHAPE = (8192, 4096)


def _bwd_ops(torch, b, sq, h, d, dv, causal, window):
    """The flash backward's operations: FlashAttention-2's 5 products of
    the forward's size (S, dP, dV, dK, dQ), 6 D + 4 DV flops per unmasked
    (query, key) pair and head, the least work the card could do; and the
    7 the kernel runs (S and dP in both of its kernels), 8 D + 6 DV."""
    q = torch.empty((b, sq, h, d), device="meta")
    k = torch.empty((b, sq, 1, d), device="meta")
    _, nops = _flash_bytes_ops(torch, q, k, None, 0, window, dv=dv,
                               causal=causal)
    pairs = nops // (2 * (d + dv))                  # pairs x heads
    return pairs * (6 * d + 4 * dv), pairs * (8 * d + 6 * dv)


def phase_train_kernels(torch, timer, smi):
    """The training kernels against their plain versions: the flash
    backward (``csrc/flash_attention_bwd.cu``) at ``BWD_CASES`` (two calls
    bit-equal); the RMSNorm backward (both forms) at (8192, 4096) in bf16
    and fp32; the flash forward with and without its log-sum-exp.  Each
    with kernel, plain, library (SDPA's or ``F.rms_norm``'s backward
    through autograd) and bound ms.  Returns the kernels line's rows."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_vjp
    from repro_torch.kernels import rmsnorm as rn
    sdpa = F.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(25)
    rows, shapes = {}, {"flash_attention_bwd": [],
                        "flash_attention_bwd_fp32": [], "rmsnorm_bwd": []}

    def report(name, case, err, ms, plain_ms, lib_ms, bound):
        b_ms, b_by = bound
        lib = "null" if lib_ms is None else f"{lib_ms:.4f}"
        log(f"[train-kernel] {name} {case}: max_abs_err {err:.3e} "
            f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib} "
            f"bound_ms {b_ms:.5f} ({b_by}) -> {b_ms / ms:.1%} of bound "
            f"({smi})")
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, library_ms=lib_ms)
        shapes[name].append(dict(case=case, **row))
        return row

    for name, b, sq, h, kvh, d, dv, causal, window, cap, dts in BWD_CASES:
        for dname in dts:
            dt = torch.bfloat16 if dname == "bf16" else torch.float32
            q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dt)
            k = torch.randn((b, sq, kvh, d), generator=gen,
                            device="cuda").to(dt)
            v = torch.randn((b, sq, kvh, dv), generator=gen,
                            device="cuda").to(dt)
            dout = torch.randn((b, sq, h, dv), generator=gen,
                               device="cuda").to(dt)
            kw = dict(causal=causal, window=window, softcap=cap)
            out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
            got = fa.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
            again = fa.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                fail(f"flash backward {name} {dname}: two calls on the same "
                     "inputs differ")
            del again
            f32 = [t.float() for t in (q, k, v, dout)]
            out_p, lse_p = flash_vjp.attention_fwd_lse(*f32[:3], **kw)
            want = flash_vjp.attention_bwd(*f32[:3], out_p, f32[3], lse_p,
                                           **kw)
            tol = BWD_FP32_TOL if dt == torch.float32 else BWD_BF16_TOL
            err = 0.0
            for gname, g, w in zip(("dq", "dk", "dv"), got, want):
                scale = float(w.abs().max())
                err = max(err, check_close(
                    f"flash backward {name} {dname} {gname}", g.float(), w,
                    atol=tol * scale))
            del got, want, out_p, f32
            # the plain version on the kernel's dtype, as the CPU path runs it
            plain = lambda: flash_vjp.attention_bwd(q, k, v, out, dout, lse,
                                                    **kw)
            lib_ms = None
            if window is None and cap is None:
                qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                              for x in (q, k, v))
                o_l = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
                g_l = dout.transpose(1, 2)
                lib_ms = timer(lambda: torch.autograd.grad(
                    o_l, (qt, kt, vt), g_l, retain_graph=True))
                del o_l, qt, kt, vt
            # fp32: 3xTF32's bound, the CUDA cores' beside it
            peak = PEAK_BF16 if dt == torch.bfloat16 else PEAK_FP32_ATTN
            # q, k, v, o, dO and lse read once; dq, dk, dv written once
            nbytes = (2 * (q.numel() + k.numel() + v.numel() + out.numel())
                      * q.element_size() + lse.numel() * 4)
            ops5, ops7 = _bwd_ops(torch, b, sq, h, d, dv, causal, window)
            ms = timer(lambda: fa.flash_attention_bwd_cuda(
                q, k, v, out, dout, lse, **kw))
            case = f"{name} ({b}, {sq}) {h}/{kvh} x {d}" + (
                f"/{dv}" if dv != d else "") + f" {dname}"
            split = _by_kernel(timer.split)
            kname = ("flash_attention_bwd" if dt == torch.bfloat16
                     else "flash_attention_bwd_fp32")
            # one call a trace: the plain version's thousands of small
            # kernels make a trace of three take seconds to stop
            r = report(kname, case, err, ms, timer(plain, iters=1),
                       lib_ms, bound_ms(nbytes, ops5, peak))
            r["bound_7_products_ms"] = bound_ms(nbytes, ops7, peak)[0]
            r["ms_by_kernel"] = split
            extra = ""
            if dt == torch.float32:
                r["bound_cuda_cores_ms"] = bound_ms(nbytes, ops5,
                                                    PEAK_FP32)[0]
                extra = (f"; CUDA-core bound {r['bound_cuda_cores_ms']:.4f} "
                         f"ms -> {r['bound_cuda_cores_ms'] / ms:.1%} of it")
            log(f"[train-kernel] {kname} {case}: two calls bit-equal; "
                f"{ops7 / ms / 1e9:.1f} TFLOP/s of the 7 products it runs"
                f"{extra}; device ms a call by kernel {json.dumps(split)}")
            if name == "llama3-8b":
                rows[kname] = r
            if name == "llama3-8b" and dname == "bf16":
                # the forward's cost of its log-sum-exp
                with_lse = timer(lambda: fa.flash_attention_cuda(
                    q, k, v, return_lse=True, **kw))
                without = timer(lambda: fa.flash_attention_cuda(q, k, v,
                                                                **kw))
                log(f"[train-kernel] flash_attention forward {name} ({b}, "
                    f"{sq}) bf16: {with_lse:.4f} ms with the lse output, "
                    f"{without:.4f} ms without ({smi})")
                rows["flash_lse_ms"] = dict(with_lse=with_lse,
                                            without=without)
            del q, k, v, dout, out, lse
            _free(torch)

    rows_n, d = RMS_BWD_SHAPE
    for fused in (False, True):
        for dt in (torch.bfloat16, torch.float32):
            dname = str(dt)[6:]
            s_, dy = (torch.randn((rows_n, d), generator=gen,
                                  device="cuda").to(dt) for _ in range(2))
            w = (1 + 0.1 * torch.randn((d,), generator=gen,
                                       device="cuda")).to(dt)
            ds = (torch.randn((rows_n, d), generator=gen,
                              device="cuda").to(dt) if fused else None)
            dx, dw = rn.rmsnorm_bwd_cuda(s_, dy, w, 1e-5, ds=ds)
            f32 = [None if t is None else t.float() for t in (s_, dy, w, ds)]
            if dt == torch.float32:
                want_dx, want_dw = rn.rmsnorm_bwd_plain(*f32[:3], 1e-5,
                                                        ds=f32[3])
                err = check_close("rmsnorm backward dx", dx, want_dx,
                                  atol=1e-5 * float(want_dx.abs().max()))
                check_close("rmsnorm backward dw", dw, want_dw,
                            atol=1e-5 * float(want_dw.abs().max()))
            else:
                want_dx, want_dw = rn.rmsnorm_bwd_cuda(*f32[:3], 1e-5,
                                                       ds=f32[3])
                ulp = torch.finfo(torch.bfloat16).eps * want_dx.abs().clamp(
                    min=torch.finfo(torch.bfloat16).tiny)
                err = check_close("rmsnorm backward dx (bf16 vs fp32 "
                                  "kernel)", dx.float(), want_dx, atol=ulp)
                check_close("rmsnorm backward dw", dw, want_dw,
                            atol=1e-3 * float(want_dw.abs().max()))
            xl = s_.detach().requires_grad_(True)
            wl = w.detach().requires_grad_(True)
            yl = F.rms_norm(xl, (d,), wl, 1e-5)
            # read s, dy (and ds) and w once, write dx and dw once
            nbytes = ((3 + fused) * s_.numel() * s_.element_size()
                      + 2 * w.numel() * w.element_size())
            form = "add_rmsnorm" if fused else "rmsnorm"
            ms = timer(lambda: rn.rmsnorm_bwd_cuda(s_, dy, w, 1e-5, ds=ds))
            split = _by_kernel(timer.split)
            again = rn.rmsnorm_bwd_cuda(s_, dy, w, 1e-5, ds=ds)
            if not (torch.equal(again[0], dx) and torch.equal(again[1], dw)):
                fail(f"rmsnorm backward {form} {dname}: two calls differ")
            case = f"{form} ({rows_n}, {d}) {dname}"
            log(f"[train-kernel] rmsnorm_bwd {case}: two calls bit-equal; "
                f"device ms a call by kernel {json.dumps(split)}")
            r = report("rmsnorm_bwd", case, err, ms,
                       timer(lambda: rn.rmsnorm_bwd_plain(s_, dy, w, 1e-5,
                                                          ds=ds)),
                       timer(lambda: torch.autograd.grad(
                           yl, (xl, wl), dy, retain_graph=True)),
                       bound_ms(nbytes, 8 * s_.numel(), PEAK_FP32))
            if fused and dt == torch.bfloat16:
                rows["rmsnorm_bwd"] = r
            del s_, dy, w, ds, dx, dw, want_dx, want_dw, xl, wl, yl
            _free(torch)
    rows["shapes"] = shapes
    return rows


def _grad_tree(torch, model, params, batch):
    from repro_torch.training.train_loop import value_and_grad
    loss, _, grads = value_and_grad(model, params, batch)
    return float(loss), grads


# the fp32 flash backward's kernels, by name (the fp32 training path must
# run them)
FP32_BWD_KERNELS = ("dkdv_tf32_kernel", "dq_tf32_kernel")


def _grads_card_vs_cpu(torch, cfg1, tag):
    """One fp32 config at batch 1 x ``TRAIN_CHECK_SEQ``: the card (kernels)
    against the CPU (plain versions), the loss and every gradient leaf
    within ``TRAIN_GRAD_TOL`` of the leaf's largest |gradient|; the card's
    pass is profiled and must run the fp32 flash forward and backward
    kernels.  Returns the card pass's launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import tree_leaves
    cpu = Model(cfg1, device="cpu", remat=True)
    gpu = Model(cfg1, device="cuda", remat=True)
    # drawn on the card (llama3-8b's layer: 1.27 B values), copied to the
    # host
    p_gpu = gpu.init(seed=5, dtype=torch.float32)
    p_cpu = _to_dev(p_gpu, "cpu")
    g = torch.Generator().manual_seed(6)
    toks = torch.randint(0, cfg1.vocab_size, (1, TRAIN_CHECK_SEQ + 1),
                         generator=g)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    t0 = time.perf_counter()
    loss_cpu, g_cpu = _grad_tree(torch, cpu, p_cpu, batch)
    t_cpu = time.perf_counter() - t0
    from torch.profiler import ProfilerActivity, profile
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loss_gpu, g_gpu = _grad_tree(torch, gpu, p_gpu,
                                     {k: v.cuda() for k, v in batch.items()})
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    # the fp32 training forward and backward run the fp32 flash kernels,
    # by name (the trace may lose its first and last records, never the
    # middle's)
    names = {n for n, _, _ in _kernel_records(prof, torch)}
    for kern in ("flash_tf32_kernel",) + FP32_BWD_KERNELS:
        if not any(kern in n for n in names):
            fail(f"{tag}: the fp32 training pass launched no {kern}")
    if counts["flash_attention_bwd_fp32"] == 0 or counts["flash_attention_bwd"]:
        fail(f"{tag}: the fp32 flash backward's launches {counts}")
    if abs(loss_gpu - loss_cpu) > 1e-4 * abs(loss_cpu):
        fail(f"{tag}: card loss {loss_gpu} vs CPU {loss_cpu}")
    worst = 0.0
    # compared on the card: the token table's gradient is 2-3 GB
    for i, (a, b) in enumerate(zip(tree_leaves(g_gpu), tree_leaves(g_cpu))):
        b = b.to(a.device)
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        if not err <= TRAIN_GRAD_TOL * max(scale, 1e-30):
            fail(f"{tag}: gradient leaf {i} {tuple(b.shape)} off by "
                 f"{err:.3e} of max {scale:.3e}")
        worst = max(worst, err / max(scale, 1e-30))
    log(f"{tag} {cfg1.name} {cfg1.num_layers} layer(s) full width, fp32, "
        f"batch 1 x {TRAIN_CHECK_SEQ}: card loss {loss_gpu:.6f} vs CPU "
        f"{loss_cpu:.6f}; {len(list(tree_leaves(g_cpu)))} gradient leaves, "
        f"worst {worst:.2e} of the leaf's largest |g| (tol "
        f"{TRAIN_GRAD_TOL}); CPU took {t_cpu:.1f} s; the attention ran "
        f"flash_tf32_kernel, {' and '.join(FP32_BWD_KERNELS)} (profiled), "
        f"the fp32 backward {counts['flash_attention_bwd_fp32']} time(s)")
    del cpu, p_cpu, g_cpu, gpu, p_gpu, g_gpu
    _free(torch)
    return counts


def phase_train(torch, smi):
    """llama3-8b at full width (4096 wide, 32/8 heads x 128, d_ff 14336,
    vocab 128256) through the port's training path, remat on:
    (a) one layer, batch 1 x 256, fp32: the card (kernels) against the CPU
    (plain versions), the loss and every gradient leaf;
    (b) 4 layers, bf16 weights, fp32 master state: 8 AdamW steps on
    ``SyntheticLM`` at batch 4 x 2048; the loss at step 8 must be below
    step 1's, and both backward kernels and the flash and RMSNorm forwards
    must launch during the steps; step ms, tokens/s, MFU, peak memory and
    one profiled step's device idle share;
    (c) a checkpoint of step 4 restored into a fresh state: step 5 again,
    its loss and parameters equal to the uninterrupted run's.
    Returns the launch counts of the 8 steps."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.training import (AdamWConfig, TrainState,
                                      load_checkpoint, make_train_step,
                                      save_checkpoint)
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import adamw_init, tree_leaves
    from torch.profiler import ProfilerActivity, profile
    full = get_config("llama3-8b")

    # (a) card against CPU, fp32, one layer
    _grads_card_vs_cpu(torch, dataclasses.replace(full, num_layers=1),
                       "[train] (a)")

    # (b) 8 AdamW steps at 4 layers, bf16 weights, fp32 master
    cfg = dataclasses.replace(full, num_layers=TRAIN_DEPTH)
    model = Model(cfg, device="cuda", remat=True)
    state = TrainState.create(model, seed=7, dtype=torch.bfloat16)
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    n_matmul = n_params - state.params["embed"].numel()
    state_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(
        (state.params, state.opt_state)))
    log(f"[train] (b) {cfg.name} at depth {TRAIN_DEPTH}: {n_params:,} "
        f"parameters ({n_matmul:,} outside the token table), params + "
        f"AdamW state {state_bytes / 1e9:.2f} GB on the card")
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=TRAIN_STEPS)
    step = make_train_step(model, opt)
    data = iter(SyntheticLM(cfg, DataConfig(batch=TRAIN_BATCH,
                                            seq_len=TRAIN_SEQ, seed=0)))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in next(data).items()}
               for _ in range(TRAIN_STEPS)]
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    p, o = state.params, state.opt_state
    del state
    losses, step_s = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        p, o, _, m = step(p, o, None, batches[i])
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        log(f"[train] step {i + 1}: loss {losses[-1]:.4f} grad_norm "
            f"{float(m['grad_norm']):.3f} lr {float(m['lr']):.2e} "
            f"{step_s[-1] * 1e3:.1f} ms")
        if i + 1 == TRAIN_CKPT_STEP:
            t1 = time.perf_counter()
            save_checkpoint(str(ckpt_dir), i + 1, {"p": p, "o": o})
            log(f"[train] checkpoint of step {i + 1} saved in "
                f"{time.perf_counter() - t1:.1f} s")
        if i + 1 == TRAIN_CKPT_STEP + 1:
            p5 = [t.clone() for t in tree_leaves(p)]
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if not losses[-1] < losses[0]:
        fail(f"train: the loss did not fall ({losses[0]:.4f} at step 1, "
             f"{losses[-1]:.4f} at step {TRAIN_STEPS})")
    missing = [k for k in TRAIN_KERNELS if counts[k] == 0]
    if missing:
        fail(f"train: {missing} launched no time in the steps ({counts})")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    pairs = TRAIN_BATCH * TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
    attn = 3 * 4 * cfg.resolved_head_dim * pairs * cfg.num_heads * TRAIN_DEPTH
    flops = 6 * n_matmul * tokens + attn
    log(f"[train] {TRAIN_STEPS} steps at batch {TRAIN_BATCH} x {TRAIN_SEQ}: "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; step {steady * 1e3:.1f} "
        f"ms (median of steps 2-{TRAIN_STEPS}), {tokens / steady:,.0f} "
        f"tokens/s, MFU {flops / steady / PEAK_BF16:.2%} of the dense bf16 "
        f"peak ({flops / 1e12:.1f} TFLOP a step: 6 N tokens over the "
        f"{n_matmul:,} parameters outside the token table plus the causal "
        f"attention products, no recompute), peak device memory "
        f"{peak / 2**30:.2f} GiB ({smi})")
    log(f"[train] launches in the {TRAIN_STEPS} steps: {json.dumps(counts)}")
    # one profiled step (its result dropped)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(p, o, None, batches[-1])
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    breakdown("train", _kernel_records(prof, torch), window_s, smi,
              what="one train step")
    del p, o, m, prof
    _free(torch)

    # (c) step 5 again from the checkpoint of step 4, in a fresh state
    fresh = model.init(seed=8, dtype=torch.bfloat16)
    template = {"p": fresh, "o": adamw_init(fresh)}
    t1 = time.perf_counter()
    tree, at = load_checkpoint(str(ckpt_dir), template)
    log(f"[train] checkpoint of step {at} restored in "
        f"{time.perf_counter() - t1:.1f} s")
    del template, fresh
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    p, o, _, m = step(tree["p"], tree["o"], None, batches[TRAIN_CKPT_STEP])
    del tree
    loss5 = float(m["loss"])
    if loss5 != losses[TRAIN_CKPT_STEP]:
        fail(f"train (c): step {TRAIN_CKPT_STEP + 1} from the checkpoint "
             f"gave loss {loss5!r}, the uninterrupted run "
             f"{losses[TRAIN_CKPT_STEP]!r}")
    if not all(torch.equal(a, b) for a, b in zip(tree_leaves(p), p5)):
        fail(f"train (c): parameters after step {TRAIN_CKPT_STEP + 1} from "
             "the checkpoint differ from the uninterrupted run's")
    log(f"[train] (c) step {TRAIN_CKPT_STEP + 1} from the checkpoint of "
        f"step {TRAIN_CKPT_STEP}: loss {loss5:.6f} and all {len(p5)} "
        "parameter leaves equal to the uninterrupted run's")
    del p, o, m, p5, batches, model
    _free(torch)
    return counts


# the mesh phase: llama3-8b at full width, 2 of its layers, on a (1, 1)
# mesh of a one-rank NCCL group against the unsharded model
MESH_DEPTH = 2
MESH_BATCH, MESH_SEQ, MESH_DECODE = 2, 1024, 8
MESH_KERNELS = ("rmsnorm", "flash_attention", "flash_attention_bwd",
                "decode_attention")
MESH_MOE_TOKENS = 64        # granite: 64 x 8 routed rows, 8x capacity exact
MESH_MOE_TOL = 1e-5


def phase_mesh(torch, smi):
    """The mesh paths on one card: a one-rank NCCL group on a free port and
    a (data=1, model=1) mesh, ``Model(ctx=...)`` against the unsharded
    ``Model`` from one seeded init (see the module docstring, 4b).
    Returns the launch counts of the mesh model's runs (the train step,
    prefill and decode), set to 0 before them and read after."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.sharding import from_mesh
    from repro_torch.sharding.specs import param_pspecs, shard_params
    from repro_torch.training import AdamWConfig, make_train_step
    from repro_torch.training.optimizer import adamw_init, tree_leaves
    tag = "mesh"
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        ctx = from_mesh(make_mesh((1, 1), ("data", "model")))
        cfg = dataclasses.replace(get_config("llama3-8b"),
                                  num_layers=MESH_DEPTH)
        base = Model(cfg, device="cuda", remat=True)
        mesh = Model(cfg, device="cuda", remat=True, ctx=ctx)
        params = base.init(seed=11, dtype=torch.bfloat16)
        p_mesh = mesh.shard(params)
        g = torch.Generator().manual_seed(12)
        toks = torch.randint(0, cfg.vocab_size, (MESH_BATCH, MESH_SEQ + 1),
                             generator=g).cuda()
        batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
        opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=8)

        def one_step(model, p):
            # a fresh AdamW state a step: adamw_update writes its state
            o = adamw_init(p)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            q, o, _, m = make_train_step(model, opt)(p, o, None, batch)
            torch.cuda.synchronize()
            return q, float(m["loss"]), time.perf_counter() - t0

        def greedy(model, p):
            cache = model.init_cache(MESH_BATCH, MESH_SEQ + MESH_DECODE,
                                     torch.bfloat16)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = [model.prefill(p, batch["inputs"], cache).argmax(-1)]
            for i in range(MESH_DECODE):
                pos = torch.full((MESH_BATCH,), MESH_SEQ + i,
                                 dtype=torch.int32, device="cuda")
                out.append(model.decode(p, out[-1][:, None], cache,
                                        pos).argmax(-1))
            torch.cuda.synchronize()
            return torch.stack(out, 1), time.perf_counter() - t0

        q0, loss0, s0 = one_step(base, params)
        want = [t.clone() for t in tree_leaves(q0)]
        del q0
        _free(torch)
        ops.reset_launch_counts()
        q1, loss1, s1 = one_step(mesh, p_mesh)
        tok1, d1 = greedy(mesh, p_mesh)
        counts = ops.launch_counts()
        got = list(tree_leaves(q1))
        if loss1 != loss0:
            fail(f"[{tag}] the (1, 1) mesh's loss {loss1!r} differs from "
                 f"the unsharded step's {loss0!r}")
        same = sum(torch.equal(a, b) for a, b in zip(got, want))
        if len(got) != len(want) or same != len(want):
            fail(f"[{tag}] {len(want) - same} of {len(want)} updated leaves "
                 "differ from the unsharded step's")
        del q1, got, want
        _free(torch)
        tok0, d0 = greedy(base, params)
        if not torch.equal(tok0, tok1):
            fail(f"[{tag}] greedy tokens differ: unsharded {tok0.tolist()} "
                 f"mesh {tok1.tolist()}")
        missing = [k for k in MESH_KERNELS if counts[k] == 0]
        if missing:
            fail(f"[{tag}] {missing} launched no time on the mesh "
                 f"({counts})")
        log(f"[{tag}] llama3-8b at depth {MESH_DEPTH}, full width, bf16, "
            f"one train step at {MESH_BATCH} x {MESH_SEQ} on a (1, 1) mesh "
            f"of a one-rank NCCL group: loss {loss1!r}, equal to the "
            f"unsharded step's, and all {same} updated leaves bit-equal "
            f"(step {s1 * 1e3:.1f} ms, unsharded {s0 * 1e3:.1f} ms, each "
            f"with its AdamW state's first touch); prefill + {MESH_DECODE} "
            f"dense decode steps: tokens equal ({d1 * 1e3:.1f} ms, "
            f"unsharded {d0 * 1e3:.1f} ms); launches on the mesh "
            f"{json.dumps(counts)} ({smi})")
        del params, p_mesh, base, mesh, batch
        _free(torch)

        # granite's MoE over the mesh, fp32, against the local MoE
        gcfg = get_config("granite-moe-1b-a400m")
        gen = torch.Generator(device="cuda").manual_seed(13)
        p = moe.init_moe(gen, gcfg, torch.float32, "cuda")
        p_loc = shard_params(p, param_pspecs({"moe": p}, ctx)["moe"], ctx)
        x = torch.randn((1, MESH_MOE_TOKENS, gcfg.d_model), generator=gen,
                        device="cuda")
        want, aux = moe.moe_forward(p, x, gcfg)
        tp, tp_aux = moe.moe_forward(p_loc, x, gcfg, ctx=ctx)
        ep8, ep8_aux = moe.moe_forward_ep(p_loc, x, gcfg, ctx,
                                          capacity_factor=8.0)
        ep, _ = moe.moe_forward_ep(p_loc, x, gcfg, ctx)
        ep_cpu, _ = moe.moe_forward_ep(_to_dev(p_loc, "cpu"), x.cpu(), gcfg,
                                       ctx)
        e_tp = check_close(f"[{tag}] moe_forward(ctx) vs local", tp, want,
                           atol=MESH_MOE_TOL)
        e_ep8 = check_close(f"[{tag}] moe_forward_ep cf 8 vs local", ep8,
                            want, atol=MESH_MOE_TOL)
        e_ep = check_close(f"[{tag}] moe_forward_ep cf 1.25, card vs CPU",
                           ep.cpu(), ep_cpu, atol=MESH_MOE_TOL)
        dropped = (ep_cpu - want.cpu()).abs().amax(-1) > MESH_MOE_TOL
        if not torch.equal((ep.cpu() - want.cpu()).abs().amax(-1)
                           > MESH_MOE_TOL, dropped):
            fail(f"[{tag}] moe_forward_ep dropped other rows on the card "
                 "than on the CPU")
        for name, a in (("tp", tp_aux), ("ep8", ep8_aux)):
            if abs(float(a) - float(aux)) > MESH_MOE_TOL:
                fail(f"[{tag}] {name} aux {float(a)} vs local {float(aux)}")
        log(f"[{tag}] granite-moe-1b-a400m at full width, fp32, "
            f"{MESH_MOE_TOKENS} tokens: moe_forward(ctx) off the local MoE "
            f"by {e_tp:.2e}, moe_forward_ep at capacity factor 8 by "
            f"{e_ep8:.2e}, at 1.25 off the CPU's by {e_ep:.2e} with "
            f"{int(dropped.sum())} rows dropped on both; aux equal to "
            f"{MESH_MOE_TOL}")
        del p, p_loc, x
        _free(torch)
    finally:
        dist.destroy_process_group()
    return counts


# (arch, layers, sequence): the families the flash backward's other head
# dims train, at full width: gemma2-2b one local and one global layer
# (D = 256; its window of 4096 masks at 6144, softcap 50), gemma-7b one
# layer (D = 256, G = 1), deepseek-v2-lite its dense prefix layer (MLA,
# q/k 192, v 128)
TRAIN_FAMILIES = (("gemma2-2b", 2, 6144), ("gemma-7b", 1, 4096),
                  ("deepseek-v2-lite-16b", 1, 2048))
TRAIN_FAMILY_STEPS = 3
LAUNCHER_STEPS = 20


def phase_train_families(torch, smi):
    """The families whose flash backward runs at D = 16, 256 or (192, 128),
    trained on the card at full width: for each of ``TRAIN_FAMILIES``,
    the fp32 config at batch 1 x 256 card against CPU (the loss and every
    gradient leaf; gemma2 at its two-layer pattern, a pattern repeat being
    the least depth it takes), then bf16 weights and fp32 AdamW state,
    ``TRAIN_FAMILY_STEPS`` steps at batch 1: every loss finite, the flash
    backward launched once per attention layer and step.  Then
    ``launch/train.py``'s default reduced llama (D = 16, fp32) for
    ``LAUNCHER_STEPS`` steps: the fp32 backward launched at least once a
    step, the loss down.  Returns the launch counts of the fp32 checks, of
    the steps and of the launcher's run."""
    import dataclasses
    import math
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launcher
    from repro_torch.models.model import Model
    from repro_torch.training import AdamWConfig, TrainState, make_train_step
    from repro_torch.training.data import DataConfig, SyntheticLM
    runs = []
    for arch, layers, seq in TRAIN_FAMILIES:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        runs.append(_grads_card_vs_cpu(torch, cfg, "[train-families] (a)"))
        model = Model(cfg, device="cuda", remat=True)
        state = TrainState.create(model, seed=7, dtype=torch.bfloat16)
        step = make_train_step(model, AdamWConfig(
            lr=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_FAMILY_STEPS))
        data = iter(SyntheticLM(cfg, DataConfig(batch=1, seq_len=seq,
                                                seed=0)))
        batches = [{k: torch.from_numpy(v).cuda()
                    for k, v in next(data).items()}
                   for _ in range(TRAIN_FAMILY_STEPS)]
        attn = sum(m in ("attn", "local", "mla") for m, _ in
                   cfg.layer_kinds())
        p, o = state.params, state.opt_state
        del state
        losses, step_ms = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        for b in batches:
            t0 = time.perf_counter()
            p, o, _, m = step(p, o, None, b)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = ops.launch_counts()
        if not all(math.isfinite(x) for x in losses):
            fail(f"train-families {arch}: a loss is not finite ({losses})")
        want = attn * TRAIN_FAMILY_STEPS
        if counts["flash_attention_bwd"] != want:
            fail(f"train-families {arch}: the flash backward launched "
                 f"{counts['flash_attention_bwd']} times in "
                 f"{TRAIN_FAMILY_STEPS} steps of {attn} attention "
                 f"layer(s), not {want}")
        log(f"[train-families] {arch} at {layers} layer(s), full width, bf16 "
            f"weights + fp32 AdamW, batch 1 x {seq}: losses "
            f"{', '.join(f'{x:.4f}' for x in losses)}; step ms "
            f"{', '.join(f'{x:.1f}' for x in step_ms)}; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
            f"{json.dumps(counts)} ({smi})")
        runs.append(counts)
        del p, o, m, model, step, batches
        _free(torch)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    losses = launcher.main(["--steps", str(LAUNCHER_STEPS), "--log-every",
                            "5"])
    counts = ops.launch_counts()
    if counts["flash_attention_bwd_fp32"] < LAUNCHER_STEPS:
        fail(f"train-families launcher: the fp32 flash backward launched "
             f"fewer times than the {LAUNCHER_STEPS} steps ({counts})")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        fail(f"train-families launcher: the loss did not fall ({losses})")
    log(f"[train-families] launch/train.py, reduced llama3-8b (head dim 16, "
        f"fp32), {LAUNCHER_STEPS} steps in {time.perf_counter() - t0:.1f} s: "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches "
        f"{json.dumps(counts)}")
    runs.append(counts)
    _free(torch)
    return runs


# ------------------------------------------------- the attention families
def _cast_params(torch, tree, dtype):
    """A parameter tree in ``dtype`` but the MoE routers, which stay fp32
    as the reference keeps them."""
    from repro_torch.convert import FP32_LEAVES
    if isinstance(tree, dict):
        return {k: (v if k in FP32_LEAVES else _cast_params(torch, v, dtype))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_params(torch, v, dtype) for v in tree]
    return tree.to(dtype)


def _family_init(torch, cfg, seed, dtype, device):
    """Seeded random weights; chatglm3's QKV biases drawn too (the
    reference initialises them to zero, which would exercise nothing)."""
    from repro_torch.models.model import Model
    params = Model(cfg, device=device).init(seed=seed, dtype=dtype)
    if cfg.qkv_bias:
        g = torch.Generator(device=device).manual_seed(seed + 1)
        for lp in params["blocks"]:
            for name in ("bq", "bk", "bv"):
                b = lp["attn"][name]
                b.copy_(0.5 * torch.randn(b.shape, generator=g, device=device,
                                          dtype=torch.float32))
    return params


def _free(torch):
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _moe_product_errors(torch, cfg, tokens, gen):
    """The exact MoE path's three products at ``cfg``'s expert shapes for
    ``tokens`` tokens (the upper half of the experts get no row): each on
    bf16 operands through ``moe._mm_f32`` and on their fp32 copies.
    Returns {product: (error of the fp32 result, error of the same product
    rounded to bf16)}, each over the largest |product|, and the error of
    the whole ``_grouped_ffn`` against the down product of fp32 copies of
    the hidden rows these products give, over its largest |y|.  (Against
    a run on fp32 copies throughout, the hidden rows, rounded to bf16,
    would differ by an ulp wherever a product's last bits tip them.)"""
    from repro_torch.models import moe
    m, d = cfg.moe, cfg.d_model
    e, f, tk = m.num_experts, m.d_ff_expert, tokens * m.top_k

    def w(*shape):
        return (torch.randn(shape, generator=gen, device="cuda")
                * shape[-2] ** -0.5).to(torch.bfloat16)

    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max())

    p = {"w_gate": w(e, d, f), "w_up": w(e, d, f), "w_down": w(e, f, d)}
    xs = torch.randn((tk, d), generator=gen, device="cuda").to(torch.bfloat16)
    gs = torch.bincount(torch.randint(0, e // 2, (tk,), generator=gen,
                                      device="cuda"), minlength=e)
    expert, at = moe._group_index(gs, tk)
    buf = xs.new_zeros((e, tk, d))
    buf[expert, at] = xs
    errs = {}

    def product(name, a, b):
        got = moe._mm_f32(a, b)
        want = torch.bmm(a.float(), b.float())
        errs[name] = (rel(got, want), rel(torch.bmm(a, b).float(), want))
        return got

    g = product("gate", buf, p["w_gate"])
    u = product("up", buf, p["w_up"])
    h = (moe._act(g, cfg.mlp_kind) * u).to(torch.bfloat16)
    product("down", h, p["w_down"])
    y = moe._grouped_ffn(p, xs, gs, cfg.mlp_kind)
    want = torch.bmm(h.float(), p["w_down"].float())[expert, at]
    return errs, rel(y, want)


def phase_family_kernels(torch, timer, smi):
    """The attention kernels at the shapes of gemma2-2b (8/4 heads x 256,
    window 4096, softcap 50), gemma-7b (16/16 x 256), chatglm3-6b (32/2 x
    128), granite-moe-1b-a400m (16/8 x 64) and llama3-70b and jamba (64/8
    x 128: G = 8; paged over bf16, int8 and fp32 pages, dense in bf16 and
    fp32 and one 32000-token row), seamless-m4t-medium (16/16 x 64: G = 1;
    the flash kernel never causal, Sq != Sk for its cross attention; the
    dense decode at its cross and self lengths), and RMSNorm at their
    widths, each against its plain version.  gemma2's cases sit where
    its window masks: paged and dense decode at kv_len 4100-6200, a prefill
    chunk at q_offset 5888.  Returns {kernel: [case rows]} for the
    ``kernels`` line."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    sdpa = F.scaled_dot_product_attention
    shapes = {k: [] for k in ("paged_decode_attention", "decode_attention",
                              "flash_attention", "flash_attention_fp32",
                              "rmsnorm")}
    dims = {a: (c.num_heads, c.num_kv_heads, c.resolved_head_dim, c.d_model)
            for a, c in ((a, get_config(a))
                         for a in FAMILY_ARCHS + (LLAMA70B, JAMBA,
                                                  SEAMLESS))}

    def randn(shape, dt):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    def report(kname, case, err, ms, plain_ms, lib_ms, bound, lib_note=""):
        b_ms, b_by = bound
        lib = "null" if lib_ms is None else f"{lib_ms:.4f}{lib_note}"
        log(f"[family-kernel] {kname} {case}: max_abs_err {err:.3e} "
            f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib} "
            f"bound_ms {b_ms:.5f} ({b_by}) -> {b_ms / ms:.1%} of bound "
            f"({smi})")
        shapes[kname].append(dict(case=case, max_abs_err=err, ms=ms,
                                  plain_ms=plain_ms, library_ms=lib_ms,
                                  bound_ms=b_ms, bound_by=b_by))
        return shapes[kname][-1]

    def flash_report(case, err, dt, kernel, plain, lib_ms, nbytes, nops,
                     note=""):
        """A flash case's row: the bf16 kernel's against the bf16 peak,
        the fp32 kernel's against 3xTF32's, with the CUDA cores' bound and
        the device ms by kernel beside it."""
        fp32 = dt == torch.float32
        ms = timer(kernel)
        split = timer.split
        row = report("flash_attention_fp32" if fp32 else "flash_attention",
                     case, err, ms, timer(plain), lib_ms,
                     bound_ms(nbytes, nops,
                              PEAK_FP32_ATTN if fp32 else PEAK_BF16), note)
        if fp32:
            row.update(fp32_flash_extra("[family-kernel]", case, split, ms,
                                        nbytes, nops, smi))

    def check(name, got, want, attn_wmean=None):
        if got.dtype == torch.float32:
            return check_close(name, got, want, atol=FP32_ATTN_TOL)
        if attn_wmean is not None:
            return check_attention(name, got, want, attn_wmean)
        return check_close(name, got, want, atol=BF16_ATOL, rtol=BF16_RTOL)

    ctx_lens = tuple(range(CTX + 1, CTX + 1 + 4 * SLOTS, 4))      # 1025..
    long_lens = (4100, 4400, 4700, 5000, 5300, 5600, 5900, 6200)
    win = dict(window=GEMMA2_WINDOW, softcap=GEMMA2_SOFTCAP)
    none = dict(window=None, softcap=None)

    # ---- paged decode: 8 slots, pages of 16
    for case, arch, kvdt, lens, kw in (
            ("gemma2 bf16 pages", "gemma2-2b", torch.bfloat16, long_lens,
             win),
            ("gemma2 int8 pages + scales", "gemma2-2b", torch.int8,
             long_lens, win),
            ("gemma-7b bf16 pages", "gemma-7b", torch.bfloat16, ctx_lens,
             none),
            ("chatglm3 bf16 pages", "chatglm3-6b", torch.bfloat16, ctx_lens,
             none),
            ("granite bf16 pages", "granite-moe-1b-a400m", torch.bfloat16,
             ctx_lens, none),
            ("llama3-70b bf16 pages", LLAMA70B, torch.bfloat16, ctx_lens,
             none),
            ("llama3-70b int8 pages + scales", LLAMA70B, torch.int8,
             ctx_lens, none),
            ("llama3-70b fp32 pages", LLAMA70B, torch.float32, ctx_lens,
             none),
            ("seamless bf16 pages", SEAMLESS, torch.bfloat16, ctx_lens,
             none)):
        h, kvh, d, _ = dims[arch]
        nmax = -(-max(lens) // PAGE)
        pages = SLOTS * nmax + 1
        shape = (pages, PAGE, kvh, d)
        if kvdt == torch.int8:
            k, v = (torch.randint(-127, 128, shape, generator=gen,
                                  device="cuda", dtype=torch.int8)
                    for _ in range(2))
            ks, vs = (torch.rand((pages, kvh), generator=gen, device="cuda")
                      * 0.015 + 0.005 for _ in range(2))
        else:
            k, v = randn(shape, kvdt), randn(shape, kvdt)
            ks = vs = None
        q = randn((SLOTS, h, d), torch.float32 if kvdt == torch.float32
                  else torch.bfloat16)
        perm = torch.randperm(pages - 1, generator=gen, device="cuda") + 1
        tab = perm[:SLOTS * nmax].reshape(SLOTS, nmax).to(torch.int32)
        kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        kwk = dict(kw, k_scale=ks, v_scale=vs)
        got = ops.paged_decode_attention(q, k, v, tab, kv_len, **kwk)
        want = ops.paged_decode_attention(q, k, v, tab, kv_len, impl="ref",
                                          **kwk)
        err = check(f"paged {case}", got, want)
        lib_ms, note = None, ""
        if ks is None:
            kd = ref.gather_paged_kv(k, tab).transpose(1, 2)
            vd = ref.gather_paged_kv(v, tab).transpose(1, 2)
            pos = torch.arange(kd.shape[2], device="cuda")
            live = pos[None, :] < kv_len[:, None]
            if kw["window"]:
                live &= pos[None, :] >= kv_len[:, None] - kw["window"]
                note = " (SDPA, window mask, no softcap)"
            mask = live[:, None, None]
            lib_ms = timer(lambda: sdpa(q[:, :, None], kd, vd, attn_mask=mask,
                                        enable_gqa=True), cold=True)
            del kd, vd
        nbytes, nops = _paged_bytes_ops(torch, q, k, tab, kv_len,
                                        kw["window"], (ks, vs))
        report("paged_decode_attention", f"{case}: {SLOTS} slots x {h}/{kvh} "
               f"heads x {d}, kv_len {lens[0]}-{lens[-1]}"
               + (f", window {kw['window']} softcap {kw['softcap']:g}"
                  if kw["window"] else ""), err,
               timer(lambda: ops.paged_decode_attention(
                   q, k, v, tab, kv_len, **kwk), cold=True),
               timer(lambda: ops.paged_decode_attention(
                   q, k, v, tab, kv_len, impl="ref", **kwk), cold=True),
               lib_ms, bound_ms(nbytes, nops, PEAK_FP32), note)
        del q, k, v, got, want

    # ---- dense decode: 8 rows against a dense cache (jamba's attention
    # layer: 64/8 x 128 in bf16 and fp32, and one long row in many splits)
    bf16 = torch.bfloat16

    def dense_case(case, arch, lens, kw, dt, s_len=None):
        h, kvh, d, _ = dims[arch]
        rows = len(lens)
        if s_len is None:
            s_len = (max(lens) + 200 if kw["window"] else
                     max(CTX + MAX_NEW, max(lens)))
        q = randn((rows, h, d), dt)
        k = randn((rows, s_len, kvh, d), dt)
        v = randn((rows, s_len, kvh, d), dt)
        kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        got = ops.decode_attention(q, k, v, kv_len, **kw)
        want = ops.decode_attention(q, k, v, kv_len, impl="ref", **kw)
        wmean = ops.decode_attention(q.float(), k.float(), v.float().abs(),
                                     kv_len, impl="ref", **kw)
        err = check(f"decode {case}", got, want, wmean)
        pos = torch.arange(s_len, device="cuda")
        live = pos[None, :] < kv_len[:, None]
        note = ""
        if kw["window"]:
            live &= pos[None, :] >= kv_len[:, None] - kw["window"]
            note = " (SDPA, window mask, no softcap)"
        kt, vt, mask = k.transpose(1, 2), v.transpose(1, 2), live[:, None, None]
        lib_ms = timer(lambda: sdpa(q[:, :, None], kt, vt, attn_mask=mask,
                                    enable_gqa=True), cold=True)
        nbytes, nops = _decode_bytes_ops(torch, q, k, kv_len, kw["window"])
        report("decode_attention", f"{case}: ({rows}, {h}, {d}) against "
               f"({rows}, {s_len}, {kvh}, {d}), kv_len {lens[0]}-{lens[-1]}"
               + (f", window {kw['window']} softcap {kw['softcap']:g}"
                  if kw["window"] else ""), err,
               timer(lambda: ops.decode_attention(q, k, v, kv_len, **kw),
                     cold=True),
               timer(lambda: ops.decode_attention(q, k, v, kv_len,
                                                  impl="ref", **kw),
                     cold=True),
               lib_ms, bound_ms(nbytes, nops, PEAK_FP32), note)
        del q, k, v, got, want, wmean

    for args in (
            ("gemma2 bf16", "gemma2-2b", long_lens, win, bf16),
            ("gemma-7b bf16", "gemma-7b", ctx_lens, none, bf16),
            ("chatglm3 bf16", "chatglm3-6b", ctx_lens, none, bf16),
            ("granite bf16", "granite-moe-1b-a400m", ctx_lens, none, bf16),
            ("jamba bf16", JAMBA, ctx_lens, none, bf16),
            ("jamba fp32", JAMBA, ctx_lens, none, torch.float32),
            ("jamba bf16, one long row", JAMBA, (LONG_DECODE,), none, bf16)):
        dense_case(*args)
    # seamless-m4t-medium (16/16 x 64, G = 1): the cross decode over the
    # encoder's frames (and a ragged 1000), the decoder's self decode at
    # its short lengths
    for dt, name in ((bf16, "bf16"), (torch.float32, "fp32")):
        for what, lens in (("cross", (ENC_FRAMES,) * SLOTS),
                           ("cross ragged", (1000,) * SLOTS),
                           ("self", SEAMLESS_SELF_LENS)):
            dense_case(f"seamless {what} {name}", SEAMLESS, lens, none, dt,
                       max(lens))

    # ---- flash: one-shot (8, 1024) and gemma2's chunk deep in a long
    # prompt (q_offset 5888 of 6144: the window masks its first keys); the
    # fp32 chunk is the int8 pages' chunked prefill
    long_off = LONG_CTX - CHUNK

    def flash_case(case, arch, dt, b, sq, sk, off, kw, causal=True):
        h, kvh, d, _ = dims[arch]
        q = randn((b, sq, h, d), dt)
        k = randn((b, sk, kvh, d), dt)
        v = randn((b, sk, kvh, d), dt)
        kwf = dict(causal=causal, **kw)
        if off is not None:
            kwf.update(q_offset=torch.full((b,), off, dtype=torch.int32,
                                           device="cuda"),
                       kv_len=torch.full((b,), off + sq, dtype=torch.int32,
                                         device="cuda"))
        got = ops.flash_attention(q, k, v, **kwf)
        want = ops.flash_attention(q, k, v, impl="ref", **kwf)
        wmean = None
        if dt == torch.bfloat16:
            wmean = ops.flash_attention(q.float(), k.float(), v.float().abs(),
                                        impl="ref", **kwf)
        err = check(f"flash {case}", got, want, wmean)
        note = "" if kw["window"] is None else " (SDPA, no softcap)"
        lib_ms = sdpa_ms(torch, timer, q, k, v, causal=causal, q_offset=off,
                         kv_len=kwf.get("kv_len"), window=kw["window"])
        nbytes, nops = _flash_bytes_ops(torch, q, k, kwf.get("kv_len"),
                                        kwf.get("q_offset", 0), kw["window"],
                                        causal=causal)
        where = ("" if off is None else f" at q_offset {off} of {sk}")
        if sk != sq and off is None:
            where += f" against ({b}, {sk})"
        flash_report(f"{case} ({b}, {sq}) x {h}/{kvh} heads x "
                     f"{d}{where}" + ("" if causal else ", not causal")
                     + (f", window {kw['window']} softcap {kw['softcap']:g}"
                        if kw["window"] else ""),
                     err, dt, lambda: ops.flash_attention(q, k, v, **kwf),
                     lambda: ops.flash_attention(q, k, v, impl="ref", **kwf),
                     lib_ms, nbytes, nops, note)
        del q, k, v, got, want, wmean

    for args in (
            ("gemma2 one-shot bf16", "gemma2-2b", torch.bfloat16, SLOTS, CTX,
             CTX, None, win),
            ("gemma2 chunk bf16", "gemma2-2b", torch.bfloat16, 1, CHUNK,
             LONG_CTX, long_off, win),
            ("gemma2 chunk fp32 (int8 pages)", "gemma2-2b", torch.float32, 1,
             CHUNK, LONG_CTX, long_off, win),
            ("gemma-7b one-shot bf16", "gemma-7b", torch.bfloat16, SLOTS,
             CTX, CTX, None, none),
            ("chatglm3 one-shot bf16", "chatglm3-6b", torch.bfloat16, SLOTS,
             CTX, CTX, None, none),
            ("granite one-shot bf16", "granite-moe-1b-a400m", torch.bfloat16,
             SLOTS, CTX, CTX, None, none),
            ("granite chunk fp32 (int8 pages)", "granite-moe-1b-a400m",
             torch.float32, 1, CHUNK, CTX, CTX - CHUNK, none),
            ("llama3-70b / jamba one-shot bf16", LLAMA70B, torch.bfloat16,
             SLOTS, CTX, CTX, None, none),
            ("llama3-70b chunk bf16", LLAMA70B, torch.bfloat16, 1, CHUNK,
             CTX, CTX - CHUNK, none)):
        flash_case(*args)
    # seamless: its encoder (bidirectional, Sq = Sk, and a ragged 1000);
    # its cross attention, never causal, the decoder's rows against the
    # encoder's frames: serve-seamless's 16-token prompts (one q tile,
    # mostly empty) and 1024 x 0.125 = 128 rows (a full tile); and the
    # decoder's causal self-prefill of the served prompts
    for dt in (bf16, torch.float32):
        name = "bf16" if dt == bf16 else "fp32"
        for what, sq, sk, causal in (
                ("encoder", ENC_FRAMES, ENC_FRAMES, False),
                ("encoder ragged", 1000, 1000, False),
                ("cross", SEAMLESS_PROMPT, ENC_FRAMES, False),
                ("cross", SEAMLESS_CROSS_Q, ENC_FRAMES, False),
                ("decoder self-prefill", SEAMLESS_PROMPT, SEAMLESS_PROMPT,
                 True)):
            flash_case(f"seamless {what} {name}", SEAMLESS, dt, SLOTS, sq,
                       sk, None, none, causal=causal)

    # ---- MLA's flash (deepseek-v2-lite): 16/16 heads, q and k of 192
    # columns (128 nope + 64 rope), v of 128, causal, scale 192**-0.5;
    # one-shot bf16 at (8, 1024) and the fp32 path at (1, 256)
    ds = get_config(DEEPSEEK)
    hm, dqk, dvm = ds.num_heads, ds.mla.qk_head_dim, ds.mla.v_head_dim
    for case, dt, b, sq in (("deepseek one-shot bf16", torch.bfloat16, SLOTS,
                             CTX),
                            ("deepseek one-shot fp32", torch.float32, 1,
                             CHUNK)):
        q, k = randn((b, sq, hm, dqk), dt), randn((b, sq, hm, dqk), dt)
        v = randn((b, sq, hm, dvm), dt)
        kwf = dict(causal=True, scale=dqk ** -0.5)
        got = ops.flash_attention(q, k, v, **kwf)
        want = ops.flash_attention(q, k, v, impl="ref", **kwf)
        if tuple(got.shape) != (b, sq, hm, dvm) or got.shape != want.shape:
            fail(f"flash {case}: output {tuple(got.shape)}, plain "
                 f"{tuple(want.shape)}, want {(b, sq, hm, dvm)}")
        wmean = None
        if dt == torch.bfloat16:
            wmean = ops.flash_attention(q.float(), k.float(), v.float().abs(),
                                        impl="ref", **kwf)
        err = check(f"flash {case}", got, want, wmean)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        try:
            lib_ms, note = timer(lambda: sdpa(qt, kt, vt, is_causal=True,
                                              scale=kwf["scale"])), ""
        except RuntimeError as e:       # no SDPA backend takes dv != dqk
            lib_ms, note = None, ""
            log(f"[family-kernel] flash {case}: SDPA refused the shape: "
                f"{str(e).splitlines()[0][:200]}")
        nbytes, nops = _flash_bytes_ops(torch, q, k, None, 0, None, dv=dvm)
        flash_report(f"{case} ({b}, {sq}) x {hm}/{hm} heads x q/k {dqk}, "
                     f"v {dvm}", err, dt,
                     lambda: ops.flash_attention(q, k, v, **kwf),
                     lambda: ops.flash_attention(q, k, v, impl="ref", **kwf),
                     lib_ms, nbytes, nops, note)
        del q, k, v, got, want, wmean

    # ---- RMSNorm alone at MLA's latent (512: deepseek's norm_kv, a decode
    # step's 8 rows) and at 2048 (mamba2's gate norm: a decode step's 8
    # rows and a whole-batch prefill's 8192)
    # and at jamba's Mamba gate norm over d_inner 16384 (bf16, and fp32,
    # which holds 4 vectors a thread)
    di = get_config(JAMBA).ssm.d_inner(get_config(JAMBA).d_model)
    for t, dm, what, dt in (
            (SLOTS, ds.mla.kv_lora_rank, "deepseek norm_kv", bf16),
            (SLOTS, 2048, "mamba2 gate_norm", bf16),
            (SLOTS * CTX, 2048, "mamba2 gate_norm, prefill", bf16),
            (SLOTS, di, "jamba gate_norm", bf16),
            (SLOTS, di, "jamba gate_norm", torch.float32)):
        x = randn((t, dm), dt)
        w = (1 + 0.1 * randn((dm,), torch.float32)).to(dt)
        got = ops.rmsnorm(x, w, 1e-6)
        err = check(f"rmsnorm ({t}, {dm})", got,
                    ops.rmsnorm(x, w, 1e-6, impl="ref"))
        cold = t > CHUNK
        esz = x.element_size()
        report("rmsnorm", f"rmsnorm ({t}, {dm}) "
               f"{'bf16' if dt == bf16 else 'fp32'} ({what})"
               + (", L2 flushed" if cold else ""), err,
               timer(lambda: ops.rmsnorm(x, w, 1e-6), cold=cold),
               timer(lambda: ops.rmsnorm(x, w, 1e-6, impl="ref"), cold=cold),
               timer(lambda: F.rms_norm(x, (dm,), w, 1e-6), cold=cold),
               bound_ms(2 * x.numel() * esz + dm * esz, 4 * x.numel(),
                        PEAK_FP32))
        del x, w, got

    # ---- RMSNorm at the families' widths: fused with the residual add,
    # a decode step's 8 rows (warm) and a prefill chunk's 256 (cold)
    for arch in ("gemma2-2b", "gemma-7b", "granite-moe-1b-a400m", JAMBA):
        dm = dims[arch][3]
        for t in (SLOTS, CHUNK):
            x, res = randn((t, dm), torch.bfloat16), randn((t, dm),
                                                           torch.bfloat16)
            w = (1 + 0.1 * randn((dm,), torch.float32)).to(torch.bfloat16)
            got_s, got = ops.add_rmsnorm(x, res, w, 1e-6)
            if not torch.equal(got_s, x + res):
                fail(f"add_rmsnorm ({t}, {dm}): s differs from x + r")
            err = check(f"add_rmsnorm ({t}, {dm})", got,
                        ops.rmsnorm(got_s, w, 1e-6, impl="ref"))
            cold = t == CHUNK
            nbytes = 4 * x.numel() * 2 + dm * 2
            report("rmsnorm", f"add_rmsnorm ({t}, {dm}) bf16 ({arch})"
                   + (", L2 flushed" if cold else ""), err,
                   timer(lambda: ops.add_rmsnorm(x, res, w, 1e-6), cold=cold),
                   timer(lambda: ops.add_rmsnorm(x, res, w, 1e-6, impl="ref"),
                         cold=cold),
                   timer(lambda: F.rms_norm(x + res, (dm,), w, 1e-6),
                         cold=cold),
                   bound_ms(nbytes, 5 * x.numel(), PEAK_FP32))

    # ---- the exact MoE path's products (a decode step's rows, granite and
    # deepseek): bf16 operands to an fp32 result, as the reference's
    # ragged_dot, within MOE_PRODUCT_TOL of the largest |product|
    for arch in ("granite-moe-1b-a400m", DEEPSEEK):
        errs, y_err = _moe_product_errors(torch, get_config(arch), SLOTS, gen)
        for name, (err, b16) in errs.items():
            if not err <= MOE_PRODUCT_TOL:
                fail(f"[family-kernel] {arch} MoE {name} product: {err:.3e} "
                     f"of its largest value off the fp32 product, tol "
                     f"{MOE_PRODUCT_TOL}")
        if not y_err <= MOE_PRODUCT_TOL:
            fail(f"[family-kernel] {arch} _grouped_ffn: {y_err:.3e} off the "
                 f"fp32 down product of its hidden rows, tol "
                 f"{MOE_PRODUCT_TOL}")
        log(f"[family-kernel] {arch} exact MoE path, {SLOTS} tokens: "
            + ", ".join(f"{n} product {e:.2e} off fp32 (a bf16 result "
                        f"{b:.2e})" for n, (e, b) in errs.items())
            + f"; _grouped_ffn {y_err:.2e} off the fp32 down product of its "
            f"hidden rows; relative to the largest value, tol "
            f"{MOE_PRODUCT_TOL} ({smi})")
    torch.cuda.synchronize()
    return shapes


def phase_family_models(torch, smi):
    """Each family at full width and the depth of one pattern repeat (two
    layers for gemma2, one for the others; llama3-70b for its G = 8
    decode): card fp32 logits against the port's CPU fp32 logits (chunked
    prefill + paged decode, one-shot prefill + dense decode), then card
    bf16 on both paths, fed the fp32 card run's tokens, against each other
    (and, printed, card fp32)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    page = 8
    for arch in FAMILY_ARCHS + (LLAMA70B,):
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=len(full.layer_pattern))
        # llama3-70b's CPU run multiplies 11 GB of fp32 weights a pass:
        # fewer tokens and steps (3 chunks and 2 decode steps still)
        ctx, chunk, steps = (24, 8, 3) if arch == LLAMA70B else (40, 16, 6)
        cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
        # drawn on the card and copied to the host (a draw on the host
        # of llama3-70b's 11 GB of fp32 weights took most of its check)
        p_gpu = _family_init(torch, cfg, 5, torch.float32, "cuda")
        p_cpu = _to_dev(p_gpu, "cpu")
        g = torch.Generator().manual_seed(6)
        prompts = torch.randint(2, cfg.vocab_size, (2, ctx), generator=g,
                                dtype=torch.int32)
        kw = dict(ctx=ctx, chunk=chunk, page=page, steps=steps)
        runs = {}
        for dev, model, params in (("cpu", cpu, p_cpu), ("cuda", gpu, p_gpu)):
            runs[dev] = _model_logits(torch, cfg, model, params, dev,
                                      prompts, **kw)
        errs = []
        for i, name in enumerate(("chunked + paged", "one-shot + dense")):
            got, want = runs["cuda"][i], runs["cpu"][i]
            errs.append(check_close(f"[model] {arch} fp32 {name}", got, want,
                                    atol=FAMILY_LOGIT_TOL))
            if not torch.equal(got.argmax(-1), want.argmax(-1)):
                fail(f"[model] {arch} {name}: greedy tokens differ between "
                     "card and CPU")
        p_bf = _cast_params(torch, p_gpu, torch.bfloat16)
        bf = _model_logits(torch, cfg, gpu, p_bf, "cuda", prompts,
                           dtype=torch.bfloat16, force=runs["cuda"][2], **kw)
        scale = float(runs["cuda"][1].abs().max())
        bound = BF16_MODEL_REL * scale
        bf_errs = [float((bf[i] - runs["cuda"][i]).abs().max())
                   for i in range(2)]
        cross = float((bf[0][0] - bf[1][0]).abs().max())
        if cross > bound:
            fail(f"[model] {arch} bf16 on the card: chunked + paged off "
                 f"one-shot + dense by {cross} (bound {bound:.4f}, "
                 f"{BF16_MODEL_REL} of the largest logit)")
        log(f"[model] {arch} at full width, {cfg.num_layers} layer(s) "
            f"({cfg.num_heads}/{cfg.num_kv_heads} heads x "
            f"{cfg.resolved_head_dim}, d_model {cfg.d_model}): card fp32 vs "
            f"CPU fp32 max logit err chunked+paged {errs[0]:.3e}, "
            f"one-shot+dense {errs[1]:.3e} (tol {FAMILY_LOGIT_TOL}), greedy "
            f"tokens equal; card bf16 off card fp32 by {bf_errs[0]:.4f} / "
            f"{bf_errs[1]:.4f}, bf16 chunked+paged off bf16 one-shot+dense "
            f"(prefill row) by {cross:.4f} (largest logit {scale:.3f}; "
            f"{smi})")
        del cpu, gpu, p_cpu, p_gpu, p_bf, runs, bf
        _free(torch)


def _family_engine(store, queries, gen):
    from repro_torch.core.scheduler import BacklogScheduler
    from repro_torch.serving import RagdollEngine
    return RagdollEngine(store, QueryEmbedder(queries), gen,
                         BacklogScheduler(max_batch=SLOTS),
                         BacklogScheduler(max_batch=SLOTS),
                         initial_partitions=PARTITIONS - SPILLED,
                         device="cuda")


def _serve_few(torch, eng, tag, rids, max_new, kernels, exact, smi, vocab,
               query_of=None):
    """Serve ``rids`` through a fresh engine with the launch counts set to
    0 just before and read just after; checks every request's tokens and
    exact chunks and that ``kernels`` launched."""
    from repro_torch.kernels import ops
    from repro_torch.serving import percentile
    errors = _watch_threads()
    eng.start()
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = _submit_and_drain(eng, list(rids), 600, tag, errors,
                                 query_of=query_of, max_new=max_new,
                                 total=len(rids))
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
    finally:
        eng.stop()
        eng.streamer.close()
    if errors:
        fail(f"[{tag}] worker thread died: {errors}")
    reqs = sorted((r for r in done if r.rid in set(rids)),
                  key=lambda r: r.rid)
    check_requests(torch, tag, reqs, exact, vocab, n=len(rids),
                   max_new=max_new)
    missing = [n for n in kernels if counts[n] == 0]
    if missing:
        fail(f"[{tag}] kernels never launched on this path: {missing}")
    lat = [r.latency for r in reqs]
    log(f"[{tag}] {len(reqs)} requests, {max_new} tokens and {TOP_K} exact "
        f"chunks each, in {wall:.3f} s: p50 {percentile(lat, 50):.3f} s "
        f"p95 {percentile(lat, 95):.3f} s, "
        f"{len(reqs) * max_new / wall:.1f} output tokens/s ({smi})")
    log(f"[{tag}] launches on this path: {json.dumps(counts)}")
    return dict(counts=counts, reqs=reqs,
                outputs={r.rid: r.output for r in reqs})


def _chunked_row(torch, cfg, params, ids):
    """Last-row logits of ``ids`` (1, n) through chunked prefill into a
    fresh page pool: the serving path's function (a MoE's chunk of 256
    tokens stays below the capacity path's threshold)."""
    from repro_torch.models.model import Model, init_cache
    n = ids.shape[1]
    nmax = -(-n // PAGE)
    cache = init_cache(cfg, nmax + 1, PAGE, params["embed"].dtype, "cuda")
    tab = torch.arange(1, nmax + 1, dtype=torch.int32, device="cuda")[None]
    model = Model(cfg, device="cuda")
    for off in range(0, n, CHUNK):
        c = min(CHUNK, n - off)
        lg = model.chunk_prefill(
            params, ids[:, off:off + c], cache,
            torch.full((1,), off, dtype=torch.int32, device="cuda"), tab,
            kv_span=n)
    return lg[0].float()


def _hold_tokens(torch, tag, cfg, params, reqs, other, smi, *, ctx,
                 what, chunked=False, fp32=None, layerwise=False):
    """Each request's tokens against ``other`` (rid -> text): equal, or
    apart first at a near tie that fp32 confirms (the two choices' fp32
    logits within twice the bf16 row's largest error).  ``chunked``
    recomputes the row by chunked prefill (a MoE's one-shot prefill would
    take the capacity path), else by ``_near_tie``'s prefill and decode
    steps; ``layerwise`` casts the weights to fp32 a layer at a time."""
    from repro_torch.serving.generator import HashTokenizer
    ties = 0
    for r in reqs:
        if other[r.rid] == r.output:
            continue
        if fp32 is None and not layerwise:
            fp32 = _cast_params(torch, params, torch.float32)
        if chunked:
            want = [int(t[3:]) for t in other[r.rid].split()]
            got = [int(t[3:]) for t in r.output.split()]
            t = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
            toks = HashTokenizer(cfg.vocab_size).encode(r.prompt, ctx)
            ids = torch.tensor([list(toks) + want[:t]], dtype=torch.int32,
                               device="cuda")
            with torch.no_grad():
                rows = {n: _chunked_row(torch, cfg, p, ids)
                        for n, p in (("bf16", params), ("fp32", fp32))}
            a, b = want[t], got[t]
            gap = float(rows["fp32"][a] - rows["fp32"][b])
            err = float((rows["bf16"] - rows["fp32"]).abs().max())
        else:
            t, a, b, gap, err = _near_tie(torch, cfg, params, fp32, r,
                                          other[r.rid], ctx=ctx)
        msg = (f"[{tag}] request {r.rid} ({r.query}): first other token at "
               f"{t}, {b} for {a}; fp32 logit gap {gap:.6f}, bf16 logits "
               f"off fp32 by up to {err:.6f} in that row")
        if abs(gap) > 2 * err:
            fail(f"{msg}: not a near tie")
        log(f"{msg}: a near tie ({smi})")
        ties += 1
    log(f"[{tag}] {len(reqs)} requests: {what}'s tokens, but for {ties} "
        "that leave them at an fp32-witnessed near tie")
    return ties


def _teacher_forced(torch, tag, cfg, params, fp32, reqs, other, smi):
    """Every step of every request, both served paths fed ``other``'s
    tokens (the whole-batch run's): the paged path (chunked prefill into
    pages, the paged decode) in bf16, the whole-batch path (one-shot
    prefill into a dense cache, the dense decode) in bf16 and with
    ``fp32``.  Fails at any step where the paged logits are further from
    fp32 than twice the whole-batch bf16 logits are: a decode kernel a
    little off shows at every step, where the token check stops at a
    request's first near tie."""
    from repro_torch.models.model import Model, init_cache
    from repro_torch.serving.generator import HashTokenizer
    model = Model(cfg, device="cuda")
    worst, steps = (0.0, ""), 0
    with torch.no_grad():
        for r in reqs:
            want = [int(t[3:]) for t in other[r.rid].split()]
            toks = HashTokenizer(cfg.vocab_size).encode(r.prompt, CTX)
            ids = torch.tensor([list(toks) + want[:-1]], dtype=torch.int32,
                               device="cuda")
            n = ids.shape[1]
            nmax = -(-n // PAGE)
            pages = init_cache(cfg, nmax + 1, PAGE, params["embed"].dtype,
                               "cuda")
            tab = torch.arange(1, nmax + 1, dtype=torch.int32,
                               device="cuda")[None]
            for off in range(0, CTX, CHUNK):
                lg = model.chunk_prefill(
                    params, ids[:, off:off + CHUNK], pages,
                    torch.full((1,), off, dtype=torch.int32, device="cuda"),
                    tab, kv_span=n)
            rows = {"paged": [lg[0].float()]}
            dense = {}
            for name, p in (("bf16", params), ("fp32", fp32)):
                dense[name] = init_cache(cfg, 1, n, p["embed"].dtype, "cuda")
                rows[name] = [model.prefill(p, ids[:, :CTX],
                                            dense[name])[0].float()]
            for i in range(len(want) - 1):
                cur = ids[:, CTX + i:CTX + i + 1]
                pos = torch.full((1,), CTX + i, dtype=torch.int32,
                                 device="cuda")
                rows["paged"].append(model.decode(
                    params, cur, pages, pos, tab, kv_span=n)[0].float())
                for name, p in (("bf16", params), ("fp32", fp32)):
                    rows[name].append(
                        model.decode(p, cur, dense[name], pos)[0].float())
            for i, (lp, ld, lf) in enumerate(zip(
                    rows["paged"], rows["bf16"], rows["fp32"])):
                e_p = float((lp - lf).abs().max())
                e_d = float((ld - lf).abs().max())
                where = (f"request {r.rid} step {i}: the paged path off fp32 "
                         f"by up to {e_p:.6f}, the whole-batch path by "
                         f"{e_d:.6f}, apart by "
                         f"{float((lp - ld).abs().max()):.6f}")
                if e_p > 2 * e_d:
                    fail(f"[{tag}] {where}: past twice the whole-batch "
                         "path's bf16 error")
                worst = max(worst, (e_p / max(e_d, 1e-12), where))
                steps += 1
            del pages, dense, rows
    log(f"[{tag}] teacher-forced on the whole-batch tokens, {steps} steps "
        f"of {len(reqs)} requests: the paged logits within twice the "
        f"whole-batch bf16 error of fp32 at every step; the closest, "
        f"{worst[0]:.3f} of it, at {worst[1]} ({smi})")


def profile_decode_step(torch, tag, model, params, cache, block_tab, span,
                        smi, cur=None, at=CTX) -> None:
    """One decode step of ``SLOTS`` slots at position ``at`` under the
    profiler: its device kernels, busy and idle share, time by kind.
    ``cur``: the step's inputs (default: token 0 in every slot)."""
    from torch.profiler import ProfilerActivity, profile
    if cur is None:
        cur = torch.zeros((SLOTS, 1), dtype=torch.int32, device="cuda")
    pos = torch.full((SLOTS,), at, dtype=torch.int32, device="cuda")
    model.decode(params, cur, cache, pos, block_tab, kv_span=span)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.decode(params, cur, cache, pos, block_tab, kv_span=span)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    recs = _kernel_records(prof, torch)
    n = sum(1 for name, _, _ in recs
            if not name.startswith(("Memcpy", "Memset")))
    log(f"[{tag}] one decode step ({SLOTS} slots): {n} device kernels")
    breakdown(tag, recs, window, smi, what="one decode step")


def phase_serve_gemma2(torch, store, queries, exact, smi):
    """gemma2-2b at full width and depth (26 layers, seeded bf16 weights)
    behind ``RagdollEngine``: (a) the paged, chunk-prefilled continuous
    generator (bf16 pages of 16, chunks of 256) serves 16 requests at ctx
    1024 (the window never masks); one profiled decode step; (b) the
    whole-batch ``Generator`` behind the engine on the same requests: the
    same tokens but at fp32-witnessed near ties; (c) 4 requests at ctx 6144
    on both paths (the local layers' window masks in prefill and decode),
    held the same way; (d) 4 requests at ctx 1024 over int8 pages (the
    D = 256 int8 decode and fp32 chunk kernels on a serving path).
    Returns each run's launch counts."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.serving import ContinuousGenerator, Generator
    from repro_torch.serving import GeneratorConfig
    t_phase = time.perf_counter()
    tag = "serve-gemma2"
    cfg = get_config("gemma2-2b")
    t0 = time.perf_counter()
    params = _family_init(torch, cfg, 0, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} layers ({cfg.layer_pattern}),"
        f" d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads x"
        f" {cfg.resolved_head_dim}, window {cfg.sliding_window}, softcaps "
        f"{cfg.attn_logit_softcap:g}/{cfg.final_logit_softcap:g}; {nbytes} B "
        f"of bf16 weights in {time.perf_counter() - t0:.1f} s; KV "
        f"{cfg.kv_cache_bytes_per_token()} B a token")
    g = GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW,
                        dtype=torch.bfloat16)
    paged = dict(num_slots=SLOTS, paged=True, page_size=PAGE,
                 prefill_chunk=CHUNK, device="cuda")
    counts = []
    # (a) the continuous path at ctx 1024
    gen = ContinuousGenerator(cfg, params, g, **paged)
    eng = _family_engine(store, queries, gen)
    out = serve_path(torch, eng, tag, CONTINUOUS_KERNELS, exact, smi,
                     cfg.vocab_size, stats=eng.retrieval_stats,
                     step_hist=eng.registry.histogram("decode.step_seconds"),
                     profile=False)
    eng.streamer.close()
    counts.append(out["counts"])
    profile_decode_step(torch, tag, gen.model, params, gen.cache,
                        gen.kv.device_tab(), gen._total, smi)
    del gen, eng
    _free(torch)
    # (b) the whole-batch path on the same requests
    rids = [r.rid for r in out["reqs"]]
    wb = _serve_few(torch, _family_engine(store, queries,
                                          Generator(cfg, params, g,
                                                    device="cuda")),
                    f"{tag} whole-batch", rids, MAX_NEW, WHOLE_BATCH_KERNELS,
                    exact, smi, cfg.vocab_size)
    counts.append(wb["counts"])
    fp32 = _cast_params(torch, params, torch.float32)
    _hold_tokens(torch, tag, cfg, params, out["reqs"], wb["outputs"], smi,
                 ctx=CTX, what="the whole-batch Generator", fp32=fp32)
    # (c) long prompts, where the window masks
    first = WARMUP_REQ + N_REQ
    long_rids = list(range(first, first + LONG_REQ))
    gl = dataclasses.replace(g, ctx_len=LONG_CTX)
    runs = {}
    for label, make, kernels in (
            ("paged", lambda: ContinuousGenerator(cfg, params, gl, **paged),
             CONTINUOUS_KERNELS),
            ("whole-batch", lambda: Generator(cfg, params, gl, device="cuda"),
             WHOLE_BATCH_KERNELS)):
        runs[label] = _serve_few(
            torch, _family_engine(store, queries, make()),
            f"{tag} ctx {LONG_CTX} {label}", long_rids, MAX_NEW, kernels,
            exact, smi, cfg.vocab_size)
        counts.append(runs[label]["counts"])
        _free(torch)
    _hold_tokens(torch, f"{tag} ctx {LONG_CTX}", cfg, params,
                 runs["paged"]["reqs"], runs["whole-batch"]["outputs"], smi,
                 ctx=LONG_CTX, what="the whole-batch Generator", fp32=fp32)
    del fp32
    _free(torch)
    # (d) int8 pages
    i8 = _serve_few(torch, _family_engine(store, queries, ContinuousGenerator(
        cfg, params, g, kv_format="int8", **paged)), f"{tag} int8 pages",
        rids[:LONG_REQ], MAX_NEW, SWAP_KERNELS, exact, smi, cfg.vocab_size)
    counts.append(i8["counts"])
    del params
    _free(torch)
    log(f"[{tag}] the phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


def phase_serve_families(torch, store, queries, exact, smi):
    """gemma-7b, chatglm3-6b and granite-moe-1b-a400m at full width and
    depth (seeded bf16 weights), one after the other: the paged continuous
    path behind ``RagdollEngine`` serves 8 requests of 16 tokens, and the
    whole-batch path behind it serves them again.  gemma-7b and chatglm3
    hold the paged tokens to the whole-batch ones; granite holds them to
    the paged path run with its weights cast to fp32, since its one-shot
    prefill of 8 x 1024 tokens at top 8 takes the capacity path (drops)
    and its 256-token chunks the exact one: the two paths compute
    different functions, in both packages.  Prints how many rows the
    capacity path dropped in one whole-batch prefill.  Returns each run's
    launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.serving import ContinuousGenerator, Generator
    from repro_torch.serving import GeneratorConfig
    counts = []
    for arch in FAMILY_ARCHS[1:]:
        t_phase = time.perf_counter()
        tag = f"serve-families {arch}"
        cfg = get_config(arch)
        t0 = time.perf_counter()
        params = _family_init(torch, cfg, 0, torch.bfloat16, "cuda")
        torch.cuda.synchronize()
        nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        log(f"[{tag}] {cfg.num_layers} layers, d_model {cfg.d_model}, "
            f"{cfg.num_heads}/{cfg.num_kv_heads} heads x "
            f"{cfg.resolved_head_dim}, {cfg.mlp_kind}"
            + (f", MoE {cfg.moe.num_experts} experts top {cfg.moe.top_k}"
               if cfg.moe else "") + (", QKV bias, RoPE on half the head "
                                      "dims" if cfg.qkv_bias else "")
            + f"; {nbytes} B of weights in {time.perf_counter() - t0:.1f} s")
        g = GeneratorConfig(ctx_len=CTX, max_new_tokens=FAMILY_NEW,
                            dtype=torch.bfloat16)
        paged = dict(num_slots=SLOTS, paged=True, page_size=PAGE,
                     prefill_chunk=CHUNK, device="cuda")
        rids = list(range(FAMILY_REQ))
        run = _serve_few(torch, _family_engine(
            store, queries, ContinuousGenerator(cfg, params, g, **paged)),
            tag, rids, FAMILY_NEW, CONTINUOUS_KERNELS, exact, smi,
            cfg.vocab_size)
        counts.append(run["counts"])
        _free(torch)
        with _recording_drops() as drops:
            wb = _serve_few(torch, _family_engine(
                store, queries, Generator(cfg, params, g, device="cuda")),
                f"{tag} whole-batch", rids, FAMILY_NEW, WHOLE_BATCH_KERNELS,
                exact, smi, cfg.vocab_size)
        counts.append(wb["counts"])
        _free(torch)
        if cfg.moe is None:
            _hold_tokens(torch, tag, cfg, params, run["reqs"], wb["outputs"],
                         smi, ctx=CTX, what="the whole-batch Generator")
        else:
            first = drops[:cfg.num_layers]
            if not first:
                fail(f"[{tag}] no whole-batch prefill took the capacity path")
            log(f"[{tag}] the whole-batch path's first prefill "
                f"({first[0][1]} rows a layer: capacity path) dropped "
                f"{sum(d for d, _ in first)} rows over {len(first)} layers "
                f"({', '.join(str(d) for d, _ in first)}); its chunks of "
                f"{CHUNK} tokens ({CHUNK * cfg.moe.top_k} rows) take the exact "
                f"path ({smi})")
            fp32 = _cast_params(torch, params, torch.float32)
            ref = ContinuousGenerator(cfg, fp32, GeneratorConfig(
                ctx_len=CTX, max_new_tokens=FAMILY_NEW, dtype=torch.float32),
                **paged)
            texts = ref.run([r.prompt for r in run["reqs"]])
            del ref
            _free(torch)
            _hold_tokens(torch, tag, cfg, params, run["reqs"],
                         dict(zip(rids, texts)), smi, ctx=CTX,
                         what="the same path in fp32", chunked=True,
                         fp32=fp32)
            del fp32
        del params
        _free(torch)
        log(f"[{tag}] took {time.perf_counter() - t_phase:.1f} s")
    return counts


def phase_dense_family_models(torch, smi):
    """deepseek-v2-lite at depth 2 (its dense first layer and one MLA +
    MoE layer), mamba2-370m at depth 1 and jamba at depth 4 (its four
    layer kinds; the experts cut to 2, top 2, so that fp32 fits: every
    width stays full), at full width: card fp32 logits of one-shot
    prefill + dense decode (none has a paged path) against the port's CPU
    fp32 logits on the same weights, then card bf16, fed the card fp32
    run's tokens, against card fp32 (printed)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    for arch, depth in DENSE_MODEL_DEPTH.items():
        cfg = dataclasses.replace(get_config(arch), num_layers=depth)
        # jamba's CPU run multiplies 24 GB of fp32 weights a pass
        ctx, steps = (16, 3) if arch == JAMBA else (40, 6)
        if arch == JAMBA:
            full = cfg.moe.num_experts
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, num_experts=JAMBA_MODEL_EXPERTS))
            log(f"[model] {arch}: the experts cut from {full} to "
                f"{cfg.moe.num_experts} (top {cfg.moe.top_k}) for the fp32 "
                f"check: {cfg.weight_bytes(4)} B in fp32 at depth {depth}, "
                f"where {full} experts would be "
                f"{dataclasses.replace(get_config(arch), num_layers=depth).weight_bytes(4)} B")
        gpu, cpu = Model(cfg, device="cuda"), Model(cfg, device="cpu")
        p_gpu = _family_init(torch, cfg, 5, torch.float32, "cuda")
        p_cpu = _to_dev(p_gpu, "cpu")
        g = torch.Generator().manual_seed(6)
        prompts = torch.randint(2, cfg.vocab_size, (2, ctx), generator=g,
                                dtype=torch.int32)
        kw = dict(ctx=ctx, steps=steps)
        runs = {dev: _dense_logits(torch, cfg, model, params, dev, prompts,
                                   **kw)
                for dev, model, params in (("cpu", cpu, p_cpu),
                                           ("cuda", gpu, p_gpu))}
        got, want = runs["cuda"][0], runs["cpu"][0]
        err = check_close(f"[model] {arch} fp32 one-shot + dense", got, want,
                          atol=FAMILY_LOGIT_TOL)
        if not torch.equal(got.argmax(-1), want.argmax(-1)):
            fail(f"[model] {arch}: greedy tokens differ between card and "
                 "CPU")
        p_bf = _cast_params(torch, p_gpu, torch.bfloat16)
        bf, _ = _dense_logits(torch, cfg, gpu, p_bf, "cuda", prompts,
                              dtype=torch.bfloat16,
                              force=torch.stack(runs["cuda"][1]), **kw)
        if not bool(bf.isfinite().all()):
            fail(f"[model] {arch} bf16 on the card: logits not finite")
        what = (f"MLA {cfg.num_heads} heads, q/k {cfg.mla.qk_head_dim} v "
                f"{cfg.mla.v_head_dim}, latent {cfg.mla.kv_lora_rank}, MoE "
                f"{cfg.moe.num_experts} top {cfg.moe.top_k} + "
                f"{cfg.moe.num_shared_experts} shared" if cfg.mla else
                f"SSD d_inner {cfg.ssm.d_inner(cfg.d_model)}, state "
                f"{cfg.ssm.d_state}, chunk {cfg.ssm.chunk_size}"
                + (f"; attention {cfg.num_heads}/{cfg.num_kv_heads} heads x "
                   f"{cfg.resolved_head_dim}, MoE {cfg.moe.num_experts} "
                   f"top {cfg.moe.top_k} of {cfg.moe.d_ff_expert}, dense "
                   f"FFN {cfg.d_ff}" if cfg.moe else ""))
        log(f"[model] {arch} at full width, {depth} layer(s) "
            f"({cfg.layer_kinds()}; d_model {cfg.d_model}, {what}): card "
            f"fp32 vs CPU fp32 max logit err one-shot+dense {err:.3e} (tol "
            f"{FAMILY_LOGIT_TOL}), greedy tokens equal; card bf16 off card "
            f"fp32 by {float((bf - got).abs().max()):.4f} (largest logit "
            f"{float(got.abs().max()):.3f}; {smi})")
        del cpu, gpu, p_cpu, p_gpu, p_bf, runs, bf
        _free(torch)


@contextlib.contextmanager
def _recording_drops():
    """Within the block, each call of the MoE's grouped GEMM that takes
    the capacity path appends (rows dropped, rows) to the list given."""
    from repro_torch.models import moe
    drops = []
    grouped = moe.grouped_ffn

    def counting(p, xs, gs, kind, impl="auto"):
        if impl == "auto" and xs.shape[0] >= moe.CAPACITY_THRESHOLD:
            drops.append((int(moe.capacity_drops(gs, xs.shape[0])),
                          xs.shape[0]))
        return grouped(p, xs, gs, kind, impl)

    moe.grouped_ffn = counting
    try:
        yield drops
    finally:
        moe.grouped_ffn = grouped


def _refuses_paged(torch, tag, cfg, params, g):
    """The paged pool takes attention mixers only, as the reference's."""
    from repro_torch.serving import ContinuousGenerator
    try:
        ContinuousGenerator(cfg, params, g, num_slots=2, paged=True,
                            page_size=PAGE, device="cuda")
    except NotImplementedError as e:
        log(f"[{tag}] paged=True raises, as in the reference: {e}")
        return
    fail(f"[{tag}] paged=True did not raise")


def _mem_available() -> int:
    """The host's MemAvailable, in bytes (``/proc/meminfo``)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return -1


def _streamed_pass(torch, tag, cfg, params, prompts, max_new, kernels, smi,
                   policy=None, drop=False):
    """A streamed whole-batch ``Generator`` on ``prompts`` against the
    resident one on the same weights (tokens equal exactly), then one
    layer's pinned copy rate and a decode pass against its copy bound.
    ``drop``: once the executor has pinned its copy, the caller's layers
    leave the card (``params["blocks"]`` is emptied) before the first pass
    allocates the ring.  Fails unless each of ``kernels`` launched in the
    streamed run, and unless the executor holds no more than ``top`` and
    ``ring_slots`` slots of its largest layer (allocated memory grew by
    the ring in the run).  Returns the launch counts of the streamed run
    alone."""
    import gc
    from repro_torch.core.prefetch import _pack_layout
    from repro_torch.kernels import ops
    from repro_torch.serving import Generator, GeneratorConfig
    g = GeneratorConfig(ctx_len=CTX, max_new_tokens=max_new,
                        dtype=torch.bfloat16)
    want = Generator(cfg, params, g, device="cuda").generate(prompts)
    top = sum(t.numel() * t.element_size() for k, t in params.items()
              if k != "blocks")
    largest = max(_pack_layout(lp)[1] for lp in params["blocks"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = Generator(cfg, params, g, streamed=True, policy=policy,
                    device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    ex = gen.exec
    log(f"[{tag}] streamed: {ex.streamed_bytes} B pinned in {t_build:.1f} "
        f"s; host MemAvailable after the pinning {_mem_available()} B")
    if drop:
        params["blocks"].clear()
        gc.collect()
        _free(torch)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = gen.generate(prompts)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    counts = ops.launch_counts()
    grown = torch.cuda.memory_allocated() - base
    if got != want:
        fail(f"[{tag}] streamed tokens differ from the resident Generator's "
             "on the same weights")
    missing = [n for n in kernels if counts[n] == 0]
    if missing:
        fail(f"[{tag}] kernels never launched on the streamed path: "
             f"{missing}")
    bound = top + ex.ring_slots * largest
    if ex.device_nbytes > bound or not ex.ring_nbytes <= grown \
            <= ex.ring_nbytes + (64 << 20):
        fail(f"[{tag}] the executor holds {ex.device_nbytes} B (bound: top "
             f"{top} + {ex.ring_slots} x the largest layer {largest} = "
             f"{bound} B); allocated memory grew by {grown} B in the run, "
             f"its ring is {ex.ring_nbytes} B")
    cache = ex.init_caches(len(prompts), CTX + max_new, torch.bfloat16)
    cur = torch.zeros((len(prompts), 1), dtype=torch.int32, device="cuda")
    pos = torch.full((len(prompts),), CTX, dtype=torch.int32, device="cuda")
    nbytes, copy_ms, rate, pass_s, bound_s = _copy_bound(
        torch, ex, lambda: ex.decode(cur, cache, pos))
    log(f"[{tag}] streamed: {ex.n_layers} layers, {ex.streamed_bytes} B in "
        f"pinned host memory (built in {t_build:.1f} s), {ex.ring_slots} "
        f"ring slots of {ex.slot_bytes} B (depth from the mean layer, "
        f"{ex.layer_bytes:.0f} B); the executor holds {ex.device_nbytes} B "
        f"on the device (bound: top + {ex.ring_slots} x the largest layer = "
        f"{bound} B), allocated memory grew by {grown} B in its first run; "
        f"{len(prompts)} prompts x {max_new} tokens in "
        f"{t_gen:.2f} s, tokens equal to the resident run's; the largest "
        f"layer ({nbytes} B) pinned host to device {copy_ms:.3f} ms, "
        f"{rate / 1e9:.2f} GB/s; a decode pass of {len(prompts)} rows "
        f"{pass_s * 1e3:.1f} ms (mean of 3) against a copy bound of "
        f"{bound_s * 1e3:.1f} ms: the bound is {bound_s / pass_s:.1%} of it "
        f"({smi})")
    log(f"[{tag}] streamed launches: {json.dumps(counts)}")
    del gen, ex, cache
    gc.collect()
    _free(torch)
    return counts


def _profile_dense_step(torch, tag, cfg, params, smi, rows=SLOTS):
    """One decode step of ``rows`` rows at position ``CTX`` on a dense
    cache, profiled (``profile_decode_step``)."""
    from repro_torch.models.model import Model, init_cache
    cache = init_cache(cfg, rows, CTX + FAMILY_NEW, torch.bfloat16, "cuda")
    profile_decode_step(torch, tag, Model(cfg, device="cuda"), params, cache,
                        None, None, smi)
    del cache


def phase_serve_deepseek(torch, store, queries, exact, smi):
    """deepseek-v2-lite-16b at full width and depth ``DEEPSEEK_SERVE_DEPTH``
    (a dense first layer, then MLA + MoE layers; seeded bf16 weights) behind
    ``RagdollEngine``, 8 requests of 16 tokens at ctx 1024 on the shared
    store: (a) the whole-batch ``Generator`` (its prefill of 8 x 1024
    tokens takes the capacity path: the drops are printed); (b) the dense
    ``ContinuousGenerator`` (a join prefills 1 x 1024 tokens: the exact
    path); (b)'s tokens held to the whole-batch ``Generator`` run a
    request at a time (the exact path too: the same function) but at
    fp32-witnessed near ties, the fp32 row cast a layer at a time, and
    (a)'s compared, printed; one profiled decode step; one join's prefill
    and one layer's exact grouped GEMM at its 6144 rows timed;
    ``paged=True`` raises.  Then streamed at 9 layers.  Returns each
    run's launch counts."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.model import Model, init_cache
    from repro_torch.serving import ContinuousGenerator, Generator
    from repro_torch.serving import GeneratorConfig
    t_phase = time.perf_counter()
    tag = "serve-deepseek"
    cfg = dataclasses.replace(get_config(DEEPSEEK),
                              num_layers=DEEPSEEK_SERVE_DEPTH)
    t0 = time.perf_counter()
    params = _family_init(torch, cfg, 0, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    m = cfg.moe
    log(f"[{tag}] {cfg.num_layers} layers ({cfg.first_k_dense} dense of "
        f"d_ff {cfg.first_dense_d_ff}, then MLA + MoE {m.num_experts} "
        f"experts top {m.top_k} + {m.num_shared_experts} shared of "
        f"{m.d_ff_expert}), d_model {cfg.d_model}; {nbytes} B of bf16 "
        f"weights in {time.perf_counter() - t0:.1f} s; latent cache "
        f"{cfg.kv_cache_bytes_per_token()} B a token")
    g = GeneratorConfig(ctx_len=CTX, max_new_tokens=FAMILY_NEW,
                        dtype=torch.bfloat16)
    rids = list(range(FAMILY_REQ))
    counts = []
    # (a) whole-batch, batches of 8: the capacity path's drops
    with _recording_drops() as drops:
        wb = _serve_few(torch, _family_engine(
            store, queries, Generator(cfg, params, g, device="cuda")),
            f"{tag} whole-batch", rids, FAMILY_NEW, DEEPSEEK_KERNELS, exact,
            smi, cfg.vocab_size)
    counts.append(wb["counts"])
    _free(torch)
    first = drops[:cfg.num_layers - cfg.first_k_dense]
    if not first:
        fail(f"[{tag}] no whole-batch prefill took the capacity path")
    log(f"[{tag}] the whole-batch path's first prefill ({first[0][1]} rows "
        f"a MoE layer: capacity path) dropped {sum(d for d, _ in first)} "
        f"rows over {len(first)} layers "
        f"({', '.join(str(d) for d, _ in first)}) ({smi})")
    # (b) the dense continuous path
    run = _serve_few(torch, _family_engine(
        store, queries, ContinuousGenerator(cfg, params, g, num_slots=SLOTS,
                                            device="cuda")),
        f"{tag} dense continuous", rids, FAMILY_NEW, DEEPSEEK_KERNELS, exact,
        smi, cfg.vocab_size)
    counts.append(run["counts"])
    _free(torch)
    same = sum(wb["outputs"][r] == run["outputs"][r] for r in rids)
    log(f"[{tag}] information only: {same}/{len(rids)} requests got the same "
        f"tokens from the whole-batch path (capacity path, drops) and the "
        f"dense continuous path (exact path)")
    t0 = time.perf_counter()
    one = Generator(cfg, params, g, device="cuda")
    alone = {r.rid: one.generate([r.prompt])[0] for r in run["reqs"]}
    del one
    log(f"[{tag}] the whole-batch Generator a request at a time: "
        f"{time.perf_counter() - t0:.2f} s for {len(rids)}")
    _hold_tokens(torch, tag, cfg, params, run["reqs"], alone, smi, ctx=CTX,
                 what="the whole-batch Generator a request at a time",
                 layerwise=True)
    _free(torch)
    _profile_dense_step(torch, tag, cfg, params, smi)
    # one dense join: a 1024-token one-shot prefill at batch 1 (the exact
    # grouped GEMM over a zero-padded (64, 6144, 2048) buffer a layer)
    model = Model(cfg, device="cuda")
    ids = torch.randint(2, cfg.vocab_size, (1, CTX), device="cuda",
                        dtype=torch.int32)
    join_s = []
    for _ in range(3):
        row = init_cache(cfg, 1, CTX + FAMILY_NEW, torch.bfloat16, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, ids, row)
        torch.cuda.synchronize()
        join_s.append(time.perf_counter() - t0)
        del row
    tk = CTX * m.top_k
    lp = params["blocks"][cfg.first_k_dense]["moe"]
    xs = torch.randn((tk, cfg.d_model), device="cuda").to(torch.bfloat16)
    gs = torch.bincount(torch.randint(0, m.num_experts, (tk,),
                                      device="cuda"),
                        minlength=m.num_experts)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gemm_ms = _events_ms(torch, lambda: moe.grouped_ffn(lp, xs, gs,
                                                        cfg.mlp_kind), 3)
    peak = torch.cuda.max_memory_allocated() - base
    flops = 2 * 3 * tk * cfg.d_model * m.d_ff_expert
    log(f"[{tag}] one dense join (1 x {CTX} tokens, one-shot prefill): "
        f"{', '.join(f'{x:.3f}' for x in join_s)} s; one layer's exact "
        f"grouped GEMM at {tk} rows: {gemm_ms:.2f} ms, {peak} B of "
        f"intermediates at its peak, {m.num_experts}x the {flops / 1e9:.1f} "
        f"GFLOP the rows need ({smi})")
    del xs, gs, lp, model
    _refuses_paged(torch, tag, cfg, params, g)
    del params
    _free(torch)
    # streamed: the prefix and 8 MoE layers
    cfg9 = dataclasses.replace(cfg, num_layers=DEEPSEEK_STREAMED_DEPTH)
    params = _family_init(torch, cfg9, 0, torch.bfloat16, "cuda")
    log(f"[{tag}] streamed at {cfg9.num_layers} layers: "
        f"{cfg9.weight_bytes()} B of weights")
    prompts = [r.prompt for r in run["reqs"][:STREAMED_REQ]]
    counts.append(_streamed_pass(torch, f"{tag} streamed", cfg9, params,
                                 prompts, STREAMED_NEW,
                                 DEEPSEEK_STREAMED_KERNELS, smi))
    del params
    _free(torch)
    log(f"[{tag}] the phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


def phase_serve_mamba2(torch, store, queries, exact, smi):
    """mamba2-370m at full width and depth (48 SSD layers, seeded bf16
    weights) behind ``RagdollEngine``: the whole-batch ``Generator`` and
    the dense ``ContinuousGenerator`` serve 8 requests of 16 tokens at ctx
    1024, the continuous tokens held to the whole-batch ones but at
    fp32-witnessed near ties; one profiled decode step; ``paged=True``
    raises; then streamed at 8 layers.  Returns each run's launch
    counts."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.serving import ContinuousGenerator, Generator
    from repro_torch.serving import GeneratorConfig
    t_phase = time.perf_counter()
    tag = "serve-mamba2"
    cfg = get_config(MAMBA2)
    params = _family_init(torch, cfg, 0, torch.bfloat16, "cuda")
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"[{tag}] {cfg.num_layers} SSD layers, d_model {cfg.d_model}, "
        f"d_inner {cfg.ssm.d_inner(cfg.d_model)}, state {cfg.ssm.d_state}, "
        f"chunk {cfg.ssm.chunk_size}; {nbytes} B of weights; "
        f"{cfg.ssm_state_bytes()} B of state a sequence")
    g = GeneratorConfig(ctx_len=CTX, max_new_tokens=FAMILY_NEW,
                        dtype=torch.bfloat16)
    rids = list(range(FAMILY_REQ))
    counts = []
    wb = _serve_few(torch, _family_engine(
        store, queries, Generator(cfg, params, g, device="cuda")),
        f"{tag} whole-batch", rids, FAMILY_NEW, MAMBA2_KERNELS, exact, smi,
        cfg.vocab_size)
    counts.append(wb["counts"])
    run = _serve_few(torch, _family_engine(
        store, queries, ContinuousGenerator(cfg, params, g, num_slots=SLOTS,
                                            device="cuda")),
        f"{tag} dense continuous", rids, FAMILY_NEW, MAMBA2_KERNELS, exact,
        smi, cfg.vocab_size)
    counts.append(run["counts"])
    _hold_tokens(torch, tag, cfg, params, run["reqs"], wb["outputs"], smi,
                 ctx=CTX, what="the whole-batch Generator")
    _free(torch)
    _profile_dense_step(torch, tag, cfg, params, smi)
    _refuses_paged(torch, tag, cfg, params, g)
    # streamed: the first layers, cut for time (the path is the same at
    # any depth)
    prompts = [r.prompt for r in run["reqs"][:STREAMED_REQ]]
    cut = dataclasses.replace(cfg, num_layers=MAMBA2_STREAMED_DEPTH)
    counts.append(_streamed_pass(
        torch, f"{tag} streamed", cut,
        dict(params, blocks=params["blocks"][:cut.num_layers]), prompts,
        STREAMED_NEW, MAMBA2_STREAMED_KERNELS, smi))
    del params
    _free(torch)
    log(f"[{tag}] the phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


def phase_serve_jamba(torch, store, queries, exact, smi):
    """jamba-1.5-large-398b at full width and depth 4 (its four layer
    kinds: Mamba + dense, Mamba + MoE of 16 experts top 2 of 24576, Mamba +
    dense, attention (64/8 heads x 128, RoPE) + MoE; 45.95 GB of seeded
    bf16 weights built on the card; one 8-layer block, 90.26 GB, does not
    fit) behind ``RagdollEngine``, 8 requests of 16 tokens at ctx 1024 on
    the shared store: (a) the whole-batch ``Generator`` (its prefills of
    4 or more requests take the capacity path: the drops are printed); (b)
    the dense ``ContinuousGenerator`` (a join: 2048 rows, the exact path),
    held to the whole-batch ``Generator`` run a request at a time but at
    near ties witnessed in fp32 (``_fp32_row``: a layer at a time, a MoE
    layer an expert at a time, since one MoE layer in fp32 is 40.3 GB);
    ``paged=True`` raises; one profiled decode step; one 1024-token join
    timed, with its peak memory.  Then streamed at depth 4 through a ring
    of 2 slots of the largest layer (``max_depth=1``), the card's copy of
    the layers dropped once the executor has pinned its own: 2 requests x
    4 tokens equal to the resident run's.  Returns each run's launch
    counts."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.prefetch import PrefetchPolicy
    from repro_torch.models import moe
    from repro_torch.models.model import Model, init_cache
    from repro_torch.serving import ContinuousGenerator, Generator
    from repro_torch.serving import GeneratorConfig
    tag = "serve-jamba"
    log(f"[{tag}] host MemAvailable at the start: {_mem_available()} B")
    cfg = dataclasses.replace(get_config(JAMBA), num_layers=JAMBA_DEPTH)
    t0 = time.perf_counter()
    params = _family_init(torch, cfg, 0, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    per_layer = [sum(t.numel() * t.element_size() for t in _leaves(lp))
                 for lp in params["blocks"]]
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    m = cfg.moe
    log(f"[{tag}] {cfg.num_layers} layers {list(cfg.layer_kinds())}, "
        f"d_model {cfg.d_model}, attention {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads x {cfg.resolved_head_dim}, SSD d_inner "
        f"{cfg.ssm.d_inner(cfg.d_model)} ({cfg.ssm.num_heads(cfg.d_model)} "
        f"heads of {cfg.ssm.head_dim}), MoE {m.num_experts} experts top "
        f"{m.top_k} of {m.d_ff_expert}; {nbytes} B of bf16 weights (layers "
        f"{per_layer}) in {time.perf_counter() - t0:.1f} s")
    g = GeneratorConfig(ctx_len=CTX, max_new_tokens=FAMILY_NEW,
                        dtype=torch.bfloat16)
    rids = list(range(FAMILY_REQ))
    counts = []
    # (a) whole-batch: the capacity path's drops
    with _recording_drops() as drops:
        wb = _serve_few(torch, _family_engine(
            store, queries, Generator(cfg, params, g, device="cuda")),
            f"{tag} whole-batch", rids, FAMILY_NEW, WHOLE_BATCH_KERNELS,
            exact, smi, cfg.vocab_size)
    counts.append(wb["counts"])
    _free(torch)
    n_moe = sum(f == "moe" for _, f in cfg.layer_kinds())
    log(f"[{tag}] the engine's whole-batch prefills on the capacity path: "
        + (", ".join(f"{d} of {n} rows" for d, n in drops) or "none (its "
           "batches held 3 requests or fewer: the exact path)")
        + f" ({n_moe} MoE layers a prefill; {smi})")
    # the 8 prompts in one whole-batch prefill: 16384 rows a MoE layer,
    # the capacity path
    prompts = [r.prompt for r in wb["reqs"]]
    with _recording_drops() as drops:
        t0 = time.perf_counter()
        Generator(cfg, params, dataclasses.replace(g, max_new_tokens=1),
                  device="cuda").generate(prompts)
        torch.cuda.synchronize()
        t_pf = time.perf_counter() - t0
    if len(drops) != n_moe:
        fail(f"[{tag}] a prefill of {len(prompts)} x {CTX} tokens took the "
             f"capacity path in {len(drops)} of {n_moe} MoE layers")
    log(f"[{tag}] one whole-batch prefill of {len(prompts)} x {CTX} tokens "
        f"({drops[0][1]} rows a MoE layer, capacity "
        f"{moe.capacity(drops[0][1], m.num_experts)} an expert) dropped "
        f"{sum(d for d, _ in drops)} of {sum(n for _, n in drops)} rows "
        f"({', '.join(str(d) for d, _ in drops)} by layer) in {t_pf:.3f} s "
        f"({smi})")
    _free(torch)
    # (b) the dense continuous path
    run = _serve_few(torch, _family_engine(
        store, queries, ContinuousGenerator(cfg, params, g, num_slots=SLOTS,
                                            device="cuda")),
        f"{tag} dense continuous", rids, FAMILY_NEW, WHOLE_BATCH_KERNELS,
        exact, smi, cfg.vocab_size)
    counts.append(run["counts"])
    _free(torch)
    same = sum(wb["outputs"][r] == run["outputs"][r] for r in rids)
    log(f"[{tag}] information only: {same}/{len(rids)} requests got the same "
        f"tokens from the whole-batch path and the dense continuous path")
    t0 = time.perf_counter()
    one = Generator(cfg, params, g, device="cuda")
    alone = {r.rid: one.generate([r.prompt])[0] for r in run["reqs"]}
    del one
    log(f"[{tag}] the whole-batch Generator a request at a time: "
        f"{time.perf_counter() - t0:.2f} s for {len(rids)}")
    _hold_tokens(torch, tag, cfg, params, run["reqs"], alone, smi, ctx=CTX,
                 what="the whole-batch Generator a request at a time",
                 layerwise=True)
    _free(torch)
    _refuses_paged(torch, tag, cfg, params, g)
    _profile_dense_step(torch, tag, cfg, params, smi)
    # one dense join: a 1024-token one-shot prefill at batch 1 (2048 rows
    # a MoE layer on the exact path)
    model = Model(cfg, device="cuda")
    ids = torch.randint(2, cfg.vocab_size, (1, CTX), device="cuda",
                        dtype=torch.int32)
    join_s, peaks = [], []
    for _ in range(3):
        row = init_cache(cfg, 1, CTX + FAMILY_NEW, torch.bfloat16, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        model.prefill(params, ids, row)
        torch.cuda.synchronize()
        join_s.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated() - base)
        del row
    log(f"[{tag}] one dense join (1 x {CTX} tokens, one-shot prefill): "
        f"{', '.join(f'{x:.3f}' for x in join_s)} s, {max(peaks)} B above "
        f"the weights at its peak ({smi})")
    del model
    _free(torch)
    prompts = [r.prompt for r in run["reqs"][:STREAMED_REQ]]
    counts.append(_streamed_pass(torch, f"{tag} streamed", cfg, params,
                                 prompts, STREAMED_NEW,
                                 JAMBA_STREAMED_KERNELS, smi,
                                 policy=PrefetchPolicy(max_depth=1),
                                 drop=True))
    del params
    _free(torch)
    return counts


def phase_serve_llama70b(torch, store, queries, exact, smi):
    """llama3-70b, the paper's 70B model, at full width and depth 4 (64/8
    heads x 128: G = 8; 11.05 GB of seeded bf16 weights) behind
    ``RagdollEngine``, 8 requests of 16 tokens at ctx 1024: the paged,
    chunk-prefilled ``ContinuousGenerator`` (G = 8 paged decode, chunked
    flash), then the whole-batch ``Generator`` (G = 8 dense decode); the
    paged tokens held to the whole-batch ones but at fp32-witnessed near
    ties, and both paths' logits, fed the whole-batch tokens, held to
    fp32 at every step (``_teacher_forced``).  Returns each run's launch
    counts."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.serving import ContinuousGenerator, Generator
    from repro_torch.serving import GeneratorConfig
    tag = "serve-llama70b"
    cfg = dataclasses.replace(get_config(LLAMA70B), num_layers=LLAMA70B_DEPTH)
    t0 = time.perf_counter()
    params = _family_init(torch, cfg, 0, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"[{tag}] {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads x "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
        f"{nbytes} B of bf16 weights in {time.perf_counter() - t0:.1f} s")
    g = GeneratorConfig(ctx_len=CTX, max_new_tokens=FAMILY_NEW,
                        dtype=torch.bfloat16)
    rids = list(range(FAMILY_REQ))
    run = _serve_few(torch, _family_engine(
        store, queries, ContinuousGenerator(
            cfg, params, g, num_slots=SLOTS, paged=True, page_size=PAGE,
            prefill_chunk=CHUNK, device="cuda")),
        tag, rids, FAMILY_NEW, CONTINUOUS_KERNELS, exact, smi,
        cfg.vocab_size)
    _free(torch)
    wb = _serve_few(torch, _family_engine(
        store, queries, Generator(cfg, params, g, device="cuda")),
        f"{tag} whole-batch", rids, FAMILY_NEW, WHOLE_BATCH_KERNELS, exact,
        smi, cfg.vocab_size)
    _free(torch)
    fp32 = _cast_params(torch, params, torch.float32)
    _hold_tokens(torch, tag, cfg, params, run["reqs"], wb["outputs"], smi,
                 ctx=CTX, what="the whole-batch Generator", fp32=fp32)
    _teacher_forced(torch, tag, cfg, params, fp32, run["reqs"],
                    wb["outputs"], smi)
    del params, fp32
    _free(torch)
    return [run["counts"], wb["counts"]]


def phase_embed_models(torch, smi):
    """The embed frontend at full width, card fp32 logits against the
    port's CPU fp32 logits on the same weights, at ``FAMILY_LOGIT_TOL``:
    seamless-m4t-medium at 2 + 2 layers (the encoder's output over 64
    frames, then the decoder's prefill of 8 tokens and 3 dense decode
    steps fed the CPU run's greedy tokens) and chameleon-34b at 2 layers
    (prefill over 16 embeddings, 3 decode steps over stub embeddings)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.model import Model, init_cache
    n_enc, n_dec, steps, n_cham = 64, 8, 3, 16
    f32 = torch.float32
    for arch in (SEAMLESS, CHAMELEON):
        cfg = dataclasses.replace(get_config(arch),
                                  num_layers=ENCDEC_MODEL_LAYERS)
        if cfg.encdec:
            cfg = dataclasses.replace(
                cfg, num_encoder_layers=ENCDEC_MODEL_LAYERS)
        p_gpu = _family_init(torch, cfg, 5, f32, "cuda")
        p_cpu = _to_dev(p_gpu, "cpu")
        g = torch.Generator().manual_seed(6)
        d = cfg.d_model
        frames = torch.randn((2, n_enc, d), generator=g)
        prompt = (torch.randint(2, cfg.vocab_size, (2, n_dec), generator=g,
                                dtype=torch.int32) if cfg.encdec
                  else torch.randn((2, n_cham, d), generator=g))
        stubs = torch.randn((steps, 2, 1, d), generator=g)
        n = prompt.shape[1]
        runs, fed = {}, None
        for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
            model = Model(cfg, device=dev)
            enc_len = n_enc if cfg.encdec else None
            cache = init_cache(cfg, 2, n + steps, f32, dev, enc_len=enc_len)
            out = []
            if cfg.encdec:
                out.append(transformer.encode(params, cfg,
                                              frames.to(dev)).cpu())
            lg = model.prefill(params, prompt.to(dev), cache,
                               enc_embeds=frames.to(dev) if cfg.encdec
                               else None)
            rows, toks = [lg.cpu()], []
            for t in range(steps):
                if cfg.encdec:
                    cur = (rows[-1].argmax(-1).to(torch.int32)[:, None]
                           if fed is None else fed[t])
                    toks.append(cur)
                else:
                    cur = stubs[t]
                pos = torch.full((2,), n + t, dtype=torch.int32, device=dev)
                rows.append(model.decode(params, cur.to(dev), cache,
                                         pos).cpu())
            fed = fed or toks
            runs[dev] = out + [torch.stack(rows)]
            del cache, model
        errs = [check_close(f"[model] {arch} fp32 {name}", got, want,
                            atol=FAMILY_LOGIT_TOL)
                for name, got, want in zip(
                    ("encoder output", "logits")[-len(runs["cpu"]):],
                    runs["cuda"], runs["cpu"])]
        if not torch.equal(runs["cuda"][-1].argmax(-1),
                           runs["cpu"][-1].argmax(-1)):
            fail(f"[model] {arch}: greedy tokens differ between card and "
                 "CPU")
        what = (f"{cfg.num_encoder_layers} encoder + {cfg.num_layers} "
                f"decoder layers, encoder output over {n_enc} frames max "
                f"err {errs[0]:.3e}, then prefill of {n} tokens" if cfg.encdec
                else f"{cfg.num_layers} layers, no token table: prefill of "
                f"{n} embeddings")
        log(f"[model] {arch} at full width ({cfg.num_heads}/"
            f"{cfg.num_kv_heads} heads x {cfg.resolved_head_dim}, d_model "
            f"{d}), {what} "
            f"+ {steps} dense decode steps: card fp32 vs CPU fp32 max logit "
            f"err {errs[-1]:.3e} (tol {FAMILY_LOGIT_TOL}), greedy tokens "
            f"equal ({smi})")
        del p_gpu, p_cpu, runs
        _free(torch)


def _seamless_tokens(torch, cfg, model, params, frames, prompts, new):
    """Greedy tokens of ``prompts`` (B, P) over ``frames`` (B, S_enc, D)
    through ``Model.prefill(enc_embeds=...)`` and ``new - 1`` dense
    decode steps.  Returns the tokens (B, new) on the host and the ms of
    the prefill (the encoder's included) and of a decode step."""
    from repro_torch.models.model import init_cache
    b, n = prompts.shape
    dt = params["final_norm"].dtype
    cache = init_cache(cfg, b, n + new, dt, "cuda", enc_len=frames.shape[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cur = model.prefill(params, prompts, cache,
                        enc_embeds=frames.to(dt)).argmax(-1)
    torch.cuda.synchronize()
    t_pf = time.perf_counter() - t0
    toks = [cur]
    for t in range(new - 1):
        pos = torch.full((b,), n + t, dtype=torch.int32, device="cuda")
        cur = model.decode(params, cur.to(torch.int32)[:, None], cache,
                           pos).argmax(-1)
        toks.append(cur)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0 - t_pf
    return (torch.stack(toks, 1).cpu(), t_pf * 1e3,
            t_dec / max(new - 1, 1) * 1e3)


def _seamless_row(torch, cfg, model, params, frames, prompt, toks):
    """The logits after ``prompt`` (1, P) and ``toks`` fed a decode step
    each, over ``frames`` (1, S_enc, D), in the weights' dtype."""
    from repro_torch.models.model import init_cache
    dt = params["final_norm"].dtype
    n = prompt.shape[1]
    cache = init_cache(cfg, 1, n + len(toks) + 1, dt, "cuda",
                       enc_len=frames.shape[1])
    lg = model.prefill(params, prompt, cache, enc_embeds=frames.to(dt))
    for i, t in enumerate(toks):
        lg = model.decode(params, torch.tensor([[t]], dtype=torch.int32,
                                               device="cuda"), cache,
                          torch.full((1,), n + i, dtype=torch.int32,
                                     device="cuda"))
    return lg[0].float()


def phase_serve_seamless(torch, smi):
    """seamless-m4t-medium at full width and depth (12 encoder + 12
    decoder layers, 16/16 heads x 64, seeded bf16 weights) through
    ``Model``, the only path the reference serves it on: 8 requests, each
    1024 seeded encoder frames and a 16-token decoder prompt, 32 greedy
    tokens by ``Model.prefill(enc_embeds=...)`` and ``Model.decode``, the
    launch counts set to 0 before the batch and read after (flash, dense
    decode and RMSNorm must launch).  Each request's tokens in the batch
    must equal its tokens run alone, or leave them first at a near tie
    witnessed in fp32 (the two choices' fp32 logits within twice the bf16
    row's largest error).  ``Generator``, ``PagedKVCache`` and
    ``StreamedExecutor`` must refuse it.  Returns the batch's counts."""
    from repro_torch.configs import get_config
    from repro_torch.core.prefetch import PrefetchPolicy, StreamedExecutor
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.models.model import Model, init_cache
    from repro_torch.serving import Generator, GeneratorConfig
    from repro_torch.serving.kvpool import PagedKVCache
    tag = "serve-seamless"
    cfg = get_config(SEAMLESS)
    t0 = time.perf_counter()
    params = _family_init(torch, cfg, 0, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"[{tag}] {cfg.num_encoder_layers} encoder + {cfg.num_layers} "
        f"decoder layers, d_model {cfg.d_model}, {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads x {cfg.resolved_head_dim}, GELU MLP "
        f"{cfg.d_ff}, vocab {cfg.vocab_size} (tied); {nbytes} B of bf16 "
        f"weights in {time.perf_counter() - t0:.1f} s")
    for what, make in (
            ("Generator", lambda: Generator(cfg, params, GeneratorConfig(
                ctx_len=SEAMLESS_PROMPT), device="cuda")),
            ("PagedKVCache", lambda: PagedKVCache(
                cfg, 2, SEAMLESS_PROMPT + SEAMLESS_NEW, PAGE,
                device="cuda")),
            ("StreamedExecutor", lambda: StreamedExecutor(
                cfg, params, PrefetchPolicy(), device="cuda"))):
        try:
            make()
        except NotImplementedError as e:
            log(f"[{tag}] {what} refuses it: {e}")
            continue
        fail(f"[{tag}] {what} took the encoder-decoder")
    model = Model(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    frames = torch.randn((SLOTS, ENC_FRAMES, cfg.d_model), generator=gen,
                         device="cuda").to(torch.bfloat16)
    prompts = torch.randint(2, cfg.vocab_size, (SLOTS, SEAMLESS_PROMPT),
                            generator=gen, device="cuda", dtype=torch.int32)
    # a warm-up at the batch's shapes (the libraries' first calls)
    _seamless_tokens(torch, cfg, model, params, frames, prompts, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    transformer.encode(params, cfg, frames)
    torch.cuda.synchronize()
    enc_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    batch, pf_ms, step_ms = _seamless_tokens(torch, cfg, model, params,
                                             frames, prompts, SEAMLESS_NEW)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k in EMBED_KERNELS if counts[k] == 0]
    if missing:
        fail(f"[{tag}] kernels never launched on this path: {missing}")
    cross = (cfg.num_layers * 2 * SLOTS * ENC_FRAMES * cfg.num_kv_heads
             * cfg.resolved_head_dim * 2)
    log(f"[{tag}] {SLOTS} requests x {ENC_FRAMES} frames, "
        f"{SEAMLESS_PROMPT}-token prompts, {SEAMLESS_NEW} greedy tokens: "
        f"encode {enc_ms:.2f} ms, prefill {pf_ms:.2f} ms (the encoder "
        f"included), decode step {step_ms:.2f} ms, "
        f"{SLOTS * SEAMLESS_NEW / wall:.1f} tokens/s; cross K/V cache "
        f"{cross} B; peak device memory {peak / 2 ** 30:.2f} GiB ({smi})")
    log(f"[{tag}] launches on this path: {json.dumps(counts)}")
    if not bool((batch >= 0).all() and (batch < cfg.vocab_size).all()):
        fail(f"[{tag}] tokens out of the vocabulary")
    cache = init_cache(cfg, SLOTS, SEAMLESS_PROMPT + SEAMLESS_NEW,
                       torch.bfloat16, "cuda", enc_len=ENC_FRAMES)
    profile_decode_step(torch, tag, model, params, cache, None, None, smi,
                        at=SEAMLESS_PROMPT)
    del cache
    fp32, ties = None, 0
    for i in range(SLOTS):
        alone = _seamless_tokens(torch, cfg, model, params,
                                 frames[i:i + 1], prompts[i:i + 1],
                                 SEAMLESS_NEW)[0][0].tolist()
        got = batch[i].tolist()
        if got == alone:
            continue
        if fp32 is None:
            fp32 = _cast_params(torch, params, torch.float32)
        t = next(j for j, (a, b) in enumerate(zip(alone, got)) if a != b)
        rows = {name: _seamless_row(torch, cfg, model, p, frames[i:i + 1],
                                    prompts[i:i + 1], alone[:t])
                for name, p in (("bf16", params), ("fp32", fp32))}
        gap = float(rows["fp32"][alone[t]] - rows["fp32"][got[t]])
        err = float((rows["bf16"] - rows["fp32"]).abs().max())
        msg = (f"[{tag}] request {i}: first other token at {t}, {got[t]} "
               f"for {alone[t]} alone; fp32 logit gap {gap:.6f}, bf16 "
               f"logits off fp32 by up to {err:.6f} in that row")
        if abs(gap) > 2 * err:
            fail(f"{msg}: not a near tie")
        log(f"{msg}: a near tie ({smi})")
        ties += 1
    log(f"[{tag}] {SLOTS} requests: each one's tokens run alone, but for "
        f"{ties} that leave them at an fp32-witnessed near tie")
    del params, fp32, model, frames
    _free(torch)
    return [counts]


def _sequence_logits(torch, cfg, params, x, first, dtype):
    """Logits at positions ``first..S-1`` of the embeddings ``x`` (B, S,
    D): one cacheless causal pass (``mode="encode"``, ``causal=True``: the
    prefill's function without a cache), each layer's weights cast to
    ``dtype`` only while it runs, as ``_fp32_row`` casts them.  Returns
    (B, S - first, V) in fp32."""
    from repro_torch.models import transformer
    top = _cast_params(torch, {k: v for k, v in params.items()
                               if k != "blocks"}, dtype)
    x, delta = x.to(dtype), None
    for lp, kind in zip(params["blocks"], cfg.layer_kinds()):
        x, delta = transformer.apply_layer(
            _cast_params(torch, lp, dtype), x, delta, cfg, kind,
            mode="encode", cache=None, pos=None, block_tab=None,
            kv_span=None, causal=True)
    x = transformer._final_norm(top, cfg, x[:, first:], delta[:, first:])
    return transformer.unembed(top, cfg, x).float()


def phase_serve_chameleon(torch, smi):
    """chameleon-34b at full width and depth (48 layers, 64/8 heads x 128,
    SwiGLU 22016, vocab 65536; no token table: 33.76 B parameters, 67.5
    GB of bf16 weights seeded on the card after every earlier family is
    freed) through ``Model``: 8 prompts of 1024 seeded embeddings, then 16
    decode steps over seeded stub embeddings, the launch counts set to 0
    before and read after.  At every step the bf16 logits of 2 rows must
    lie within twice the bf16 one-shot prefill's own error of an fp32
    recomputation of the whole sequence (both a layer at a time) at the
    same positions.  Then the first 8 layers alone, resident and streamed
    (``StreamedExecutor``, the layers in pinned host memory; cut for host
    memory and time): 2 rows x 4 steps, the streamed logits equal to the
    resident ones, flash, dense decode and RMSNorm launched in the
    streamed run.  Returns the counts of the resident and streamed
    runs."""
    import dataclasses
    import gc
    from repro_torch.configs import get_config
    from repro_torch.core.prefetch import PrefetchPolicy, StreamedExecutor
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model, init_cache
    tag = "serve-chameleon"
    _free(torch)
    log(f"[{tag}] before seeding: {torch.cuda.memory_allocated()} B "
        f"allocated, {torch.cuda.memory_reserved()} B reserved on the card")
    cfg = get_config(CHAMELEON)
    t0 = time.perf_counter()
    params = _family_init(torch, cfg, 0, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"[{tag}] {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads x "
        f"{cfg.resolved_head_dim}, SwiGLU {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, no token table ({sorted(params)}); {nbytes} B "
        f"of bf16 weights seeded in {time.perf_counter() - t0:.1f} s")
    model = Model(cfg, device="cuda")
    d, n = cfg.d_model, CTX
    gen = torch.Generator(device="cuda").manual_seed(13)
    prompts = torch.randn((SLOTS, n, d), generator=gen,
                          device="cuda").to(torch.bfloat16)
    stubs = torch.randn((CHAMELEON_STEPS, SLOTS, 1, d), generator=gen,
                        device="cuda").to(torch.bfloat16)
    cache = init_cache(cfg, SLOTS, n + CHAMELEON_STEPS, torch.bfloat16,
                       "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rows = [model.prefill(params, prompts, cache)]
    torch.cuda.synchronize()
    t_pf = time.perf_counter() - t0
    for t in range(CHAMELEON_STEPS):
        pos = torch.full((SLOTS,), n + t, dtype=torch.int32, device="cuda")
        rows.append(model.decode(params, stubs[t], cache, pos))
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0 - t_pf
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k in EMBED_KERNELS if counts[k] == 0]
    if missing:
        fail(f"[{tag}] kernels never launched on this path: {missing}")
    served = torch.stack(rows, 1).float()          # (B, 1 + steps, V)
    if not bool(served.isfinite().all()):
        fail(f"[{tag}] logits not finite")
    step_ms = t_dec / CHAMELEON_STEPS * 1e3
    kv = sum(t.numel() * t.element_size() for c in cache["blocks"]
             for t in c.values())
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"[{tag}] {SLOTS} prompts of {n} embeddings: prefill {t_pf:.3f} s "
        f"({SLOTS * n / t_pf:.0f} tokens/s); {CHAMELEON_STEPS} decode steps "
        f"over stub embeddings, {step_ms:.2f} ms a step "
        f"({SLOTS / (step_ms / 1e3):.1f} tokens/s) against the weights' "
        f"byte bound of {bound:.2f} ms ({nbytes} B at {HBM_BYTES_PER_S:.3g} "
        f"B/s; the {kv} B KV cache besides); peak device memory {peak} B "
        f"({smi})")
    log(f"[{tag}] launches on this path: {json.dumps(counts)}")
    profile_decode_step(torch, tag, model, params, cache, None, None, smi,
                        cur=stubs[-1], at=n + CHAMELEON_STEPS - 1)
    del cache, rows
    _free(torch)
    # every step of 2 rows held to fp32: the whole sequence (prompt, then
    # the stub embeddings the steps fed) a layer at a time, in fp32 and in
    # bf16 (one-shot), logits at the served positions n - 1 .. n + steps - 1
    w = list(CHAMELEON_WITNESS)
    seq = torch.cat([prompts[w], stubs[:, w, 0].transpose(0, 1)], 1)
    with torch.no_grad():
        f32 = _sequence_logits(torch, cfg, params, seq, n - 1,
                               torch.float32)
        one = _sequence_logits(torch, cfg, params, seq, n - 1,
                               torch.bfloat16)
    e_one = (one - f32).abs().amax(-1)              # (2, 1 + steps)
    e_srv = (served[w] - f32).abs().amax(-1)
    ratio = e_srv / e_one.clamp(min=1e-12)
    worst = divmod(int(ratio.argmax()), ratio.shape[1])
    if bool((e_srv > 2 * e_one).any()):
        r, p = divmod(int((e_srv - 2 * e_one).argmax()), ratio.shape[1])
        fail(f"[{tag}] row {w[r]} at position {n - 1 + p}: the served "
             f"logits off fp32 by {float(e_srv[r, p]):.6f}, past twice the "
             f"bf16 one-shot prefill's {float(e_one[r, p]):.6f}")
    log(f"[{tag}] rows {w}, the prefill and all {CHAMELEON_STEPS} steps: "
        f"the served bf16 logits within twice the bf16 one-shot prefill's "
        f"error of fp32 (both a layer at a time) at every position; served "
        f"off fp32 by {float(e_srv.min()):.4f}-{float(e_srv.max()):.4f}, "
        f"one-shot by {float(e_one.min()):.4f}-{float(e_one.max()):.4f}; "
        f"the closest, {float(ratio.max()):.3f} of it, at row "
        f"{w[worst[0]]} position {n - 1 + worst[1]} ({smi})")
    del f32, one, served
    # the first 8 layers, resident then streamed, on 2 rows
    depth = CHAMELEON_STREAMED_DEPTH
    del params["blocks"][depth:]
    gc.collect()
    _free(torch)
    cut = dataclasses.replace(cfg, num_layers=depth)
    b, steps = 2, CHAMELEON_STREAMED_STEPS

    def passes(prefill, decode, cache):
        out = [prefill(prompts[:b], cache)]
        for t in range(steps):
            pos = torch.full((b,), n + t, dtype=torch.int32, device="cuda")
            out.append(decode(stubs[t, :b], cache, pos))
        torch.cuda.synchronize()
        return out

    short = Model(cut, device="cuda")
    want = passes(lambda x, c: short.prefill(params, x, c),
                  lambda x, c, p: short.decode(params, x, c, p),
                  init_cache(cut, b, n + steps, torch.bfloat16, "cuda"))
    t0 = time.perf_counter()
    ex = StreamedExecutor(cut, params, PrefetchPolicy(), device="cuda")
    t_pin = time.perf_counter() - t0
    log(f"[{tag} streamed] {depth} layers, {ex.streamed_bytes} B pinned in "
        f"{t_pin:.1f} s; host MemAvailable after the pinning "
        f"{_mem_available()} B; {ex.ring_slots} ring slots of "
        f"{ex.slot_bytes} B")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = passes(ex.prefill, ex.decode,
                 ex.init_caches(b, n + steps, torch.bfloat16))
    t_run = time.perf_counter() - t0
    streamed = ops.launch_counts()
    if not all(torch.equal(a, c) for a, c in zip(got, want)):
        fail(f"[{tag} streamed] logits differ from the resident run's at "
             f"depth {depth}")
    missing = [k for k in EMBED_KERNELS if streamed[k] == 0]
    if missing:
        fail(f"[{tag} streamed] kernels never launched on the streamed "
             f"path: {missing}")
    log(f"[{tag} streamed] {b} prompts of {n} embeddings + {steps} steps "
        f"in {t_run:.2f} s ({ex.passes} passes, {ex.staged_bytes} B "
        f"staged): logits equal to the resident run's at depth {depth} "
        f"({smi})")
    log(f"[{tag} streamed] streamed launches: {json.dumps(streamed)}")
    del ex, params, model, prompts, stubs, want, got
    gc.collect()
    _free(torch)
    return [counts, streamed]


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


def check_requests(torch, tag, reqs, exact, vocab, n=N_REQ,
                   max_new=MAX_NEW) -> None:
    """Fails unless all ``n`` requests came back, each with ``max_new``
    tokens and the exact top-5 of the full corpus."""
    if len(reqs) != n:
        fail(f"[{tag}] {len(reqs)} of {n} requests came back")
    ex_s, ex_i = exact
    for r in reqs:
        qi = int(r.query[1:])            # QueryEmbedder: "q<i>" -> query i
        toks = r.output.split()
        if len(toks) != max_new or not all(
                0 <= int(t[3:]) < vocab for t in toks):
            fail(f"[{tag}] request {r.rid}: {len(toks)} tokens, want "
                 f"{max_new}")
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


def _submit_and_drain(eng, rids, t_limit, tag, errors, query_of=None,
                      max_new=MAX_NEW, total=None):
    """Submit requests ``rids`` (request ``i`` asks ``q<query_of(i)>``,
    default ``q<i>``) to a started engine and wait until it has completed
    ``total`` requests (default ``rids[-1] + 1``: the rids so far); fails
    as soon as a worker thread has died."""
    from repro_torch.serving import Request
    for i in rids:
        qi = i if query_of is None else query_of(i)
        eng.submit(Request(rid=i, query=f"q{qi}", arrival=time.perf_counter(),
                           top_k=TOP_K, max_new_tokens=max_new))
    deadline = time.monotonic() + t_limit
    while True:
        try:
            return eng.drain(rids[-1] + 1 if total is None else total,
                             timeout=5.0)
        except TimeoutError:
            if errors:
                fail(f"[{tag}] worker thread died: {errors}")
            if time.monotonic() > deadline:
                raise


def serve_path(torch, eng, tag, kernels, exact, smi, vocab, *,
               stats=None, step_hist=None, layers=None, executor=None,
               profile=True, warmup=True, n_req=N_REQ):
    """Warm up (``warmup``), serve the ``n_req`` measured requests (rids
    ``WARMUP_REQ`` on) with the launch counts set to 0 just before and read
    just after, then (``profile``) a profiled batch.
    Fails unless every request has ``MAX_NEW`` tokens and the exact top-5
    and every kernel in ``kernels`` launched.  ``layers``: a whole-batch
    path, whose prefill batches are its flash launches over the layers.
    ``executor``: a streamed generator's, whose passes and staged bytes in
    the measured run are printed.  Returns the measured run's numbers."""
    from repro_torch.kernels import ops
    from repro_torch.serving import percentile
    errors = _watch_threads()
    submitted = 0

    def serve(rids, t_limit):
        nonlocal submitted
        submitted += len(rids)
        return _submit_and_drain(eng, rids, t_limit, tag, errors,
                                 total=submitted)

    eng.start()
    try:
        if warmup:
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
        done = serve(list(range(WARMUP_REQ, WARMUP_REQ + n_req)), 600)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        retrieval = stats.snapshot() if stats is not None else None
        if executor is not None:
            passes = executor.passes - passes0
            staged = executor.staged_bytes - staged0
        first = WARMUP_REQ + n_req
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
    check_requests(torch, tag, reqs, exact, vocab, n=n_req)
    missing = [n for n in kernels if counts[n] == 0]
    if missing:
        fail(f"[{tag}] kernels never launched on this path: {missing}")
    lat = [r.latency for r in reqs]
    p50, p95 = percentile(lat, 50), percentile(lat, 95)
    toks = n_req * MAX_NEW
    log(f"[{tag}] {n_req}/{n_req} requests served, {MAX_NEW} tokens and "
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
        log(f"[{tag}] retrieval of the {n_req} requests: {retrieval}")
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
    from collections import Counter
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import layers
    cur = torch.zeros((SLOTS, 1), dtype=torch.int32, device="cuda")
    pos = torch.full((SLOTS,), CTX, dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()
    device = torch.autograd.DeviceType.CUDA
    pad = 256           # empty launches before and after a profiled step

    def step():
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            model.decode(params, cur, cache, pos, block_tab, kv_span=span)
        torch.cuda.synchronize()

    def count() -> int:
        """The kernel count of a step: the most that any of five profiled
        steps reads.  The step runs on a stream of its own and a trace
        records every thread's work, so only the stream that holds most of
        a trace's kernels counts; the kernels on other streams, and those
        that differ between traces, are logged by name.  A trace loses
        records but gains none: after the serving runs, most traces of a
        step lacked the same 25-32 of its kernels, its last ones, and some
        its first 3, while every trace of a fresh process read all of
        them, each with its own correlation id and host launch.  So
        ``pad`` empty launches on the default stream come before and after
        the step in each trace, to be its first and last records; a trace
        short of them is logged."""

        def empty():
            for _ in range(pad):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()

        step()
        counts, named, held = [], [], []
        for _ in range(5):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                empty()
                step()
                empty()
            streams = {}
            for e in prof.profiler.kineto_results.events():
                if (e.device_type() == device
                        and not e.name().startswith(("Memcpy", "Memset"))):
                    streams.setdefault(e.device_resource_id(), []).append(
                        e.name()[:80])
            own = max(streams, key=lambda sid: len(streams[sid]))
            other = Counter(n for sid, names in streams.items()
                            if sid != own for n in names)
            held.append(sum(v for n, v in other.items()
                            if "spin_kernel" in n))
            other = Counter({n: v for n, v in other.items()
                             if "spin_kernel" not in n})
            if other:
                log(f"[{tag}] left out of a step's count: "
                    f"{sum(other.values())} kernels on other streams than "
                    f"the step's {own}: {dict(other.most_common(5))}")
            counts.append(len(streams[own]))
            named.append(Counter(streams[own]))
        if any(h != 2 * pad for h in held):
            log(f"[{tag}] the traces hold {held} of the {2 * pad} empty "
                f"launches around the step")
        hi, lo = counts.index(max(counts)), counts.index(min(counts))
        if counts[hi] != counts[lo]:
            log(f"[{tag}] a step's kernel counts differ between traces "
                f"{counts}: the largest has "
                f"{dict((named[hi] - named[lo]).most_common(5))} more and "
                f"{dict((named[lo] - named[hi]).most_common(5))} fewer")
        return max(counts)

    add_rms_norm = layers.add_rms_norm

    def unfused(x, r, w, eps):
        s = x + r
        return s, layers.rms_norm(s, w, eps)

    saved = 2 * model.cfg.num_layers      # every norm but layer 0's norm1
    fused = count()
    layers.add_rms_norm = unfused
    try:
        apart = count()
    finally:
        layers.add_rms_norm = add_rms_norm
    log(f"[{tag}] one decode step ({SLOTS} slots): {fused} device "
        f"kernels; {apart} with each residual add a launch of its own: "
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
                    _pump(eng, list(range(N_REQ, N_REQ + SWAP_PROFILE_REQ)))
                    torch.cuda.synchronize()
                    window = time.perf_counter() - t0
                log(f"[profile serve-swap] stopping the profiler took "
                    f"{time.perf_counter() - t0 - window:.2f} s more")
                recs = _kernel_records(prof, torch)
                busy = breakdown("serve-swap", recs, window, smi,
                                 what=f"{SWAP_PROFILE_REQ} requests")
                # the int8 chunked prefill's fp32 attention, by name
                f32 = sum(d for n, _, d in recs if "flash_tf32_" in n) / 1e6
                if not any("flash_tf32_kernel" in n for n, _, _ in recs):
                    fail("[serve-swap] the profiled batch launched no "
                         "flash_tf32_kernel (the int8 chunked prefill's "
                         "fp32 attention)")
                log(f"[profile serve-swap] fp32 flash (flash_tf32_kernel "
                    f"+ its merge): {f32:.4f} s, "
                    f"{f32 / busy if busy else 0.0:.1%} of the device's "
                    "busy time (the SIMT kernel's share before it, 8 "
                    f"requests: 20.7 %) ({smi})")
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


def _expertwise_ffn(torch, grouped):
    """``moe.grouped_ffn`` for fp32 rows against bf16 expert stacks: each
    expert's three matrices cast to fp32 only while its rows run (2.4 GB
    at jamba's 8192 x 24576, where a layer's 16 are 40.3 GB), every row
    through its expert in fp32, as the exact path in fp32 computes it.
    Other calls go to ``grouped``."""
    from repro_torch.models import moe

    def run(p, xs, gs, kind, impl="auto"):
        if xs.dtype != torch.float32 or p["w_gate"].dtype == torch.float32:
            return grouped(p, xs, gs, kind, impl)
        out = torch.zeros(xs.shape, dtype=torch.float32, device=xs.device)
        start = 0
        for e, n in enumerate(gs.tolist()):
            if n:
                r = xs[start:start + n]
                h = (moe._act(r @ p["w_gate"][e].float(), kind)
                     * (r @ p["w_up"][e].float()))
                out[start:start + n] = h @ p["w_down"][e].float()
                start += n
        return out
    return run


def _fp32_layer(torch, lp):
    """A layer's weights in fp32 but expert stacks of more than
    ``EXPERTWISE_BYTES`` in fp32, which stay as they are for
    ``_expertwise_ffn``."""
    out = {}
    for k, v in lp.items():
        if k == "moe" and 4 * sum(v[n].numel()
                                  for n in EXPERT_STACKS) > EXPERTWISE_BYTES:
            out[k] = {n: (t if n in EXPERT_STACKS
                          else _cast_params(torch, t, torch.float32))
                      for n, t in v.items()}
        else:
            out[k] = _cast_params(torch, v, torch.float32)
    return out


def _fp32_row(torch, cfg, params, ids, ctx):
    """The fp32 function of a model whose fp32 copy does not fit beside
    its bf16 one (deepseek-v2-lite: 63 GB; jamba at depth 4: 92 GB), each
    layer's weights cast to fp32 only while it runs (``_fp32_layer``; a
    large MoE layer an expert at a time): one-shot prefill of ``ids``, or,
    where Mamba layers take only whole chunks, of ``ids[:, :ctx]`` and a
    decode step for each later token, as the serving paths take them.
    Returns the last position's logits."""
    from repro_torch.models import moe, transformer
    from repro_torch.models.model import init_cache
    f32 = torch.float32
    top = _cast_params(torch, {k: v for k, v in params.items()
                               if k != "blocks"}, f32)
    cache = init_cache(cfg, 1, ids.shape[1], f32, "cuda")

    def run(x_ids, mode, pos):
        """The logits of the last of ``x_ids`` (1, n)."""
        x, delta = transformer._embed_inputs(top, cfg, x_ids), None
        for lp, kind, c in zip(params["blocks"], cfg.layer_kinds(),
                               cache["blocks"]):
            x, delta = transformer.apply_layer(
                _fp32_layer(torch, lp), x, delta, cfg, kind, mode=mode,
                cache=c, pos=pos, block_tab=None, kv_span=None)
        x = transformer._final_norm(top, cfg, x[:, -1:], delta[:, -1:])
        return transformer.unembed(top, cfg, x)[0, 0].float()

    grouped = moe.grouped_ffn
    moe.grouped_ffn = _expertwise_ffn(torch, grouped)
    try:
        if all(m != "mamba" for m, _ in cfg.layer_kinds()):
            return run(ids, "prefill", None)    # one pass: the same function
        row = run(ids[:, :ctx], "prefill", None)
        for i in range(ctx, ids.shape[1]):
            row = run(ids[:, i:i + 1], "decode",
                      torch.full((1,), i, dtype=torch.int32, device="cuda"))
    finally:
        moe.grouped_ffn = grouped
    return row


def _near_tie(torch, cfg, params, fp32, req, got: str, ctx=PREFIX_CTX):
    """Where ``got`` first leaves ``req``'s tokens (run 1's): the prompt
    goes through one-shot prefill and run 1's tokens before that point a
    decode step each, as the serving paths take them, with the bf16
    weights and with ``fp32``, their cast (None: the fp32 row by
    ``_fp32_row``, a layer at a time).  Returns (position, run 1's
    token, the other token, their fp32 logit gap, the largest bf16-fp32
    logit difference of that row)."""
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
            if p is None:
                rows[name] = _fp32_row(torch, cfg, params, ids, ctx)
                continue
            cache = init_cache(cfg, 1, ids.shape[1], p["embed"].dtype,
                               "cuda")
            lg = model.prefill(p, ids[:, :ctx], cache)
            for i in range(t):
                lg = model.decode(p, ids[:, ctx + i:ctx + i + 1], cache,
                                  torch.full((1,), ctx + i, dtype=torch.int32,
                                             device="cuda"))
            rows[name] = lg[0].float()
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
    ``Generator`` on 8 of serve's prompts gives the resident one's
    ``STREAMED_BATCH_NEW`` tokens exactly; (b) the streamed paged,
    chunk-prefilled continuous generator behind a threaded
    ``RagdollEngine`` serves ``STREAMED_REQS`` of serve's requests, with
    no warm-up, with
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
        gen.exec.reserve()            # the ring, which the first pass takes
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
    g_a = GeneratorConfig(ctx_len=CTX, max_new_tokens=STREAMED_BATCH_NEW,
                          dtype=torch.bfloat16)
    gen = build(lambda: Generator(cfg, params, g_a, streamed=True,
                                  policy=policy, device="cuda"))
    t0 = time.perf_counter()
    got = gen.generate(prompts)
    torch.cuda.synchronize()
    t_streamed = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = Generator(cfg, params, g_a, device="cuda").generate(prompts)
    torch.cuda.synchronize()
    t_resident = time.perf_counter() - t0
    same = sum(a == b for a, b in zip(got, want))
    log(f"[serve-streamed batch] {len(prompts)} prompts, "
        f"{STREAMED_BATCH_NEW} tokens "
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
                     executor=ex, profile=False, warmup=False,
                     n_req=STREAMED_REQS)
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
    n = len(out["outputs"])
    log(f"[serve-streamed] {n}/{n} requests: serve's {MAX_NEW} "
        f"tokens, but for {ties} that leave them at a near tie")

    # one layer's pinned copy, and decode passes against their copy bound
    cur = torch.zeros((SLOTS, 1), dtype=torch.int32, device="cuda")
    pos = torch.full((SLOTS,), CTX, dtype=torch.int32, device="cuda")
    tab = gen.kv.device_tab()            # drained: every row all trash

    def decode_pass():
        ex.decode(cur, gen.cache, pos, block_tab=tab, kv_span=gen._total)

    nbytes, copy_ms, rate, pass_s, bound_s = _copy_bound(torch, ex,
                                                         decode_pass)
    depth = policy.depth("decode", ex.free_bytes, ex.layer_bytes)
    log(f"[serve-streamed] one {nbytes} B layer pinned host to device: "
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
    del gen, eng, ex
    gc.collect()
    return out["counts"]


def _copy_bound(torch, ex, decode_pass):
    """The executor's largest layer copied pinned host to device (5 copies
    timed with events) and ``decode_pass`` (the mean of 3 after one):
    (that layer's bytes, its copy ms, the copy rate in B/s, the pass s,
    the pass's copy bound: every streamed byte at that rate)."""
    torch.cuda.synchronize()
    host = max(ex._host, key=lambda t: t.numel())
    slot = ex._ring[0, :host.numel()]
    copy_ms = _events_ms(torch, lambda: slot.copy_(host, non_blocking=True),
                         5)
    rate = host.numel() / (copy_ms / 1e3)
    decode_pass()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        decode_pass()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return (host.numel(), copy_ms, rate, statistics.mean(times),
            ex.streamed_bytes / rate)


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

def sim_burst(cfg, store, baselines, smi: str) -> None:
    """``[sim]``, printed and not gated: the port's simulator on
    ``H100_HOST`` for the script's own burst (``N_REQ`` requests at t = 0,
    ctx ``CTX``, ``MAX_NEW`` new tokens, llama3-8b): whole-batch ragdoll
    and the serial baseline (batches of ``SERIAL_BATCH``), each predicted
    p50 beside the measured one of serve-batch and serve-serial."""
    from repro_torch.core.costmodel import H100_HOST, CostModel, ModelProfile
    from repro_torch.core.placement import PlacementOptimizer
    from repro_torch.serving import SimConfig, percentile
    from repro_torch.serving.baselines import make_simulator
    cost = CostModel(H100_HOST, ModelProfile.from_config(cfg, kv_format="bf16"),
                     partition_bytes=float(store.partition_bytes()),
                     num_partitions=PARTITIONS, db_dim=CORPUS_DIM,
                     chunks_per_partition=CORPUS_N / PARTITIONS,
                     partition_mem_overhead=1.0)
    # serial_vllm batches 4 x the arrival rate a minute: 1 a minute gives
    # SerialRAGEngine's batches of 4
    base = SimConfig(in_len=CTX, out_len=MAX_NEW, max_batch=SLOTS,
                     rates_per_min=(SERIAL_BATCH / 4,), interval_s=3600.0)
    for mode, kw, measured in (("ragdoll", dict(continuous=False),
                                "serve-batch"),
                               ("serial_vllm", {}, "serve-serial")):
        opt = PlacementOptimizer(cost, avg_ctx_len=CTX, avg_out_len=MAX_NEW,
                                 kv_page_size=PAGE)
        res = make_simulator(cost, opt, mode, base, **kw).run([0.0] * N_REQ)
        p50 = percentile([r.latency for r in res.requests], 50)
        got = baselines[measured]["p50"]
        batches = [ev["batch"] for ev in res.policy_trace]
        log(f"[sim] {mode}{' whole-batch' if kw else ''}: predicted p50 "
            f"{p50:.3f} s for {N_REQ} requests at t = 0 (ctx {CTX}, "
            f"{MAX_NEW} new tokens, {cfg.name} on H100_HOST; batches "
            f"{batches}); {measured} measured p50 {got:.3f} s: measured / "
            f"predicted {got / p50:.3f} ({smi})")


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_serve_sharded(torch, cfg, params, store, queries, exact, smi: str,
                        serve_run):
    """Sharded retrieval on the card, on the shared store (see the module
    docstring): (a) the store over 2 and 4 shards, exact and at nprobe 16,
    against the single-host search, then each shard's hot tier under its
    share of a grant; (b) a one-rank NCCL group: ``sharded_topk_merge``
    and ``distributed_topk``; (c) ``RagdollEngine(retrieval_shards=4)``
    with the optimizer serving 16 requests.  The partitions the store held
    in RAM before the phase are held again after it.  Returns (c)'s
    launch counts."""
    import gc

    import numpy as np
    import torch.distributed as dist
    from repro_torch.core.costmodel import H100_HOST, CostModel, ModelProfile
    from repro_torch.core.placement import PlacementOptimizer
    from repro_torch.core.scheduler import BacklogScheduler
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.retrieval.distributed import (ShardedIVFStore,
                                                   _all_gather,
                                                   distributed_topk,
                                                   sharded_topk_merge)
    from repro_torch.retrieval.vectorstore import SearchStats
    from repro_torch.serving import (ContinuousGenerator, GeneratorConfig,
                                     RagdollEngine, percentile)
    from repro_torch.sharding import from_mesh
    tag = "serve-sharded"
    t_phase = time.perf_counter()
    resident0 = store.resident_set()
    opt = PlacementOptimizer(
        CostModel(H100_HOST, ModelProfile.from_config(cfg, kv_format="bf16"),
                  partition_bytes=float(store.partition_bytes()),
                  num_partitions=PARTITIONS, db_dim=CORPUS_DIM,
                  chunks_per_partition=CORPUS_N / PARTITIONS,
                  partition_mem_overhead=1.0, retrieval_shards=ENGINE_SHARDS),
        avg_ctx_len=CTX, avg_out_len=MAX_NEW, kv_page_size=PAGE)
    q8 = queries[:SLOTS]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def bit_equal(a, b):
        return (np.array_equal(a[1], b[1])
                and np.array_equal(a[0].view(np.int32), b[0].view(np.int32)))

    # (a) the store
    single = {nprobe: timed(lambda: store.search(q8, TOP_K, nprobe=nprobe))
              for nprobe in (None, SHARDED_NPROBE)}
    boards = None
    for shards in SHARD_COUNTS:
        sharded = ShardedIVFStore(store, shards)
        try:
            for nprobe in (None, SHARDED_NPROBE):
                got, secs = timed(lambda: sharded.search(q8, TOP_K,
                                                         nprobe=nprobe))
                want, want_s = single[nprobe]
                if not bit_equal(got, want):
                    fail(f"[{tag}] S={shards} nprobe {nprobe}: the sharded "
                         "search differs from the single-host search")
                log(f"[{tag}] S={shards} nprobe {nprobe}: ids and scores "
                    f"bit-equal to the single-host search; {secs * 1e3:.1f} "
                    f"ms sharded, {want_s * 1e3:.1f} ms single-host ({smi})")
            # each shard's sweep and merge alone, exact search
            pids = list(store.partitions)
            qmask = np.ones((SLOTS, PARTITIONS), bool)
            local, sweep_ms = [], []
            for shard in sharded.shards:
                own = [pid for pid in pids if pid in shard.pid_set]

                def sweep():
                    b_s, b_i, searched = store.sweep_boards(
                        q8, own, TOP_K, streamer=shard.streamer, qmask=qmask)
                    m = torch.from_numpy(qmask & searched[None, :]).cuda()
                    return ops.retrieval_topk_merge(b_s, b_i, m, TOP_K)

                out, secs = timed(sweep)
                local.append(out)
                sweep_ms.append(f"{secs * 1e3:.1f}")
            log(f"[{tag}] S={shards} exact: each shard's sweep and merge "
                f"{', '.join(sweep_ms)} ms for "
                f"{[len(sh.pids) for sh in sharded.shards]} partitions "
                f"({smi})")
            if shards == ENGINE_SHARDS:
                boards = (torch.stack([s for s, _ in local], dim=1),
                          torch.stack([i for _, i in local], dim=1))
            # the hot tier: a grant of SHARDED_HOT partitions' bytes split
            # across the shards, promoted down the probe ranking
            ranked, _ = store.probe(q8, SHARDED_NPROBE)
            ranking = ranked + [p for p in pids if p not in ranked]
            grant = SHARDED_HOT * store.partition_bytes()
            budgets = opt.shard_hot_budgets(grant, shards)
            sharded.set_hot_budgets(budgets, ranking)
            for shard in sharded.shards:
                if not set(shard.hot.pids()) <= shard.pid_set:
                    fail(f"[{tag}] shard {shard.sid} promoted "
                         f"{shard.hot.pids()}, not all its own")
            stats = SearchStats()
            hot, secs = timed(lambda: sharded.search(
                q8, TOP_K, nprobe=SHARDED_NPROBE, stats=stats))
            if not bit_equal(hot, single[SHARDED_NPROBE][0]) \
                    or stats.hot_hits == 0:
                fail(f"[{tag}] S={shards}: the hot search differs from the "
                     f"cold one (hot_hits {stats.hot_hits})")
            log(f"[{tag}] S={shards} hot tier: {grant} B split "
                f"{budgets}; shards hold {[sh.hot.pids() for sh in sharded.shards]}"
                f" ({sharded.hot_device_bytes()} B), each its own; the "
                f"search at nprobe {SHARDED_NPROBE} bit-equal to the cold "
                f"one with {stats.hot_hits} hot hits in {secs * 1e3:.1f} ms "
                f"({smi})")
        finally:
            sharded.close()
        del sharded
    # (b) the collectives on a one-rank NCCL group
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        ctx = from_mesh(make_mesh((1,), ("data",)))
        b_s, b_i = boards
        want = ops.retrieval_topk_merge(
            b_s, b_i, torch.ones(b_s.shape[:2], dtype=torch.bool,
                                 device="cuda"), TOP_K)
        got = sharded_topk_merge(b_s, b_i, TOP_K, ctx)
        ex_s, ex_i = exact[0][:SLOTS], exact[1][:SLOTS]
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            fail(f"[{tag}] sharded_topk_merge differs from the local merge")
        check_topk(f"[{tag}] sharded_topk_merge against the exact top-k",
                   got[0], got[1], ex_s, ex_i)
        pair = torch.zeros((ENGINE_SHARDS, 2, SLOTS, TOP_K), dtype=torch.int32,
                           device="cuda")
        out = torch.empty_like(pair)
        group = ctx.batch_group
        ag_ms = _events_ms(torch, lambda: _all_gather(out, pair, group), 20)
        ag_host = _host_s(torch, lambda: _all_gather(out, pair, group), 10)
        emb = np.empty((CORPUS_N, CORPUS_DIM), np.float32)
        for p in store.partitions.values():
            emb[p.doc_ids] = (p.embeddings if p.resident
                              else np.load(p.path))
        db = torch.from_numpy(emb).cuda()
        del emb
        qd = torch.from_numpy(q8).cuda()
        # one rank holds the whole corpus as its row shard
        (d_s, d_i), secs = timed(lambda: distributed_topk(qd, db, TOP_K,
                                                          ctx, CORPUS_N))
        one_s, one_i = ops.retrieval_topk(qd, db, TOP_K)
        err = check_topk(f"[{tag}] distributed_topk against one top-k over "
                         "the corpus", d_s, d_i, one_s, one_i)
        check_topk(f"[{tag}] distributed_topk against the exact top-k",
                   d_s, d_i, ex_s, ex_i)
        del db, qd
        log(f"[{tag}] one-rank NCCL group: sharded_topk_merge of the "
            f"S={ENGINE_SHARDS} boards equals the local merge exactly and "
            f"the exact top-k's ids; distributed_topk over the {CORPUS_N} "
            f"rows in {secs * 1e3:.1f} ms has one top-k's ids, scores within "
            f"{err:.2e}; the all-gather of {pair.numel() * 4} B: "
            f"{ag_ms:.4f} ms device, {ag_host * 1e3:.4f} ms host, against "
            f"the cost model's {opt.cost.topk_allgather_time(SLOTS, TOP_K, shards=ENGINE_SHARDS) * 1e3:.4f}"
            f" ms for {ENGINE_SHARDS} shards ({smi})")
    finally:
        dist.destroy_process_group()
    gc.collect()
    # (c) the engine with ENGINE_SHARDS shards and the optimizer
    gen = ContinuousGenerator(
        cfg, params, GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW,
                                     dtype=torch.bfloat16),
        num_slots=SLOTS, paged=True, page_size=PAGE, prefill_chunk=CHUNK,
        device="cuda")

    class ShardedEngine(RagdollEngine):
        """Notes each retrieval batch's probe width and rids."""

        def _retrieve_batch(self, reqs):
            out = super()._retrieve_batch(reqs)
            # only this thread searches: the last search is this batch's
            self.batches.append((self.nprobes[-1], [r.rid for r in reqs]))
            return out

    eng = ShardedEngine(store, QueryEmbedder(queries), gen,
                        BacklogScheduler(max_batch=SLOTS),
                        BacklogScheduler(max_batch=SLOTS), optimizer=opt,
                        initial_partitions=PARTITIONS - SPILLED,
                        retrieval_shards=ENGINE_SHARDS, policy_every=8,
                        device="cuda")
    eng.nprobes, eng.batches = [], []
    inner = eng.sharded.search

    def search(q, top_k, **kw):
        eng.nprobes.append(kw.get("nprobe"))
        return inner(q, top_k, **kw)

    eng.sharded.search = search
    errors = _watch_threads()
    eng.start()
    try:
        _submit_and_drain(eng, list(range(WARMUP_REQ)), 300, tag, errors)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = _submit_and_drain(eng, list(range(WARMUP_REQ,
                                                 WARMUP_REQ + N_REQ)),
                                 600, tag, errors)
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
    missing = [n for n in SHARDED_KERNELS if counts[n] == 0]
    if missing:
        fail(f"[{tag}] kernels never launched on this path: {missing}")
    # ids: the single-host search of each batch's queries at its nprobe
    probe_of = {}
    for nprobe, rids in eng.batches:
        if not any(WARMUP_REQ <= rid for rid in rids):
            continue
        _, ids = store.search(queries[rids], TOP_K, nprobe=nprobe)
        for rid, row in zip(rids, ids):
            probe_of[rid] = nprobe
            got = [int(c) for c in next(r for r in reqs
                                        if r.rid == rid).retrieved]
            if got != [int(j) for j in row]:
                fail(f"[{tag}] request {rid}: chunks {got}, the single-host "
                     f"search at nprobe {nprobe} gives {row.tolist()}")
    want = {r.rid: r for r in serve_run["reqs"]}
    fp32, ties, other = None, 0, 0
    for r in reqs:
        if len(r.output.split()) != MAX_NEW:
            fail(f"[{tag}] request {r.rid}: {len(r.output.split())} tokens")
        w = want[r.rid]
        if r.retrieved != w.retrieved:
            other += 1           # a pruned probe: another prompt than serve's
            continue
        if r.output == w.output:
            continue
        if fp32 is None:
            fp32 = _cast(params, torch.float32)
        t, a, b, gap, err = _near_tie(torch, cfg, params, fp32, w, r.output,
                                      ctx=CTX)
        msg = (f"[{tag}] request {r.rid}: first other token at {t}, {b} for "
               f"serve's {a}; fp32 logit gap {gap:.6f}, bf16 logits off fp32 "
               f"by up to {err:.6f} in that row")
        if abs(gap) > 2 * err:
            fail(f"{msg}: not a near tie")
        log(f"{msg}: a near tie ({smi})")
        ties += 1
    del fp32
    lat = [r.latency for r in reqs]
    ev = eng.policy_trace[-1]
    shards = eng.sharded.shards
    log(f"[{tag}] {N_REQ}/{N_REQ} requests, {MAX_NEW} tokens each, ids equal "
        f"to the single-host search at their batch's nprobe "
        f"{sorted({probe_of[r.rid] for r in reqs}, key=str)}; serve's tokens "
        f"for {N_REQ - other - ties}, {ties} near ties, {other} with other "
        f"chunks than serve's; in {wall:.3f} s: p50 "
        f"{percentile(lat, 50):.3f} s p95 {percentile(lat, 95):.3f} s, "
        f"{N_REQ * MAX_NEW / wall:.1f} output tokens/s (serve "
        f"{serve_run['tokens_s']:.1f}) ({smi})")
    batches = collections.Counter(e.gen_batch for e in eng.policy_trace)
    log(f"[{tag}] gen_batch over the {len(eng.policy_trace)} boundaries "
        f"(unseeded schedulers): {dict(sorted(batches.items()))}")
    log(f"[{tag}] last PolicyEvent of {len(eng.policy_trace)}: gen_batch "
        f"{ev.gen_batch}, nprobe {ev.nprobe}, resident partitions "
        f"{ev.resident_partitions}, hot partitions {ev.hot_partitions} "
        f"({ev.hot_bytes} B); per shard: streamer budgets "
        f"{[sh.streamer.free_bytes for sh in shards]} B, hot budgets "
        f"{[sh.hot.byte_budget for sh in shards]} B, hot partitions "
        f"{[sh.hot.pids() for sh in shards]}")
    log(f"[{tag}] launches on this path: {json.dumps(counts)}")
    del eng, gen
    gc.collect()
    for pid in resident0:               # serve-placement's store as it was
        store.load(pid)
    log(f"[{tag}] the phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


CATEGORIES = (
    # training's backward kernels, before the forward's names
    ("flash attention backward", ("dkdv_wgmma_kernel", "dq_wgmma_kernel",
                                  "dkdv_tf32_kernel", "dq_tf32_kernel",
                                  "delta_kernel")),
    ("rmsnorm backward", ("rmsnorm_bwd_kernel", "rmsnorm_dw_kernel")),
    # the split kernels and their merge passes (*_decode_combine_kernel)
    ("paged decode attention", ("paged_decode_",)),
    ("dense decode attention", ("dense_decode_",)),
    ("flash attention (prefill, bf16)", ("flash_wgmma_kernel",)),
    ("flash attention fp32 (prefill)", ("flash_tf32_",)),
    ("rmsnorm", ("rmsnorm_kernel",)),
    ("retrieval top-k and merge", ("topk_stream_kernel", "merge_kernel")),
    ("matmul (projections, MLP, lm_head)",
     ("gemm", "xmma", "nvjet", "cutlass")),
    ("copy host to device", ("Memcpy HtoD",)),
    ("copy device to host", ("Memcpy DtoH",)),
)


def breakdown(tag, records, window_s: float, smi: str,
              what: str = f"{PROFILE_REQ} requests") -> float:
    """Device busy share of a serving window (``what``) and its time by
    kind; returns the busy seconds."""
    if not records:
        log(f"[profile {tag}] the profiler recorded no device activity: "
            "not measured")
        return 0.0
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
    return busy


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
    # the same Pallas kernel in fp32: a kernel of its own (3xTF32), counted
    # apart from the bf16 one
    "flash_attention_fp32": ("cuda",
                             "src/repro_torch/csrc/flash_attention.cu",
                             "src/repro/kernels/flash_attention.py:88"),
    "decode_attention": ("cuda", "src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:76"),
    "paged_decode_attention": ("cuda", "src/repro_torch/csrc/paged_attention.cu",
                               "src/repro/kernels/paged_attention.py:124"),
    "retrieval_topk": ("cuda", "src/repro_torch/csrc/topk_retrieval.cu",
                       "src/repro/kernels/topk_retrieval.py:58"),
    "retrieval_topk_merge": ("cuda", "src/repro_torch/csrc/topk_retrieval.cu",
                             "src/repro/kernels/topk_retrieval.py:146"),
    # training: the TPU path differentiates flash_attention_pallas (its
    # custom VJP is kernels/flash_vjp.py, plain jnp) and rmsnorm_pallas
    "flash_attention_bwd": ("cuda",
                            "src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/kernels/flash_vjp.py:127"),
    # the same gradient in fp32: kernels of their own (3xTF32), counted
    # apart from the bf16 ones
    "flash_attention_bwd_fp32": ("cuda",
                                 "src/repro_torch/csrc/flash_attention_bwd.cu",
                                 "src/repro/kernels/flash_vjp.py:127"),
    "rmsnorm_bwd": ("cuda", "src/repro_torch/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:22"),
}


def main() -> int:
    import torch
    t_start = time.perf_counter()
    phase_s = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        log(f"[time] {name} took {phase_s[name]:.1f} s; host MemAvailable "
            f"{_mem_available()} B")
        return out

    name, smi = timed("device", phase_device, torch)
    from repro_torch.kernels import _build
    store_root = ROOT / "build" / "smoke_corpus"
    recluster_root = ROOT / "build" / "smoke_recluster"
    shutil.rmtree(store_root, ignore_errors=True)
    shutil.rmtree(recluster_root, ignore_errors=True)
    # nvcc's processes run while the corpus is drawn and partitioned (the
    # corpus launches no kernel of the port)
    builder = concurrent.futures.ThreadPoolExecutor(1)
    try:
        built = builder.submit(_build.build)
        store, queries, exact = timed("corpus", phase_corpus, torch,
                                      store_root)
        timed("build", phase_build, torch, built)
        timer = Timer(torch)
        rows = timed("kernels", phase_kernels, torch, timer, store, queries)
        # the other families' kernels before the train phases, after which
        # the profiler loses records and the timer falls back to events
        family_rows = timed("family-kernel", phase_family_kernels, torch,
                            Timer(torch, iters=10), smi)
        del timer
        train_rows = timed("train-kernels", phase_train_kernels, torch,
                           Timer(torch, iters=3), smi)
        rows.update((k, train_rows[k]) for k in (
            "flash_attention_bwd", "flash_attention_bwd_fp32", "rmsnorm_bwd"))
        timed("model", phase_model, torch)
        train = timed("train", phase_train, torch, smi)
        train_families = timed("train-families", phase_train_families, torch,
                               smi)
        mesh = timed("mesh", phase_mesh, torch, smi)
        timed("family-models", phase_family_models, torch, smi)
        timed("dense-family-models", phase_dense_family_models, torch, smi)
        timed("embed-models", phase_embed_models, torch, smi)
        serve = (store, queries, exact, smi)
        families = (timed("serve-gemma2", phase_serve_gemma2, torch, *serve)
                    + timed("serve-families", phase_serve_families, torch,
                            *serve)
                    + timed("serve-deepseek", phase_serve_deepseek, torch,
                            *serve)
                    + timed("serve-mamba2", phase_serve_mamba2, torch,
                            *serve))
        g8 = (timed("serve-jamba", phase_serve_jamba, torch, *serve)
              + timed("serve-llama70b", phase_serve_llama70b, torch, *serve))
        embed = {"seamless": timed("serve-seamless", phase_serve_seamless,
                                   torch, smi),
                 "chameleon": timed("serve-chameleon", phase_serve_chameleon,
                                    torch, smi)}
        cfg, params = timed("weights", build_weights, torch)
        paged = timed("serve", phase_serve, torch, cfg, params, *serve)
        batch = timed("serve-batch", phase_serve_batch, torch, cfg, params,
                      *serve, paged["outputs"])
        sim_burst(cfg, store, batch, smi)
        swap = timed("serve-swap", phase_serve_swap, torch, cfg, params,
                     *serve)
        prefix = timed("serve-prefix", phase_serve_prefix, torch, cfg,
                       params, *serve)
        streamed = timed("serve-streamed", phase_serve_streamed, torch, cfg,
                         params, *serve, paged)
        timed("store", phase_store_recluster, torch, recluster_root, smi)
        sharded = timed("serve-sharded", phase_serve_sharded, torch, cfg,
                        params, *serve, paged)
        # last: its partition cache releases partitions to disk
        placement = timed("serve-placement", phase_serve_placement, torch,
                          cfg, params, *serve, dict(batch, serve=paged))
    finally:
        builder.shutdown(wait=True)
        shutil.rmtree(store_root, ignore_errors=True)
        shutil.rmtree(recluster_root, ignore_errors=True)
    runs = ([paged["counts"], swap] + [r["counts"] for r in batch.values()]
            + prefix + [streamed, sharded] + placement + families + g8
            + embed["seamless"] + embed["chameleon"] + [train]
            + train_families + [mesh])
    kernels = []
    for kname, (route, source, replaces) in SOURCES.items():
        extra = ({"shapes": family_rows[kname]} if kname in family_rows
                 else {})
        if kname in train_rows["shapes"]:
            extra["shapes"] = train_rows["shapes"][kname]
        # the train steps' launches, once a kernel (llama3-8b at depth 4)
        if kname in TRAIN_KERNELS:
            extra["launches_at_train"] = train[kname]
        if kname in MESH_KERNELS:
            extra["launches_at_mesh"] = mesh[kname]
        if kname == "flash_attention":
            extra["train_forward_ms"] = train_rows["flash_lse_ms"]
        # the launches of the G = 8 models' runs, once a kernel: each is
        # at 64/8 heads x 128 in bf16 (bf16 pages on the paged path)
        if any(row["case"].startswith(("llama3-70b", "jamba"))
               for row in extra.get("shapes", ())):
            extra["launches_at_g8"] = sum(c[kname] for c in g8)
        # the embed frontend's launches, once a kernel: serve-seamless's
        # at 16/16 x 64 (its rows; RMSNorm at 1024, granite's) and
        # serve-chameleon's at 64/8 x 128 (jamba's rows; RMSNorm at 8192).
        # The paged kernel's seamless row is held, but no path runs it
        if kname in EMBED_KERNELS:
            for model, counts in embed.items():
                extra[f"launches_at_{model}"] = sum(c[kname] for c in counts)
        kernels.append(dict(name=kname, route=route, source=source,
                            replaces=replaces,
                            launches=sum(c.get(kname, 0) for c in runs),
                            **rows[kname], **extra))
    log(f"[time] phases: {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
