"""Serving launcher: ``python -m repro_torch.launch.serve [--arch ...]``.

Brings up the full RAGDoll engine (real threads, a real vector store with
disk-spilled partitions, real generation on a reduced model) and replays
a Poisson workload against it, printing the latency table.  ``--serial``
runs the baseline engine for comparison, ``--streamed`` the offloading
layer-streamed generator.  Everything runs on the CUDA
card unless ``--device cpu`` asks for the plain PyTorch versions of the
kernels (the counterpart of ``JAX_PLATFORMS`` for the JAX launcher).
"""
from __future__ import annotations

import argparse
import random
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.scheduler import BacklogScheduler
from repro_torch.models.model import Model
from repro_torch.retrieval.embedding import HashEmbedder
from repro_torch.retrieval.vectorstore import VectorStore
from repro_torch.serving.engine import RagdollEngine, SerialRAGEngine
from repro_torch.serving.generator import Generator, GeneratorConfig
from repro_torch.serving.request import Request, latency_table


def build_corpus(n: int):
    rng = random.Random(7)
    topics = ["astronomy", "history", "biology", "music", "geology",
              "painting", "chemistry", "politics", "literature", "sports"]
    return [f"{topics[i % len(topics)]} fact {i}: " +
            " ".join(f"w{rng.randrange(500)}" for _ in range(24))
            for i in range(n)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--rate", type=float, default=120.0,
                    help="requests per minute")
    ap.add_argument("--chunks", type=int, default=800)
    ap.add_argument("--partitions", type=int, default=8)
    ap.add_argument("--resident", type=int, default=4)
    ap.add_argument("--serial", action="store_true")
    ap.add_argument("--streamed", action="store_true",
                    help="use the offloading StreamedExecutor")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the Hopper kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    params = Model(cfg, device).init(seed=args.seed, dtype=torch.float32)
    gen = Generator(cfg, params, GeneratorConfig(ctx_len=48,
                                                 max_new_tokens=8),
                    streamed=args.streamed, device=device)

    emb = HashEmbedder(dim=128)
    with tempfile.TemporaryDirectory() as root:
        store = VectorStore.build(build_corpus(args.chunks), emb,
                                  num_partitions=args.partitions, root=root,
                                  device=device)
        for pid in range(args.resident, args.partitions):
            store.spill(pid)

        if args.serial:
            eng = SerialRAGEngine(store, emb, gen, batch_size=4,
                                  device=device)
        else:
            ret_s = BacklogScheduler(max_batch=16)
            gen_s = BacklogScheduler(max_batch=8)
            eng = RagdollEngine(store, emb, gen, ret_s, gen_s,
                                initial_partitions=args.resident,
                                device=device)
        eng.start()
        try:
            rng = random.Random(args.seed)
            for i in range(args.requests):
                time.sleep(rng.expovariate(args.rate / 60.0))
                eng.submit(Request(rid=i, query=f"question about fact {i}",
                                   arrival=time.perf_counter()))
            reqs = eng.drain(args.requests, timeout=300)
        finally:
            eng.stop()

    tab = latency_table(reqs)
    print(f"\nmode={'serial' if args.serial else 'ragdoll'} "
          f"arch={args.arch} device={device} streamed={args.streamed}")
    for k, v in tab.items():
        print(f"  {k:16s} {v:10.3f}" if isinstance(v, float)
              else f"  {k:16s} {v}")


if __name__ == "__main__":
    main()
