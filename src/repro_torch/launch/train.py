"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Runs a real training loop (reduced config by default) with
checkpointing and restart (``--resume``), gradient compression and
gradient accumulation, as ``repro.launch.train``.  Everything runs on the
CUDA card unless ``--device cpu`` asks for the plain PyTorch versions of
the kernels; the reduced configs (head dim 16, fp32 weights) train on
the card as the full ones do.  ``main`` returns each step's loss.

``--mesh DxM`` trains over a ``(data=D, model=M)`` mesh, one process a
device, started as ``torchrun`` starts them: ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` in the environment
(``LOCAL_RANK`` picks the card).  The group runs NCCL on the cards and
gloo with ``--device cpu``; a default group already started is used as
it is.  Every process draws the whole tree from the seed and keeps its
slices (``param_pspecs``); the model takes each data rank's rows of the
batch; checkpoints hold a shard a process.  Every rank returns the same
losses, the whole batch's.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import List

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import Model
from repro_torch.sharding.specs import from_mesh
from repro_torch.training.checkpoint import (latest_step, load_checkpoint,
                                             save_checkpoint)
from repro_torch.training.compression import GradCompressor
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_loop import make_train_step


def main(argv=None) -> List[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full architecture (default: reduced)")
    ap.add_argument("--scale", type=int, default=1,
                    help="width multiplier on the reduced config")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="e.g. '2x2' -> (data=2, model=2), a process a "
                         "device")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the Hopper kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ctx, shard = None, {}
    if args.mesh:
        d, m = (int(x) for x in args.mesh.split("x"))
        ctx = from_mesh(make_mesh((d, m), ("data", "model"),
                                  device_type=_start_group(device)))
        shard = dict(shard_id=dist.get_rank(),
                     num_shards=dist.get_world_size())
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())

    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.reduced(d_model=64 * args.scale, d_ff=128 * args.scale)

    model = Model(cfg, device, remat=True, ctx=ctx)
    comp = GradCompressor() if args.compress_grads else None
    params = model.init(seed=0, dtype=torch.float32)
    opt_state = adamw_init(params)
    comp_state = comp.init_state(params) if comp else None
    start = 0
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir):
        tree, start = load_checkpoint(args.ckpt_dir,
                                      {"p": params, "o": opt_state},
                                      shard_id=shard.get("shard_id", 0))
        params, opt_state = tree["p"], tree["o"]
        print(f"resumed from step {start}")

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=20,
                          total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg, grad_accum=args.grad_accum,
                              compressor=comp)

    data = iter(SyntheticLM(cfg, DataConfig(batch=args.batch,
                                            seq_len=args.seq_len)))
    for _ in range(start):           # a resume takes the batches it left
        next(data)
    t0 = time.time()
    losses = []
    for i in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in next(data).items()}
        params, opt_state, comp_state, mets = step_fn(
            params, opt_state, comp_state, batch)
        losses.append(mets["loss"])
        if (i + 1) % args.log_every == 0:
            dt = time.time() - t0
            tok_s = args.batch * args.seq_len * args.log_every / dt
            print(f"step {i+1:5d} loss={float(mets['loss']):.4f} "
                  f"gnorm={float(mets['grad_norm']):.3f} "
                  f"lr={float(mets['lr']):.2e} tok/s={tok_s:,.0f}")
            t0 = time.time()
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, i + 1,
                            {"p": params, "o": opt_state}, **shard,
                            barrier=dist.barrier if ctx else None)
    print("done.")
    return [float(x) for x in losses]


def _start_group(device: torch.device) -> str:
    """Start the default group from the environment (NCCL on the cards,
    gloo on the CPU) unless one runs already; the mesh's device type."""
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", os.environ.get("RANK", "0")))
            % torch.cuda.device_count())
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError("--mesh runs a process a device: start them "
                               "with MASTER_ADDR, MASTER_PORT, RANK and "
                               "WORLD_SIZE set (torchrun does)")
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return device.type


if __name__ == "__main__":
    main()
