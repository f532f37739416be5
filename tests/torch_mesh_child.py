"""The child program of the mesh tests (``tests/test_torch_mesh.py`` on
gloo ranks, ``tests/test_torch_mesh_cards.py`` on NCCL ranks, a card
each) and its spawn: ``world`` fresh Python processes on 127.0.0.1, a free
port, killed past the time limit.  Imports no JAX: the card's tests run
where JAX may hold a GPU.
"""
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

from test_torch_distributed import LIMIT_S, _free_port

SRC = Path(__file__).resolve().parent.parent / "src"
CARDS_LIMIT_S = 600.0


CHILD = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, port, out, device = (int(sys.argv[1]), int(sys.argv[2]),
                                      sys.argv[3], sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.sharding import from_mesh
    from repro_torch.sharding.specs import param_pspecs, shard_params
    from repro_torch.training.compression import GradCompressor
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_loop import (make_train_step,
                                                 reduce_grads,
                                                 value_and_grad)

    res = {}
    T = lambda a: torch.from_numpy(np.asarray(a))
    host = lambda tree: (tree.cpu().numpy() if torch.is_tensor(tree) else
                         {k: host(v) for k, v in tree.items()}
                         if isinstance(tree, dict) else
                         [host(v) for v in tree])

    def family(ctx, arch, kw, jp, batches, s):
        cfg = get_config(arch).reduced(num_layers=2, **kw)
        model = Model(cfg, device="cpu", ctx=ctx)
        full = params_from_numpy(jp, cfg, device="cpu", dtype=torch.float32)
        p = model.shard(full)
        batch = {k: T(v)[:, :s] for k, v in batches["one"].items()}
        loss, _, grads = value_and_grad(model, p, batch)
        grads = reduce_grads(model, grads, batch["labels"].shape[0])
        logits, _ = model.apply_train(p, batch["inputs"])
        r = {"loss": float(loss), "grads": host(model.gather(grads)),
             "logits": model.whole_logits(logits, *batch["inputs"].shape
                                          ).numpy()}
        if s != S:
            return r
        opt = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=30)
        comp = GradCompressor(block=64)
        step = make_train_step(model, opt, grad_accum=2, compressor=comp)
        q, o, c = p, adamw_init(p), comp.init_state(p)
        r["step_losses"] = []
        for b in batches["train"]:
            q, o, c, m = step(q, o, c, {k: T(v) for k, v in b.items()})
            r["step_losses"].append(float(m["loss"]))
        r["stepped"] = host(model.gather(q))
        cache = model.init_cache(B, S + NEW, torch.float32)
        tok = model.prefill(p, T(batches["prompts"]), cache)
        r["decode"] = [tok.numpy()]
        for i in range(NEW):
            tok = model.decode(p, tok.argmax(-1)[:, None], cache,
                               torch.full((B,), S + i, dtype=torch.int32))
            r["decode"].append(tok.numpy())
        return r

    if device == "cpu":
        inp = torch.load(f"{out}/inputs.pt", weights_only=False)
        B, S, NEW = inp["B"], inp["S"], inp["NEW"]
        for mesh_name, shape in inp["meshes"].items():
            ctx = from_mesh(make_mesh(shape, ("data", "model"),
                                      device_type="cpu"))
            for arch, kw in inp["families"]:
                res[mesh_name, arch] = family(ctx, arch, kw, inp["params"][arch],
                                              inp["batches"][arch], S)
            if mesh_name == "1x4":
                arch, kw = inp["families"][0]
                res[mesh_name, arch, "noseq"] = family(
                    ctx, arch, kw, inp["params"][arch], inp["batches"][arch],
                    inp["S_NOSEQ"])
            # the MoE of tests/test_distributed.py
            mcfg = inp["moe_cfg"]
            mp = shard_params({k: T(v) for k, v in inp["moe_p"].items()},
                              param_pspecs({"moe": inp["moe_p"]}, ctx)["moe"],
                              ctx)
            x = T(inp["moe_x"])
            for name, fn in (
                    ("tp", lambda: moe.moe_forward(mp, x, mcfg, ctx=ctx)),
                    ("ep8", lambda: moe.moe_forward_ep(mp, x, mcfg, ctx,
                                                       capacity_factor=8.0)),
                    ("ep1", lambda: moe.moe_forward_ep(mp, x, mcfg, ctx,
                                                       capacity_factor=1.0))):
                y, aux = fn()
                res[mesh_name, "moe", name] = (y.numpy(), float(aux))
        from repro_torch.launch import train
        args = ["--device", "cpu", "--steps", "3", "--batch", "4",
                "--seq-len", "16", "--log-every", "1", "--ckpt-every", "2",
                "--compress-grads", "--grad-accum", "2"]
        ck = ["--ckpt-dir", f"{out}/ckpt"]
        res["launch"] = train.main(args + ck + ["--mesh", "2x2"])
        res["launch_resumed"] = train.main(args + ck + ["--mesh", "2x2",
                                                        "--resume"])
        res["launch_alone"] = train.main(args)
    else:
        res = cards(rank)
    torch.save(res, f"{out}/rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
""")

CARDS_CHILD = textwrap.dedent("""
    def cards(rank):
        # llama3-8b at full width on a card a rank: one fp32 step at depth
        # 2 against the unsharded step on rank 0's card, then bf16 timing
        import time
        from repro_torch.training.optimizer import tree_leaves
        res = {}
        dev = torch.device("cuda", rank)
        cfg = get_config("llama3-8b").reduced(
            num_layers=2, d_model=4096, num_heads=32, num_kv_heads=8,
            head_dim=128, d_ff=14336, vocab_size=128256)
        g = torch.Generator().manual_seed(0)
        batch = {k: torch.randint(0, cfg.vocab_size, (4, 256), generator=g
                                  ).to(dev) for k in ("inputs", "labels")}
        want = None
        if rank == 0:
            m0 = Model(cfg, device=dev)
            full = m0.init(seed=0, dtype=torch.float32)
            loss0, _, g0 = value_and_grad(m0, full, batch)
            want = (float(loss0), [x.cpu() for x in tree_leaves(g0)])
            del full, g0, m0
            torch.cuda.empty_cache()
        dist.barrier()
        for shape in ((1, 4), (2, 2)):
            ctx = from_mesh(make_mesh(shape, ("data", "model")))
            model = Model(cfg, device=dev, ctx=ctx)
            p = model.init(seed=0, dtype=torch.float32)
            loss, _, grads = value_and_grad(model, p, batch)
            grads = reduce_grads(model, grads, 4)
            whole = model.gather(grads)
            if rank == 0:
                errs = [float((a.to(dev) - b).abs().max()
                              / max(float(a.abs().max()), 1e-30))
                        for a, b in zip(want[1], tree_leaves(whole))]
                res[shape] = (float(loss), want[0], max(errs))
            del p, grads, whole
            torch.cuda.empty_cache()
        # bf16 at depth 4, tp 4: the train step timed, collectives by kind
        cfg4 = get_config("llama3-8b").reduced(
            num_layers=4, d_model=4096, num_heads=32, num_kv_heads=8,
            head_dim=128, d_ff=14336, vocab_size=128256)
        ctx = from_mesh(make_mesh((1, 4), ("data", "model")))
        model = Model(cfg4, device=dev, ctx=ctx, remat=True)
        p = model.init(seed=0, dtype=torch.bfloat16)
        o = adamw_init(p)
        step = make_train_step(model, AdamWConfig(lr=1e-4, warmup_steps=2))
        data = SyntheticLM(cfg4, DataConfig(batch=8, seq_len=2048))
        it = iter(data)
        tb = [{k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
              for _ in range(5)]
        for b in tb[:2]:
            p, o, _, m = step(p, o, None, b)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for b in tb[2:4]:
            p, o, _, m = step(p, o, None, b)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 2
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            p, o, _, m = step(p, o, None, tb[4])
            torch.cuda.synchronize()
        # each kind's device ms and kernels on this rank: an NCCL kernel
        # runs from its launch to the last rank's arrival, so the rank
        # that arrives last waits least
        kinds = {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = e.cuda_time_total
            name = e.key.lower()
            if "nccl" in name:
                for k in ("allgather", "reducescatter", "allreduce",
                          "alltoall", "sendrecv"):
                    if k in name.replace("_", ""):
                        ms_n = kinds.get(k, (0.0, 0))
                        kinds[k] = (ms_n[0] + t / 1e3, ms_n[1] + e.count)
        res["timing"] = dict(step_ms=ms, tokens_s=8 * 2048 / ms * 1e3,
                             loss=float(m["loss"]), coll_ms=kinds,
                             peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        return res
""")


def _spawn(world, device, out):
    """Run the child on ``world`` ranks; kill them all past the limit."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    port = str(_free_port())
    code = CARDS_CHILD + CHILD if device == "cuda" else CHILD
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world), port, str(out),
         device], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    limit = LIMIT_S if device == "cpu" else CARDS_LIMIT_S
    deadline = time.monotonic() + limit
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 0.1))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"{world} ranks ({device}) still running after "
                    f"{limit} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


