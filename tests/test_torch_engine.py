"""Port engine vs the JAX engine on the fig8 ``paged`` mini-trace.

Both ``RagdollEngine``s serve the same 10 requests (120 docs,
``HashEmbedder(dim=32)``, 4 IVF partitions with one spilled, ctx 32,
max_new 4, page 8, ``prefill_chunk=16``, 3 slots) single-threaded through
``pump_once``, on the same converted weights.  Every request must get
the same retrieved chunks and the same output tokens; the test first
asserts that every greedy choice of the JAX run has a top-2 logit gap
above 1e-3.  Also here: the port imports no JAX and no ``repro`` module,
its entry points refuse to fall back to the CPU, and ``RagdollEngine``
takes fig8's ``policy_every`` and wires the policy boundary.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.core.scheduler import BacklogScheduler as JaxBacklogScheduler
from repro.models.model import Model as JaxModel
from repro.retrieval import HashEmbedder as JaxHashEmbedder
from repro.retrieval import VectorStore as JaxVectorStore
from repro.serving.engine import RagdollEngine as JaxEngine
from repro.serving.generator import ContinuousGenerator as JaxGenerator
from repro.serving.generator import GeneratorConfig as JaxGeneratorConfig
from repro.serving.request import Request as JaxRequest

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.scheduler import BacklogScheduler
from repro_torch.retrieval import HashEmbedder, VectorStore
from repro_torch.retrieval.distributed import ShardedIVFStore
from repro_torch.serving import (ContinuousGenerator, GeneratorConfig,
                                 RagdollEngine, Request)

SRC = Path(__file__).resolve().parents[1] / "src"
CTX, MAX_NEW, PAGE, CHUNK, SLOTS, N_REQ = 32, 4, 8, 16, 3, 10
TEXTS = [f"doc {i} topic{i % 5}" for i in range(120)]
MARGIN = 1e-3


def _drive(eng, reqs):
    """``_drive_deterministic`` of benchmarks/fig8_percentiles.py."""
    eng._retrieve_batch(reqs)
    eng.pipeline.context_queue.put_many(reqs)
    guard = 0
    while eng.pump_once() < len(reqs):
        guard += 1
        assert guard < 100 * len(reqs), "mini-trace stalled"
    return sorted(eng.completed, key=lambda r: r.rid)


def _run_jax(root, margins):
    cfg = jax_get_config("llama3-8b").reduced(num_layers=2)
    params = JaxModel(cfg, remat=False).init(jax.random.PRNGKey(0),
                                             jnp.float32)
    emb = JaxHashEmbedder(dim=32)
    store = JaxVectorStore.build(TEXTS, emb, num_partitions=4, root=root)
    store.spill(3)
    gen = JaxGenerator(cfg, params, JaxGeneratorConfig(
        ctx_len=CTX, max_new_tokens=MAX_NEW), num_slots=SLOTS,
        paged=True, page_size=PAGE, prefill_chunk=CHUNK)

    def gap(logits, rows):
        top2 = np.sort(np.asarray(logits)[rows], axis=-1)[:, -2:]
        margins.extend(top2[:, 1] - top2[:, 0])

    decode, chunk = gen._decode_paged, gen._chunk_paged

    def decode_rec(p, x, c, pos, bt):
        live = [r.index for r in gen.table.active_refs()
                if r.index not in gen._prefilling]
        logits, c = decode(p, x, c, pos, bt)
        gap(logits, live)
        return logits, c

    def chunk_rec(p, x, c, off, bt):
        logits, c = chunk(p, x, c, off, bt)
        if int(off[0]) + x.shape[1] >= CTX:       # the emitting chunk
            gap(logits, [0])
        return logits, c

    gen._decode_paged, gen._chunk_paged = decode_rec, chunk_rec
    eng = JaxEngine(store, emb, gen, JaxBacklogScheduler(max_batch=8),
                    JaxBacklogScheduler(max_batch=SLOTS),
                    initial_partitions=3, policy_every=2)
    try:
        reqs = [JaxRequest(rid=i, query=f"query {i}",
                           arrival=time.perf_counter())
                for i in range(N_REQ)]
        return _drive(eng, reqs), params
    finally:
        eng.streamer.close()


def _run_torch(root, jparams):
    cfg = get_config("llama3-8b").reduced(num_layers=2)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu", dtype=torch.float32)
    emb = HashEmbedder(dim=32)
    store = VectorStore.build(TEXTS, emb, num_partitions=4, root=root,
                              device="cpu")
    store.spill(3)
    gen = ContinuousGenerator(cfg, params, GeneratorConfig(
        ctx_len=CTX, max_new_tokens=MAX_NEW), num_slots=SLOTS,
        paged=True, page_size=PAGE, prefill_chunk=CHUNK, device="cpu")
    eng = RagdollEngine(store, emb, gen, BacklogScheduler(max_batch=8),
                        BacklogScheduler(max_batch=SLOTS),
                        initial_partitions=3, device="cpu")
    try:
        reqs = [Request(rid=i, query=f"query {i}",
                        arrival=time.perf_counter()) for i in range(N_REQ)]
        return _drive(eng, reqs)
    finally:
        eng.streamer.close()


def test_fig8_paged_minitrace_matches_jax_engine(tmp_path):
    margins = []
    jreqs, jparams = _run_jax(str(tmp_path / "jax"), margins)
    treqs = _run_torch(str(tmp_path / "torch"), jparams)
    assert len(margins) == N_REQ * MAX_NEW
    assert min(margins) > MARGIN, "mini-trace lacks a greedy margin"
    assert [r.rid for r in treqs] == list(range(N_REQ))
    for j, t in zip(jreqs, treqs):
        assert len(t.retrieved) == 5
        assert t.retrieved == j.retrieved, t.rid
        assert t.output == j.output, t.rid


# ------------------------------------------------------- package rules
def _port_modules():
    pkg = SRC / "repro_torch"
    return sorted(
        ".".join(p.relative_to(SRC).with_suffix("").parts)
        .replace(".__init__", "")
        for p in pkg.rglob("*.py"))


def test_port_imports_without_jax():
    mods = _port_modules()
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['jaxlib'] = None; "
            + "; ".join(f"import {m}" for m in mods)
            + "; assert not any(m == 'repro' or m.startswith('repro.') "
              "for m in sys.modules)")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_port_sources_never_import_reference_or_jax():
    root = SRC.parent
    files = sorted((SRC / "repro_torch").rglob("*.py")) \
        + [root / "chip_smoke.py"]
    bad = ("import repro.", "from repro.", "from repro ", "import repro\n",
           "import jax", "from jax")
    for f in files:
        text = f.read_text()
        for pat in bad:
            assert pat not in text, f"{f}: {pat!r}"


def test_entry_points_refuse_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid")
    cfg = get_config("llama3-8b").reduced(num_layers=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousGenerator(cfg, {}, GeneratorConfig(), paged=True,
                            prefill_chunk=8, device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        VectorStore(8, 2)


def test_engine_takes_policy_every_and_keeps_it_inert(tmp_path):
    """fig8 builds its engines with ``policy_every=2``: the port accepts
    it (default 8, as the reference), hands it to the generation pump and
    wires the policy boundary there, as the reference does; with no
    optimizer the boundary journals nothing and retargets nothing.  An
    optimizer is accepted, and ``retrieval_shards=2`` builds a sharded
    store."""
    from repro_torch.core.costmodel import PF_HIGH, CostModel, ModelProfile
    from repro_torch.core.placement import PlacementOptimizer
    cfg = get_config("llama3-8b").reduced(num_layers=1)
    emb = HashEmbedder(dim=32)
    store = VectorStore.build(TEXTS, emb, num_partitions=4,
                              root=str(tmp_path), device="cpu")
    gen = ContinuousGenerator(cfg, None, GeneratorConfig(
        ctx_len=CTX, max_new_tokens=MAX_NEW), num_slots=SLOTS, paged=True,
        page_size=PAGE, prefix_cache=True, device="cpu")
    sched = (BacklogScheduler(max_batch=8), BacklogScheduler(max_batch=3))
    for every in (None, 2):
        kw = {} if every is None else dict(policy_every=every)
        eng = RagdollEngine(store, emb, gen, *sched, device="cpu", **kw)
        try:
            want = 8 if every is None else every
            assert eng.policy_every == want
            pump = eng.pipeline.workers[1]
            assert pump.policy_every == want
            assert pump.on_policy_boundary == eng._gen_boundary
            assert eng.pipeline.workers[0].on_batch_boundary \
                == eng._ret_boundary
            before = (gen.num_slots, gen.kv.pool.capacity)
            pump.on_policy_boundary()
            assert eng.policy_trace == []
            assert (gen.num_slots, gen.kv.pool.capacity) == before
        finally:
            eng.streamer.close()
    opt = PlacementOptimizer(CostModel(
        PF_HIGH, ModelProfile.from_config(cfg), partition_bytes=1e6,
        num_partitions=4))
    eng = RagdollEngine(store, emb, gen, *sched, optimizer=opt,
                        policy_every=2, device="cpu")
    try:
        assert eng.opt is opt and opt.registry is eng.registry
    finally:
        eng.streamer.close()
    eng = RagdollEngine(store, emb, gen, *sched, retrieval_shards=2,
                        device="cpu")
    try:
        assert isinstance(eng.sharded, ShardedIVFStore)
        assert eng.sharded.num_shards == 2
        assert sorted(p for sh in eng.sharded.shards for p in sh.pids) \
            == list(range(store.num_partitions))
    finally:
        eng.streamer.close()
        eng.sharded.close()
