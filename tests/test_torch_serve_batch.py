"""Port vs the JAX package on the whole-batch serving path.

On the CPU, in fp32, on the same converted weights of
``get_config("llama3-8b").reduced(num_layers=2)`` (``PRNGKey(1)``: with
key 0, the weights of ``tests/test_continuous.py``, one greedy choice on
its prompts has a top-2 gap of 1.4e-4, too small to demand equal tokens
across frameworks):

* the port's ``Generator.generate`` gives the JAX ``Generator``'s tokens;
* the port's dense ``ContinuousGenerator`` on the randomized schedules of
  ``tests/test_continuous.py``, and the paged one that joins by one-shot
  prefill (no ``prefill_chunk``), give the port ``Generator``'s tokens;
* the whole-batch ``RagdollEngine`` (``_retrieve_batch`` then
  ``_generate_batch``) and the threaded ``SerialRAGEngine`` give the JAX
  engines' retrieved chunks and tokens on a mini-trace;
* ``python -m repro_torch.launch.serve --device cpu`` serves 3 requests.

Token equality is a fair demand only where every greedy choice of the
JAX run has a top-2 logit gap above 1e-3; each test asserts that first.
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
from repro.serving.engine import SerialRAGEngine as JaxSerialEngine
from repro.serving.generator import Generator as JaxGenerator
from repro.serving.generator import GeneratorConfig as JaxGeneratorConfig
from repro.serving.request import Request as JaxRequest

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.scheduler import BacklogScheduler
from repro_torch.launch.serve import build_corpus
from repro_torch.retrieval import HashEmbedder, VectorStore
from repro_torch.serving import (ContinuousGenerator, Generator,
                                 GeneratorConfig, RagdollEngine, Request,
                                 SerialRAGEngine)

SRC = Path(__file__).resolve().parents[1] / "src"
CTX, MAX_NEW = 16, 5
MARGIN = 1e-3
# the launcher's corpus: unlike fig8's "doc i topic j" texts, its top-6
# scores have no exact ties, so ids cannot depend on how the threaded
# pipeline happens to batch the queries
TEXTS = build_corpus(120)
ENGINE_CTX, ENGINE_NEW, N_REQ = 32, 4, 10


def _prompts(n=6):
    return [f"query {i} topic{i % 3} alpha beta" for i in range(n)]


def _random_schedule(seed, ticks=40, max_joins=3):
    rng = np.random.default_rng(seed)
    return [int(rng.integers(0, max_joins)) for _ in range(ticks)]


def _record_margins(gen, margins):
    """Wrap a JAX Generator's jitted prefill/decode to record every
    greedy choice's top-2 logit gap."""
    prefill, decode = gen._prefill, gen._decode

    def gap(logits):
        top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
        margins.extend(top2[:, 1] - top2[:, 0])

    def prefill_rec(*a):
        logits, cache = prefill(*a)
        gap(logits)
        return logits, cache

    def decode_rec(*a):
        logits, cache = decode(*a)
        gap(logits)
        return logits, cache

    gen._prefill, gen._decode = prefill_rec, decode_rec


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_config("llama3-8b").reduced(num_layers=2)
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(1),
                                               jnp.float32)
    cfg = get_config("llama3-8b").reduced(num_layers=2)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu", dtype=torch.float32)
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def reference(weights):
    """The JAX whole-batch tokens of the six prompts, margins checked,
    and the port Generator's."""
    jcfg, jparams, cfg, params = weights
    jgen = JaxGenerator(jcfg, jparams, JaxGeneratorConfig(
        ctx_len=CTX, max_new_tokens=MAX_NEW))
    margins = []
    _record_margins(jgen, margins)
    want = jgen.generate(_prompts())
    assert len(margins) == len(_prompts()) * MAX_NEW
    assert min(margins) > MARGIN, "prompts lack a greedy margin"
    got = Generator(cfg, params, GeneratorConfig(ctx_len=CTX,
                                                 max_new_tokens=MAX_NEW),
                    device="cpu").generate(_prompts())
    return want, got


def test_generator_matches_jax_generator(reference):
    want, got = reference
    assert got == want
    assert all(len(t.split()) == MAX_NEW for t in got)


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_continuous_one_shot_join_matches_generator(weights, reference,
                                                    layout, seed):
    """Randomized join/leave schedules over 3 slots; the paged layout
    joins by one-shot prefill scattered into pages of 8."""
    _, _, cfg, params = weights
    kw = dict(paged=True, page_size=8) if layout == "paged" else {}
    cont = ContinuousGenerator(
        cfg, params, GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW),
        num_slots=3, device="cpu", **kw)
    out = cont.run(_prompts(), schedule=_random_schedule(seed))
    assert out == reference[1]
    assert cont.free_slots == cont.num_slots
    if layout == "paged":
        assert cont.kv.pool.free_pages == cont.kv.pool.capacity


def test_dense_continuous_eos_exit_matches_generator_trim(weights, reference):
    """A slot leaves the moment it emits EOS; the whole-batch path trims
    at the same token."""
    _, _, cfg, params = weights
    eos = int(reference[1][0].split()[2][3:])
    g = GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW, eos_id=eos)
    want = Generator(cfg, params, g, device="cpu").generate(_prompts(4))
    cont = ContinuousGenerator(cfg, params, g, num_slots=2, device="cpu")
    assert cont.run(_prompts(4), schedule=_random_schedule(7)) == want
    assert len(want[0].split()) <= 3          # the trim actually bit


def test_dense_slot_table_capacity_and_budget(weights):
    _, _, cfg, params = weights
    cont = ContinuousGenerator(
        cfg, params, GeneratorConfig(ctx_len=CTX, max_new_tokens=2),
        num_slots=2, device="cpu")
    assert cont.join("a", "alpha") is not None
    assert cont.join("b", "beta", max_new_tokens=100) is not None
    assert cont.join("c", "gamma") is None        # table full
    assert cont.admit_capacity == 0
    cont.step()                                   # budget 2: both finish
    done = {k: toks for k, _, toks in cont.harvest()}
    assert set(done) == {"a", "b"} and len(done["b"]) == 2
    assert cont.admit_capacity == 2


# ------------------------------------------------------------- engines
def _jax_store(root):
    emb = JaxHashEmbedder(dim=32)
    store = JaxVectorStore.build(TEXTS, emb, num_partitions=4, root=root)
    store.spill(3)
    return store, emb


def _torch_store(root):
    emb = HashEmbedder(dim=32)
    store = VectorStore.build(TEXTS, emb, num_partitions=4, root=root,
                              device="cpu")
    store.spill(3)
    return store, emb


def _requests(cls, **kw):
    return [cls(rid=i, query=f"question about fact {i}", **kw)
            for i in range(N_REQ)]


def _serve_threaded(eng, reqs):
    eng.start()
    try:
        for r in reqs:
            eng.submit(r)
        done = eng.drain(len(reqs), timeout=120)
    finally:
        eng.stop()
    return sorted(done, key=lambda r: r.rid)


@pytest.fixture(scope="module")
def jax_engines(weights, tmp_path_factory):
    """The JAX whole-batch and serial engines on the mini-trace, with the
    margins of every greedy choice they made."""
    jcfg, jparams, _, _ = weights
    root = tmp_path_factory.mktemp("jax")
    g = JaxGeneratorConfig(ctx_len=ENGINE_CTX, max_new_tokens=ENGINE_NEW)
    margins = []
    gen = JaxGenerator(jcfg, jparams, g)
    _record_margins(gen, margins)
    store, emb = _jax_store(str(root / "batch"))
    eng = JaxEngine(store, emb, gen, JaxBacklogScheduler(max_batch=8),
                    JaxBacklogScheduler(max_batch=4), initial_partitions=3)
    try:
        reqs = _requests(JaxRequest, arrival=time.perf_counter())
        eng._retrieve_batch(reqs)
        eng._generate_batch(reqs)
    finally:
        eng.streamer.close()
    store, emb = _jax_store(str(root / "serial"))
    serial = _serve_threaded(
        JaxSerialEngine(store, emb, JaxGenerator(jcfg, jparams, g),
                        batch_size=4),
        _requests(JaxRequest, arrival=None))
    assert len(margins) == N_REQ * ENGINE_NEW
    assert min(margins) > MARGIN, "mini-trace lacks a greedy margin"
    return sorted(eng.completed, key=lambda r: r.rid), serial


def _same_requests(got, want):
    assert [r.rid for r in got] == list(range(N_REQ))
    for t, j in zip(got, want):
        assert len(t.retrieved) == 5
        assert t.retrieved == j.retrieved, t.rid
        assert t.output == j.output, t.rid
        assert len(t.output.split()) == ENGINE_NEW


def test_whole_batch_ragdoll_engine_matches_jax(weights, jax_engines,
                                                tmp_path):
    _, _, cfg, params = weights
    store, emb = _torch_store(str(tmp_path))
    gen = Generator(cfg, params, GeneratorConfig(
        ctx_len=ENGINE_CTX, max_new_tokens=ENGINE_NEW), device="cpu")
    eng = RagdollEngine(store, emb, gen, BacklogScheduler(max_batch=8),
                        BacklogScheduler(max_batch=4), initial_partitions=3,
                        device="cpu")
    assert eng.scheduler is None and not eng.continuous
    try:
        reqs = _requests(Request, arrival=time.perf_counter())
        eng._retrieve_batch(reqs)
        eng._generate_batch(reqs)
    finally:
        eng.streamer.close()
    _same_requests(sorted(eng.completed, key=lambda r: r.rid),
                   jax_engines[0])


def test_whole_batch_ragdoll_engine_threaded(weights, jax_engines, tmp_path):
    """The same requests through the started pipeline (two workers)."""
    _, _, cfg, params = weights
    store, emb = _torch_store(str(tmp_path))
    gen = Generator(cfg, params, GeneratorConfig(
        ctx_len=ENGINE_CTX, max_new_tokens=ENGINE_NEW), device="cpu")
    eng = RagdollEngine(store, emb, gen, BacklogScheduler(max_batch=8),
                        BacklogScheduler(max_batch=4), initial_partitions=3,
                        device="cpu")
    got = _serve_threaded(eng, _requests(Request, arrival=None))
    _same_requests(got, jax_engines[0])


def test_serial_engine_matches_jax(weights, jax_engines, tmp_path):
    _, _, cfg, params = weights
    store, emb = _torch_store(str(tmp_path))
    gen = Generator(cfg, params, GeneratorConfig(
        ctx_len=ENGINE_CTX, max_new_tokens=ENGINE_NEW), device="cpu")
    got = _serve_threaded(
        SerialRAGEngine(store, emb, gen, batch_size=4, device="cpu"),
        _requests(Request, arrival=None))
    _same_requests(got, jax_engines[1])


# ------------------------------------------------------------ launcher
@pytest.mark.parametrize("mode", [[], ["--serial"]])
def test_launch_serve_on_cpu(mode):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "3", "--rate", "600", *mode],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = res.stdout
    assert f"mode={'serial' if mode else 'ragdoll'}" in out
    for key in ("n ", "incomplete", "p50", "p99", "avg_latency"):
        assert key in out, out
    assert "  n                3" in out and "  incomplete       0" in out


# -------------------------------------------------------- no CPU fallback
def test_whole_batch_entry_points_refuse_cpu_fallback(weights, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid")
    _, _, cfg, params = weights
    with pytest.raises(RuntimeError, match="CUDA"):
        Generator(cfg, params, GeneratorConfig(), device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousGenerator(cfg, params, GeneratorConfig(), device=None)
    gen = Generator(cfg, params, GeneratorConfig(), device="cpu")
    store, emb = _torch_store(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        SerialRAGEngine(store, emb, gen, device=None)
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--requests", "1"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "CUDA" in res.stderr
