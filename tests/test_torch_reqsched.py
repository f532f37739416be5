"""Port ``RequestScheduler`` vs the reference's contracts, and the fig8
memory-pressure rows vs the JAX engine, on the CPU.

Counterparts of ``tests/test_reqsched.py``: FIFO admission at one
priority class, interactive ahead of batch, aging, the victim of
``ContinuousGenerator.swap_victim``, scheduler-driven preemption (full
and partial, inline and overlapped) token-identical to the uninterrupted
``Generator``, batch joiners never evicting interactive slots, and
parked interactive work resuming ahead of a batch backlog.

The fig8 rows ``paged_tight``, ``paged_swap``, ``paged_int8``,
``priority_mix``, ``swap_overlap``, ``prefix_off`` and ``prefix_on``
(``benchmarks/fig8_percentiles.py``) run through both engines, built with
``policy_every=2`` as fig8 builds them, single-threaded via
``pump_once``: the same retrieved chunks and tokens for every request,
and equal ``peak``, ``swaps``, ``budget`` and ``swap_bytes``; the prefix
rows (one recurring query, a ragged context of ``ctx - 2``) also equal
prefill tokens per join, hit tokens and copy-on-write copies.  Token equality is demanded
after asserting that every greedy choice of the JAX run has a top-2 gap
above 1e-3 (fp32 rows) or 2e-3 (the int8 row: its cross-framework
logits may differ by one int8 code, which ``tests/test_torch_quant.py``
measures below 2e-3).
"""
import time

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
from repro_torch.core.pipeline import StageQueue
from repro_torch.core.scheduler import BacklogScheduler
from repro_torch.retrieval import HashEmbedder, VectorStore
from repro_torch.serving import (ContinuousGenerator, Generator,
                                 GeneratorConfig, RagdollEngine, Request)
from repro_torch.serving.reqsched import RequestScheduler, request_priority

CTX, MAX_NEW = 16, 5


@pytest.fixture(scope="module")
def tiny_model():
    jcfg = jax_get_config("llama3-8b").reduced(num_layers=2)
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(1),
                                               jnp.float32)
    cfg = get_config("llama3-8b").reduced(num_layers=2)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu", dtype=torch.float32)
    return cfg, params


def _requests(prompts, priorities=None):
    out = []
    for i, p in enumerate(prompts):
        r = Request(rid=i, query=p, arrival=time.perf_counter(),
                    max_new_tokens=MAX_NEW,
                    priority=(priorities[i] if priorities else 0))
        r.prompt = p
        out.append(r)
    return out


def _prompts(n=6):
    return [f"query {i} topic{i % 3} alpha beta" for i in range(n)]


def _drive(gen, sched, queue, reqs, boundary_every=None, guard=2000):
    """``RagdollEngine.pump_once``'s loop: capacity probe -> admit ->
    tick -> step -> harvest, with a swap fence every few ticks (the
    policy boundary's barrier)."""
    queue.put_many(reqs)
    for r in reqs:
        sched.note_queued(r)
    done = {}
    tick = 0
    while len(done) < len(reqs):
        cap = sched.capacity()
        items = queue.pop_batch(cap) if cap > 0 else []
        if items:
            sched.admit(items)
        sched.tick()
        gen.step()
        for key, text, _ in gen.harvest():
            done[key.rid] = text
            sched.note_done([key])
        if boundary_every and tick % boundary_every == 0:
            gen.fence()
            assert gen.kv.outstanding == 0
        tick += 1
        assert tick < guard, "scheduler driver stalled"
    return [done[i] for i in range(len(reqs))]


# ------------------------------------------------------- fake-gen ordering
class _FakeGen:
    """Just enough generator surface for admission-order tests."""
    paged = False
    parked_slots = 0

    def __init__(self, capacity=1):
        self.admit_capacity = capacity
        self.joined = []

    def join(self, req, prompt, max_new_tokens=None):
        self.joined.append(req)
        return object()


def test_default_knobs_admission_is_fifo():
    gen, q = _FakeGen(capacity=2), StageQueue("ctx")
    sched = RequestScheduler(gen, q)
    reqs = _requests(_prompts(6))
    q.put_many(reqs)
    while len(gen.joined) < len(reqs):
        sched.admit(q.pop_batch(2))
    assert [r.rid for r in gen.joined] == [0, 1, 2, 3, 4, 5]


def test_priority_admission_order():
    gen, q = _FakeGen(capacity=2), StageQueue("ctx")
    sched = RequestScheduler(gen, q)
    reqs = _requests(_prompts(5), priorities=[0, 0, 1, 0, 1])
    q.put_many(reqs)
    while len(gen.joined) < len(reqs):
        sched.admit(q.pop_batch(2))
    assert [r.rid for r in gen.joined] == [2, 4, 0, 1, 3]


def test_aging_promotes_waiting_batch_request():
    for aging_s, first in ((1e-9, 0), (30.0, 1)):
        gen, q = _FakeGen(capacity=1), StageQueue("ctx")
        sched = RequestScheduler(gen, q, aging_s=aging_s)
        batch, inter = _requests(_prompts(2), priorities=[0, 1])
        q.put(batch)
        sched.admit([])               # registers the batch arrival time
        time.sleep(0.002)
        q.put(inter)
        sched.admit(q.pop_batch(1))
        assert gen.joined[0].rid == first, aging_s


# ------------------------------------------------------------- preemption
def test_select_victim_matches_generator_policy(tiny_model):
    cfg, params = tiny_model
    g = GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW)
    worst = -(-(CTX + MAX_NEW) // 4)
    gen = ContinuousGenerator(cfg, params, g, num_slots=3, paged=True,
                              page_size=4, page_budget=2 * worst,
                              device="cpu")
    q = StageQueue("ctx")
    sched = RequestScheduler(gen, q)
    q.put_many(_requests(_prompts(6)))
    checked = 0
    for _ in range(300):
        a, b = sched.select_victim(), gen.swap_victim()
        assert (a is None) == (b is None)
        if a is not None:
            assert a.index == b.index
            checked += 1
        cap = sched.capacity()
        if cap:
            sched.admit(q.pop_batch(cap))
        sched.tick()
        gen.step()
        gen.harvest()
        if not (len(q) or gen.active_slots or gen.parked_slots):
            break
    assert checked > 0


@pytest.mark.parametrize("partial,overlap", [(False, False), (True, False),
                                             (False, True), (True, True)])
def test_sched_preemption_token_identical(tiny_model, partial, overlap):
    cfg, params = tiny_model
    g = GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW)
    prompts = _prompts(6)
    dense = Generator(cfg, params, g, device="cpu").generate(prompts)
    worst = -(-(CTX + MAX_NEW) // 4)
    gen = ContinuousGenerator(cfg, params, g, num_slots=3, paged=True,
                              page_size=4, page_budget=2 * worst + 2,
                              overlap_swap=overlap, device="cpu")
    q = StageQueue("ctx")
    sched = RequestScheduler(gen, q, partial_swap=partial)
    shed = []
    orig_preempt = gen.preempt

    def recording_preempt(ref, pages=None):
        shed.append(pages)
        return orig_preempt(ref, pages=pages)

    gen.preempt = recording_preempt
    out = _drive(gen, sched, q, _requests(prompts), boundary_every=4)
    assert out == dense
    assert shed, "no preemption cycle actually happened"
    if partial:
        assert any(p is not None for p in shed), shed
    else:
        assert all(p is None for p in shed), shed
    assert gen.free_slots == gen.num_slots
    assert gen.kv.pool.used_pages == 0
    assert gen.kv.pool.inflight_pages == 0
    assert gen.kv.host.used_pages == 0
    assert gen.kv.outstanding == 0


def test_fence_settles_outstanding_swaps(tiny_model):
    """A fence leaves no half-applied swap: the queued copy lands and
    its pages free before the next join."""
    cfg, params = tiny_model
    g = GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW)
    gen = ContinuousGenerator(cfg, params, g, num_slots=2, paged=True,
                              page_size=4,
                              page_budget=-(-(CTX + MAX_NEW) // 4),
                              overlap_swap=True, device="cpu")
    q = StageQueue("ctx")
    sched = RequestScheduler(gen, q)
    first, joiner = _requests(_prompts(2))
    assert gen.join(first, first.prompt, MAX_NEW) is not None
    assert sched.preempt_for_join(joiner)      # swap-out queued
    assert gen.kv.outstanding >= 1
    gen.fence()
    assert gen.kv.outstanding == 0 and gen.kv.pool.inflight_pages == 0
    assert gen.join(joiner, joiner.prompt, MAX_NEW) is not None
    done = {}
    for _ in range(200):
        sched.tick()
        gen.step()
        for key, text, _ in gen.harvest():
            done[key.rid] = text
        if len(done) == 2 and not gen.parked_slots:
            break
    assert set(done) == {first.rid, joiner.rid}


def test_batch_never_evicts_interactive(tiny_model):
    cfg, params = tiny_model
    g = GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW)
    gen = ContinuousGenerator(cfg, params, g, num_slots=2, paged=True,
                              page_size=4,
                              page_budget=-(-(CTX + MAX_NEW) // 4),
                              device="cpu")
    q = StageQueue("ctx")
    sched = RequestScheduler(gen, q)
    inter, batch, inter2 = _requests(_prompts(3), priorities=[1, 0, 1])
    assert gen.join(inter, inter.prompt, MAX_NEW) is not None
    assert sched.select_victim(limit=0) is None
    assert not sched.preempt_for_join(batch)       # batch cannot evict
    assert gen.active_slots == 1
    victim = sched.select_victim(limit=1)
    assert victim is not None
    assert request_priority(gen.table.state(victim).key) == 1
    assert sched.preempt_for_join(inter2)          # same class may
    assert gen.parked_slots == 1
    assert request_priority(gen.parked_request(gen.parked_keys()[0])) == 1


def test_interactive_resumes_ahead_of_batch_backlog(tiny_model):
    cfg, params = tiny_model
    g = GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW)
    gen = ContinuousGenerator(cfg, params, g, num_slots=2, paged=True,
                              page_size=4, device="cpu")
    q = StageQueue("ctx")
    sched = RequestScheduler(gen, q)
    inter, batch, batch2 = _requests(_prompts(3), priorities=[1, 0, 0])
    assert gen.join(inter, inter.prompt, MAX_NEW) is not None
    assert gen.preempt(sched.select_victim()) is not None
    q.put(batch)
    sched.tick()
    assert gen.parked_slots == 0       # interactive resumed anyway
    while gen.active_slots:
        gen.step()
    gen.harvest()
    assert gen.join(batch2, batch2.prompt, MAX_NEW) is not None
    assert gen.preempt(sched.select_victim(limit=0)) is not None
    sched.tick()
    assert gen.parked_slots == 1       # one class: waits for the backlog
    q.pop_batch(1)
    sched.tick()
    assert gen.parked_slots == 0
    snap = sched.snapshot()
    assert snap["parked"] == 0 and snap["swap_jobs"] == 0


# ------------------------------------------------------------ fig8 rows
FIG8_ROWS = ("paged_tight", "paged_swap", "paged_int8", "priority_mix",
             "swap_overlap", "prefix_off", "prefix_on")
F_CTX, F_NEW, F_PAGE, F_SLOTS, F_REQ = 32, 4, 8, 3, 10
F_TEXTS = [f"doc {i} topic{i % 5}" for i in range(120)]


def _fig8_kw(variant, cfg):
    """The generator knobs of ``engine_rows`` in fig8_percentiles.py."""
    worst = -(-(F_CTX + F_NEW) // F_PAGE)
    if variant.startswith("prefix"):
        return dict(paged=True, prefix_cache=(variant == "prefix_on"))
    if variant == "paged_int8":
        fp32_page = F_PAGE * cfg.kv_cache_bytes_per_token(4)
        int8_page = (F_PAGE * cfg.kv_cache_bytes_per_token(1)
                     + cfg.kv_scale_bytes_per_page())
        return dict(paged=True, kv_format="int8",
                    page_budget=(2 * worst * fp32_page) // int8_page,
                    host_page_budget=F_SLOTS * worst)
    kw = dict(paged=True, page_budget=2 * worst,
              host_page_budget=(0 if variant == "paged_tight"
                                else F_SLOTS * worst))
    if variant == "swap_overlap":
        kw["overlap_swap"] = True
    return kw


def _fig8_drive(eng, reqs):
    eng._retrieve_batch(reqs)
    eng.pipeline.context_queue.put_many(reqs)
    guard = 0
    while eng.pump_once() < len(reqs):
        guard += 1
        assert guard < 100 * len(reqs), "mini-trace stalled"
    return sorted(eng.completed, key=lambda r: r.rid)


def _fig8_ctx(variant):
    """The prefix pair runs a ragged context, so the boundary-page copy
    at join and the donor tail's CoW on its first decode both run."""
    return F_CTX - 2 if variant.startswith("prefix") else F_CTX


def _fig8_query(variant, i):
    """The prefix pair asks one recurring query: identical prompts."""
    return ("recurring shared question" if variant.startswith("prefix")
            else f"query {i}")


def _row(gen, reqs):
    return dict(peak=gen.peak_in_flight, swaps=gen.swap_outs,
                swap_ins=gen.swap_ins, budget=gen.kv.pool.capacity,
                swap_bytes=gen.kv.swap_out_bytes + gen.kv.swap_in_bytes,
                ttft_tok=gen.prefill_tokens / max(gen.joins, 1),
                hit_tok=gen.prefix_hit_tokens, cow=gen.cow_copies,
                ids=[r.retrieved for r in reqs],
                tokens=[r.output for r in reqs])


def _record_margins(gen, margins):
    def gap(logits, rows):
        top2 = np.sort(np.asarray(logits)[rows], axis=-1)[:, -2:]
        margins.extend(top2[:, 1] - top2[:, 0])

    prefill, chunk, decode = gen._prefill, gen._chunk_paged, gen._decode_paged
    ctx = gen.gen_cfg.ctx_len

    def prefill_rec(p, x, c):
        logits, c = prefill(p, x, c)
        gap(logits, [0])
        return logits, c

    def chunk_rec(p, x, c, off, bt):
        logits, c = chunk(p, x, c, off, bt)
        if int(off[0]) + x.shape[1] >= ctx:       # the token-emitting chunk
            gap(logits, [0])
        return logits, c

    def decode_rec(p, x, c, pos, bt):
        live = [r.index for r in gen.table.active_refs()
                if r.index not in gen._prefilling
                and r.index not in gen._pending_resume]
        logits, c = decode(p, x, c, pos, bt)
        gap(logits, live)
        return logits, c

    gen._prefill, gen._chunk_paged, gen._decode_paged = (
        prefill_rec, chunk_rec, decode_rec)


@pytest.fixture(scope="module")
def fig8_jax(tmp_path_factory):
    cfg = jax_get_config("llama3-8b").reduced(num_layers=2)
    params = JaxModel(cfg, remat=False).init(jax.random.PRNGKey(0),
                                             jnp.float32)
    emb = JaxHashEmbedder(dim=32)
    store = JaxVectorStore.build(F_TEXTS, emb, num_partitions=4,
                                 root=str(tmp_path_factory.mktemp("jax")))
    store.spill(3)
    rows = {}
    for variant in FIG8_ROWS:
        gen = JaxGenerator(cfg, params, JaxGeneratorConfig(
            ctx_len=_fig8_ctx(variant), max_new_tokens=F_NEW),
            num_slots=F_SLOTS, page_size=F_PAGE, **_fig8_kw(variant, cfg))
        margins = []
        _record_margins(gen, margins)
        eng = JaxEngine(store, emb, gen, JaxBacklogScheduler(max_batch=8),
                        JaxBacklogScheduler(max_batch=F_SLOTS),
                        initial_partitions=3, policy_every=2)
        try:
            reqs = [JaxRequest(rid=i, query=_fig8_query(variant, i),
                               arrival=time.perf_counter(),
                               priority=(1 if variant == "priority_mix"
                                         and i >= F_REQ - 2 else 0))
                    for i in range(F_REQ)]
            rows[variant] = (_row(gen, _fig8_drive(eng, reqs)), margins)
        finally:
            eng.streamer.close()
            if gen.kv.overlap:
                gen.kv.close()
    return params, rows


@pytest.mark.parametrize("variant", FIG8_ROWS)
def test_fig8_row_matches_jax_engine(fig8_jax, variant, tmp_path):
    jparams, rows = fig8_jax
    want, margins = rows[variant]
    assert min(margins) > (2e-3 if variant == "paged_int8" else 1e-3), \
        "the row lacks a greedy margin"
    cfg = get_config("llama3-8b").reduced(num_layers=2)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu", dtype=torch.float32)
    emb = HashEmbedder(dim=32)
    store = VectorStore.build(F_TEXTS, emb, num_partitions=4,
                              root=str(tmp_path), device="cpu")
    store.spill(3)
    gen = ContinuousGenerator(cfg, params, GeneratorConfig(
        ctx_len=_fig8_ctx(variant), max_new_tokens=F_NEW),
        num_slots=F_SLOTS, page_size=F_PAGE, device="cpu",
        **_fig8_kw(variant, cfg))
    eng = RagdollEngine(store, emb, gen, BacklogScheduler(max_batch=8),
                        BacklogScheduler(max_batch=F_SLOTS),
                        initial_partitions=3, partial_swap=False,
                        policy_every=2, device="cpu")
    try:
        reqs = [Request(rid=i, query=_fig8_query(variant, i),
                        arrival=time.perf_counter(),
                        priority=(1 if variant == "priority_mix"
                                  and i >= F_REQ - 2 else 0))
                for i in range(F_REQ)]
        got = _row(gen, _fig8_drive(eng, reqs))
    finally:
        eng.streamer.close()
    assert all(len(ids) == 5 for ids in got["ids"])
    assert got == want
    assert gen.parked_slots == 0 and gen.kv.outstanding == 0
    if variant != "paged_tight":
        assert got["swaps"] == got["swap_ins"]
    if variant in ("paged_swap", "swap_overlap", "priority_mix"):
        assert got["swaps"] > 0
    if variant == "prefix_on":
        off = rows["prefix_off"][0]
        assert got["ttft_tok"] < off["ttft_tok"]
        assert got["hit_tok"] > 0 and got["cow"] > 0
        assert got["tokens"] == off["tokens"]
