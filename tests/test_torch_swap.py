"""Port swap-to-host preemption vs uninterrupted generation, on the CPU.

Counterparts of ``tests/test_swap.py`` (all but the streamed ones, in
``tests/test_torch_streamed.py``, and the pool-resize ones, in
``tests/test_torch_resize.py``), ``tests/test_quant_kv.py``'s int8 swap round trip and
scale survival, and the conservation laws of ``tests/test_swap_pool.py``
and ``tests/test_reqsched_pool.py`` as hypothesis properties:

* forced preempt/resume cycles, full and partial, inline and overlapped,
  on randomized join schedules, give the tokens of the port's
  uninterrupted whole-batch ``Generator``, which gives the JAX one's;
* the port's ``PagePool`` and ``HostPagePool`` follow the JAX ones step for
  step through random interleavings, never leak or double-lease a page,
  and keep free + referenced + in flight == capacity;
* ``PagePool.swap_in`` on a key that still holds pages raises, as its
  docstring says (the reference does not: ROADMAP queue 3).

Weights: ``PRNGKey(1)``, whose every greedy choice on these prompts has a
top-2 gap above 1e-3 (``tests/test_torch_serve_batch.py``).
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from hypothesis import given, settings, strategies as st

from repro.configs import get_config as jax_get_config
from repro.models.model import Model as JaxModel
from repro.serving.generator import Generator as JaxGenerator
from repro.serving.generator import GeneratorConfig as JaxGeneratorConfig
from repro.serving.kvpool import HostPagePool as JaxHostPagePool
from repro.serving.kvpool import PagePool as JaxPagePool

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.scheduler import BacklogScheduler
from repro_torch.models.model import make_cache_specs
from repro_torch.retrieval import HashEmbedder, VectorStore
from repro_torch.serving import (ContinuousGenerator, Generator,
                                 GeneratorConfig, RagdollEngine, Request)
from repro_torch.serving.generator import StaleSlotError
from repro_torch.serving.kvpool import (TRASH_PAGE, HostPagePool,
                                        PagedKVCache, PageExhausted,
                                        PagePool)

CTX, MAX_NEW = 16, 5


@pytest.fixture(scope="module")
def tiny_model():
    jcfg = jax_get_config("llama3-8b").reduced(num_layers=2)
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(1),
                                               jnp.float32)
    cfg = get_config("llama3-8b").reduced(num_layers=2)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu", dtype=torch.float32)
    return cfg, params, jcfg, jparams


@pytest.fixture(scope="module")
def dense_ref(tiny_model):
    """The port's uninterrupted whole-batch tokens, checked against the
    JAX ``Generator``'s on the same weights."""
    cfg, params, jcfg, jparams = tiny_model
    prompts = _prompts()
    out = Generator(cfg, params, GeneratorConfig(
        ctx_len=CTX, max_new_tokens=MAX_NEW), device="cpu").generate(prompts)
    jout = JaxGenerator(jcfg, jparams, JaxGeneratorConfig(
        ctx_len=CTX, max_new_tokens=MAX_NEW)).generate(prompts)
    assert out == jout
    return out


def _prompts(n=6):
    return [f"query {i} topic{i % 3} alpha beta" for i in range(n)]


def _random_schedule(seed, ticks=40, max_joins=3):
    rng = np.random.default_rng(seed)
    return [int(rng.integers(0, max_joins)) for _ in range(ticks)]


def _run_with_preemption(cont, prompts, preempt_every=3, park_ticks=2,
                         schedule=None, pages=None):
    """Forcibly preempt a victim every few ticks (``pages``: shed that
    many of its coldest pages) and resume it a couple of ticks later.
    Returns (results, completed preempt/resume cycles)."""
    pending = list(enumerate(prompts))[::-1]
    results = [None] * len(prompts)
    parked = []                      # (due_tick, handle)
    tick = cycles = 0
    while pending or cont.active_slots or cont.parked_slots:
        for due, handle in list(parked):
            if tick >= due and cont.resume(handle) is not None:
                parked.remove((due, handle))
                cycles += 1
        allow = len(pending)
        if schedule is not None and tick < len(schedule):
            allow = min(allow, schedule[tick])
        joined = 0
        while pending and joined < allow and cont.admit_capacity > 0:
            key, prompt = pending.pop()
            assert cont.join(key, prompt) is not None
            joined += 1
        if tick % preempt_every == preempt_every - 1:
            victim = cont.swap_victim()
            if victim is not None:
                shed = None
                if pages is not None:
                    shed = min(pages, len(cont.kv.pool.table(victim.index)))
                handle = cont.preempt(victim, pages=shed)
                if handle is not None:
                    parked.append((tick + park_ticks, handle))
        cont.step()
        for key, text, _ in cont.harvest():
            results[key] = text
        tick += 1
        assert tick < 500, "preemption driver stalled"
    assert all(r is not None for r in results)
    return results, cycles


def _drained(cont):
    assert cont.free_slots == cont.num_slots
    assert cont.kv.pool.used_pages == 0
    assert cont.kv.pool.reserved_pages == 0
    assert cont.kv.pool.inflight_pages == 0
    assert cont.kv.host.used_pages == 0
    assert cont.kv.outstanding == 0


# ---------------------------------------------------------------- equivalence
@pytest.mark.parametrize("seed,pages,overlap", [
    (0, None, False), (1, None, False), (2, None, False),
    (0, 2, False), (1, None, True), (2, 2, True)])
def test_preempt_resume_token_identical(tiny_model, dense_ref, seed, pages,
                                        overlap):
    """Forced preempt/resume cycles (full or partial, inline or
    overlapped) on randomized join schedules never change greedy
    outputs vs the uninterrupted whole-batch reference."""
    cfg, params = tiny_model[:2]
    g = GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW)
    cont = ContinuousGenerator(cfg, params, g, num_slots=3, paged=True,
                               page_size=4, overlap_swap=overlap,
                               device="cpu")
    out, cycles = _run_with_preemption(cont, _prompts(), pages=pages,
                                       schedule=_random_schedule(seed))
    assert out == dense_ref
    assert cycles > 0, "no preemption cycle actually happened"
    assert cont.swap_outs == cont.swap_ins and cont.swap_outs >= cycles
    _drained(cont)


def test_preempt_with_chunked_prefill_interleaved(tiny_model, dense_ref):
    """Preemption composes with chunked prefill: mid-chunk joiners are
    never preemptible, finished slots are, outputs stay identical."""
    cfg, params = tiny_model[:2]
    g = GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW)
    cont = ContinuousGenerator(cfg, params, g, num_slots=3, paged=True,
                               page_size=4, prefill_chunk=7, device="cpu")
    out, cycles = _run_with_preemption(cont, _prompts(),
                                       schedule=_random_schedule(11))
    assert out == dense_ref
    assert cycles > 0


def test_preempted_ref_is_stale_and_resume_mints_fresh_lease(tiny_model):
    cfg, params = tiny_model[:2]
    g = GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW)
    cont = ContinuousGenerator(cfg, params, g, num_slots=2, paged=True,
                               page_size=4, device="cpu")
    old = cont.join("x", "alpha beta")
    handle = cont.preempt(old)
    assert handle is not None
    assert (cont.kv._tab[old.index] == TRASH_PAGE).all()
    with pytest.raises(StaleSlotError):
        cont.table.advance(old, token=0)
    fresh = cont.resume(handle)
    assert fresh is not None
    assert fresh.epoch != old.epoch or fresh.index != old.index
    with pytest.raises(StaleSlotError):          # stale across the resume
        cont.table.advance(old, token=0)
    while cont.active_slots:
        cont.step()
    ((key, _, tokens),) = cont.harvest()
    assert key == "x" and len(tokens) == MAX_NEW


def test_preempt_rejects_prefilling_and_host_exhaustion(tiny_model):
    cfg, params = tiny_model[:2]
    g = GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW)
    cont = ContinuousGenerator(cfg, params, g, num_slots=2, paged=True,
                               page_size=4, host_page_budget=0,
                               device="cpu")
    ref = cont.join("a", "alpha")
    assert cont.swap_victim() is not None
    assert cont.preempt(ref) is None             # no host pages
    assert cont.active_slots == 1                # slot untouched, still live
    chunky = ContinuousGenerator(cfg, params, g, num_slots=2, paged=True,
                                 page_size=4, prefill_chunk=7, device="cpu")
    ref = chunky.join("b", "beta")
    assert ref.index in chunky._prefilling
    assert chunky.swap_victim() is None
    assert chunky.preempt(ref) is None


def test_host_pool_resize_never_drops_parked_pages(tiny_model):
    cfg, params = tiny_model[:2]
    g = GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW)
    cont = ContinuousGenerator(cfg, params, g, num_slots=2, paged=True,
                               page_size=4, device="cpu")
    cont.join("a", "alpha beta")
    handle = cont.preempt(cont.swap_victim())
    assert handle is not None
    held = cont.kv.host.used_pages
    assert held > 0
    assert cont.set_host_page_budget(0) >= held      # clamped
    assert cont.resume(handle) is not None
    while cont.active_slots:
        cont.step()
    ((key, _, tokens),) = cont.harvest()
    assert key == "a" and len(tokens) == MAX_NEW
    assert cont.set_host_page_budget(0) == 0         # empty pool may vanish


def test_overlap_keeps_resuming_slot_out_of_decode(tiny_model):
    """With overlap, a resumed slot stays out of decode (all-trash row)
    until ``step`` polls its copy in; freed pages stay in flight until
    their copy is polled."""
    cfg, params = tiny_model[:2]
    g = GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW)
    cont = ContinuousGenerator(cfg, params, g, num_slots=2, paged=True,
                               page_size=4, overlap_swap=True, device="cpu")
    ref = cont.join("a", "alpha beta")
    held = len(cont.kv.pool.table(ref.index))
    handle = cont.preempt(ref)
    assert cont.kv.pool.inflight_pages == held
    assert cont.kv.outstanding == 1
    fresh = cont.resume(handle)
    assert fresh is not None and fresh.index in cont.pending_resumes
    assert (cont.kv._tab[fresh.index] == TRASH_PAGE).all()
    tokens_before = len(cont.table.state(fresh).tokens)
    cont.step()          # polls both jobs, then decodes the slot
    assert not cont.pending_resumes and cont.kv.outstanding == 0
    assert cont.kv.pool.inflight_pages == 0
    assert len(cont.table.state(fresh).tokens) == tokens_before + 1
    assert cont.kv.swap_stall_s == 0.0


def test_int8_swap_roundtrip_token_identity(tiny_model):
    """Preempt/resume cycles on an int8 pool move the int8 payload and
    the fp32 scale rows together, so outputs do not change; the byte
    counters report whole int8 pages."""
    cfg, params = tiny_model[:2]
    g = GeneratorConfig(ctx_len=16, max_new_tokens=5)
    base = ContinuousGenerator(cfg, params, g, num_slots=3, paged=True,
                               page_size=4, kv_format="int8",
                               device="cpu").run(_prompts())
    for overlap in (False, True):
        cont = ContinuousGenerator(cfg, params, g, num_slots=3, paged=True,
                                   page_size=4, kv_format="int8",
                                   overlap_swap=overlap, device="cpu")
        got, cycles = _run_with_preemption(cont, _prompts())
        assert cycles >= 1
        assert got == base
        page_nbytes = cont.kv.page_nbytes(cont.cache)
        assert cont.kv.swap_out_bytes > 0 and cont.kv.swap_in_bytes > 0
        assert cont.kv.swap_out_bytes % page_nbytes == 0
        assert cont.kv.swap_in_bytes % page_nbytes == 0
        _drained(cont)


def test_engine_swap_admits_beyond_page_budget(tiny_model, tmp_path):
    """Swap-aware admission through ``pump_once`` pushes more concurrent
    requests through a starved page budget than the budget alone holds
    (fig8's ``paged_swap`` vs ``paged_tight``)."""
    cfg, params = tiny_model[:2]
    g = GeneratorConfig(ctx_len=CTX, max_new_tokens=4)
    worst = -(-(CTX + 4) // 4)
    peaks = {}
    emb = HashEmbedder(dim=16)
    texts = [f"doc {i}" for i in range(40)]
    store = VectorStore.build(texts, emb, num_partitions=4,
                              root=str(tmp_path), device="cpu")
    for label, host in (("tight", 0), ("swap", 3 * worst)):
        gen = ContinuousGenerator(cfg, params, g, num_slots=3, paged=True,
                                  page_size=4, page_budget=2 * worst,
                                  host_page_budget=host, device="cpu")
        eng = RagdollEngine(store, emb, gen, BacklogScheduler(max_batch=8),
                            BacklogScheduler(max_batch=3), device="cpu")
        try:
            reqs = [Request(rid=i, query=f"query {i}",
                            arrival=time.perf_counter()) for i in range(5)]
            eng._retrieve_batch(reqs)
            eng.pipeline.context_queue.put_many(reqs)
            guard = 0
            while eng.pump_once() < len(reqs):
                guard += 1
                assert guard < 500, label
        finally:
            eng.streamer.close()
        assert all(r.done and r.output for r in eng.completed)
        peaks[label] = gen.peak_in_flight
        if label == "swap":
            assert gen.swap_outs > 0 and gen.swap_ins > 0
        assert gen.parked_slots == 0
        _drained(gen)
    assert peaks["swap"] > peaks["tight"], peaks


# ------------------------------------------------------- pool bookkeeping
SWAP_OPS = st.lists(
    st.tuples(st.sampled_from(["admit", "ensure", "grow", "release",
                               "swap_out", "swap_in", "cancel",
                               "resize_host"]),
              st.integers(min_value=0, max_value=9),
              st.integers(min_value=0, max_value=40)),
    max_size=80)


def _two_tier_invariants(pool, host, lengths, swapped):
    leased = [p for k in pool.holders() for p in pool.table(k)]
    assert len(leased) == len(set(leased))
    assert TRASH_PAGE not in leased
    assert all(1 <= p <= pool.capacity for p in leased)
    assert pool.free_pages + pool.used_pages == pool.capacity
    assert pool.reserved_pages <= pool.free_pages
    held = [p for k in host.holders() for p in host.pages(k)]
    assert len(held) == len(set(held))
    assert all(0 <= p < host.capacity for p in held)
    assert host.free_pages + host.used_pages == host.capacity
    assert not set(pool.holders()) & set(host.holders())
    assert set(pool.holders()) == set(lengths)
    assert set(host.holders()) == set(swapped)
    for k in pool.holders():
        assert len(pool.table(k)) == pool.blocks_for(lengths[k])
    for k in host.holders():
        assert len(host.pages(k)) == pool.blocks_for(swapped[k])


def _same_state(pool, jpool, host, jhost):
    assert sorted(pool.holders()) == sorted(jpool.holders())
    for k in pool.holders():
        assert pool.table(k) == jpool.table(k)
        assert pool.reservation(k) == jpool.reservation(k)
    assert pool.free_pages == jpool.free_pages
    for k in host.holders():
        assert host.pages(k) == jhost.pages(k)
    assert host.capacity == jhost.capacity


@given(cap=st.integers(min_value=1, max_value=12),
       hcap=st.integers(min_value=0, max_value=10),
       page=st.integers(min_value=1, max_value=8), ops=SWAP_OPS)
@settings(max_examples=120, deadline=None)
def test_swap_interleavings_never_leak_or_match_reference(cap, hcap, page,
                                                          ops):
    """Admit / ensure / release / swap_out / swap_in / cancel / host
    resize: no leak or double lease on either tier, the tiers disjoint,
    the table-length law across remaps, and the same state as the JAX
    pools after every op."""
    pool, jpool = PagePool(cap, page), JaxPagePool(cap, page)
    host, jhost = HostPagePool(hcap, page), JaxHostPagePool(hcap, page)
    lengths, swapped = {}, {}
    nxt = 0
    for op, pick, amount in ops:
        if op == "admit":
            ok = pool.admit(nxt, amount)
            assert ok == jpool.admit(nxt, amount)
            if ok:
                lengths[nxt] = min(amount, page)
                pool.ensure(nxt, lengths[nxt])
                jpool.ensure(nxt, lengths[nxt])
            nxt += 1
        elif op in ("ensure", "grow") and lengths:
            k = sorted(lengths)[pick % len(lengths)]
            want = lengths[k] + amount
            try:
                pool.ensure(k, want)
                jpool.ensure(k, want)
                lengths[k] = max(lengths[k], want)
            except PageExhausted:
                pass
        elif op == "release" and lengths:
            k = sorted(lengths)[pick % len(lengths)]
            pool.release(k)
            jpool.release(k)
            del lengths[k]
            with pytest.raises(KeyError):
                pool.release(k)
        elif op == "swap_out" and lengths:
            k = sorted(lengths)[pick % len(lengths)]
            blocks = len(pool.table(k))
            got = host.acquire(k, blocks, reserve=pool.reservation(k))
            assert (got is None) == (jhost.acquire(
                k, blocks, reserve=jpool.reservation(k)) is None)
            if got is None:
                assert not host.can_hold(blocks)
            else:
                pages, res = pool.swap_out(k)
                assert (pages, res) == jpool.swap_out(k)
                assert len(pages) == blocks and res == host.reservation(k)
                swapped[k] = lengths.pop(k)
        elif op == "swap_in" and swapped:
            k = sorted(swapped)[pick % len(swapped)]
            new = pool.swap_in(k, len(host.pages(k)), host.reservation(k))
            assert new == jpool.swap_in(k, len(jhost.pages(k)),
                                        jhost.reservation(k))
            if new is not None:
                host.release(k)
                jhost.release(k)
                lengths[k] = swapped.pop(k)
        elif op == "cancel" and swapped:
            k = sorted(swapped)[pick % len(swapped)]
            host.release(k)
            jhost.release(k)
            del swapped[k]
            with pytest.raises(KeyError):
                host.release(k)
        elif op == "resize_host":
            got = host.resize(amount)
            assert got == jhost.resize(amount)
            held = [p for ks in host.holders() for p in host.pages(ks)]
            assert got >= max(held, default=-1) + 1   # never drops KV
        _two_tier_invariants(pool, host, lengths, swapped)
        _same_state(pool, jpool, host, jhost)


@given(cap=st.integers(min_value=2, max_value=16),
       page=st.integers(min_value=1, max_value=4),
       ln=st.integers(min_value=1, max_value=30))
@settings(max_examples=80, deadline=None)
def test_swapped_out_pages_reissuable_immediately(cap, page, ln):
    pool = PagePool(cap, page)
    host = HostPagePool(cap, page)
    if not pool.admit("victim", ln):
        return
    pool.ensure("victim", ln)
    before = pool.available_pages
    old_pages, res = pool.swap_out("victim")
    assert host.acquire("victim", len(old_pages), res) is not None
    assert pool.available_pages == before + len(old_pages) + res
    assert pool.admit("joiner", ln)
    pool.ensure("joiner", ln)
    assert len(pool.table("joiner")) == pool.blocks_for(ln)
    if pool.swap_in("victim", len(old_pages), res) is None:
        pool.release("joiner")
        assert pool.swap_in("victim", len(old_pages), res) is not None
    assert len(pool.table("victim")) == len(old_pages)


INFLIGHT_OPS = st.lists(
    st.tuples(st.sampled_from(["admit", "ensure", "release", "park",
                               "complete", "unpark", "hold",
                               "drop_hold"]),
              st.integers(min_value=0, max_value=9),
              st.integers(min_value=0, max_value=40)),
    max_size=100)


def _conservation(pool, parked, holds):
    cap = pool.capacity
    free = set(pool._free)
    referenced = {p for p in range(1, cap + 1) if pool.refcount(p) > 0}
    inflight = {p for p in range(1, cap + 1) if pool.is_inflight(p)}
    assert len(free) + len(referenced) + len(inflight) == cap
    assert not free & (referenced | inflight)
    assert not referenced & inflight
    assert pool.referenced_pages == len(referenced)
    assert pool.inflight_pages == len(inflight)
    leased = [p for k in pool.holders() for p in pool.table(k)]
    assert len(leased) == len(set(leased))
    assert TRASH_PAGE not in leased
    for k, st_ in parked.items():
        if ("tail", k) in pool.holders():
            assert len(pool.table(("tail", k))) == st_["tail"]
        else:
            assert st_["tail"] == 0
        for p in st_["inflight"]:
            assert pool.is_inflight(p)
    for p in holds:
        assert pool.refcount(p) >= 1
    assert pool.reserved_pages <= pool.free_pages


@given(cap=st.integers(min_value=1, max_value=14),
       page=st.integers(min_value=1, max_value=8), ops=INFLIGHT_OPS)
@settings(max_examples=120, deadline=None)
def test_inflight_interleavings_conserve_pages(cap, page, ops):
    """Partial parks (inline and in flight), landings, unparks and
    standalone holds: free + referenced + in flight == capacity, the
    three disjoint, and the pool drains back to all free."""
    pool = PagePool(cap, page)
    lengths, parked, holds = {}, {}, []
    nxt = 0
    for op, pick, amount in ops:
        if op == "admit":
            if pool.admit(nxt, amount):
                lengths[nxt] = min(amount, page)
                pool.ensure(nxt, lengths[nxt])
            nxt += 1
        elif op == "ensure" and lengths:
            k = sorted(lengths)[pick % len(lengths)]
            want = lengths[k] + amount
            try:
                pool.ensure(k, want)
                lengths[k] = max(lengths[k], want)
            except PageExhausted:
                pass
        elif op == "release" and lengths:
            k = sorted(lengths)[pick % len(lengths)]
            pool.release(k)
            del lengths[k]
        elif op == "park" and lengths:
            k = sorted(lengths)[pick % len(lengths)]
            tab = pool.table(k)
            blocks = amount % (len(tab) + 1)
            inflight = bool(pick % 2)
            cold, _ = pool.park(k, ("tail", k), blocks=blocks,
                                inflight=inflight)
            assert cold == tab[:blocks]
            parked[k] = {"tail": len(tab) - blocks, "blocks": blocks,
                         "inflight": list(cold) if inflight else []}
            del lengths[k]
        elif op == "complete" and parked:
            k = sorted(parked)[pick % len(parked)]
            shed = parked[k]["inflight"]
            if shed:
                pool.complete_inflight(shed)
                for p in shed:
                    with pytest.raises(ValueError):
                        pool.complete_inflight([p])
                parked[k]["inflight"] = []
        elif op == "unpark" and parked:
            k = sorted(parked)[pick % len(parked)]
            if parked[k]["inflight"]:
                continue                          # the copy lands first
            blocks, tail = parked[k]["blocks"], parked[k]["tail"]
            new = pool.unpark(("tail", k), k, blocks)
            if new is not None:
                assert len(new) == blocks
                assert len(pool.table(k)) == blocks + tail
                del parked[k]
                lengths[k] = (blocks + tail) * page
        elif op == "hold":
            got = pool.grab(1)
            if got is not None:
                holds.extend(got)
        elif op == "drop_hold" and holds:
            pool.decref(holds.pop(pick % len(holds)))
        _conservation(pool, parked, holds)
    for k in list(lengths):
        pool.release(k)
    for k, st_ in list(parked.items()):
        if st_["inflight"]:
            pool.complete_inflight(st_["inflight"])
        if ("tail", k) in pool.holders():
            pool.release(("tail", k))
    for p in holds:
        pool.decref(p)
    assert pool.used_pages == 0 and pool.inflight_pages == 0
    assert pool.free_pages == pool.capacity


def test_host_pool_validates():
    with pytest.raises(ValueError):
        HostPagePool(-1, 2)
    with pytest.raises(ValueError):
        HostPagePool(2, 0)
    host = HostPagePool(0, 2)            # no c_cpu share: no swap
    assert host.acquire("k", 1) is None
    assert host.acquire("k", 0) == []    # degenerate zero-block park
    with pytest.raises(ValueError):
        host.acquire("k", 1)             # already a holder
    host.release("k")


def test_pool_swap_in_on_a_holder_raises_and_changes_nothing():
    """The documented contract of ``PagePool.swap_in``: a key that still
    holds device pages raises, and the refused call leaves its table."""
    pool = PagePool(4, 2)
    pool.admit("k", 2)
    pool.ensure("k", 2)
    before = (pool.table("k"), pool.free_pages, pool.reservation("k"))
    with pytest.raises(ValueError):
        pool.swap_in("k", 1)
    assert (pool.table("k"), pool.free_pages,
            pool.reservation("k")) == before
    with pytest.raises(ValueError):
        pool.unpark("other", "k", 1)


# ---------------------------------------------- scales survive preemption
def _slot_view(kv, pools, slot):
    tab = torch.tensor(kv.pool.table(slot), dtype=torch.long)
    return [leaf[tab].clone() for layer in pools["blocks"]
            for leaf in layer.values()]


@given(seed=st.integers(0, 2 ** 16),
       ops_seq=st.lists(st.sampled_from(["swap", "partial", "cow",
                                         "write"]),
                        min_size=1, max_size=8),
       overlap=st.booleans())
@settings(max_examples=25, deadline=None)
def test_scales_survive_preempt_resume(seed, ops_seq, overlap):
    """Whatever interleaving of full and partial preempt/resume round
    trips, copy-on-write detaches and further quantized appends a slot
    goes through, its pages (int8 payload and fp32 scale rows) read back
    bit-identically (``test_scales_survive_preempt_resume_and_cow`` of
    ``tests/test_quant_kv.py``)."""
    cfg = get_config("llama3-8b").reduced(num_layers=1)
    kv = PagedKVCache(cfg, num_slots=2, total_len=16, page_size=4,
                      kv_format="int8", overlap=overlap, device="cpu")
    pools = kv.init_stacked()
    rng = np.random.default_rng(seed)
    row_spec = make_cache_specs(cfg, 1, 16, torch.float32)

    def write(length):
        row = {"blocks": [{name: torch.from_numpy(
                   rng.normal(size=shape).astype(np.float32))
                   for name, (shape, _) in layer.items()}
                   for layer in row_spec["blocks"]]}
        kv.scatter_row_stacked(pools, row, 0, length)

    assert kv.admit(0, 16)
    write(int(rng.integers(1, 17)))
    snap = _slot_view(kv, pools, 0)
    for op in ops_seq:
        if op in ("swap", "partial"):
            held = len(kv.pool.table(0))
            shed = int(rng.integers(0, held + 1)) if op == "partial" else None
            assert kv.swap_out(pools, 0, "h0", pages=shed)
            assert (kv._tab[0] == TRASH_PAGE).all()
            assert kv.swap_in(pools, 0, "h0")
            kv.fence()
        elif op == "cow":
            kv.fence()                # the slot's row is live again
            block = int(rng.integers(0, len(kv.pool.table(0))))
            page = kv.pool.table(0)[block]
            kv.pool.incref(page)      # a prefix cache's hold
            try:
                assert kv.cow_block(pools, 0, block)
                assert kv.pool.table(0)[block] != page
                assert kv._tab[0, block] == kv.pool.table(0)[block]
            finally:
                kv.pool.decref(page)
        else:
            write(int(rng.integers(1, 17)))
            snap = _slot_view(kv, pools, 0)
        for a, b in zip(snap, _slot_view(kv, pools, 0)):
            assert torch.equal(a, b)
        assert kv.pool.inflight_pages == 0 and kv.outstanding == 0
