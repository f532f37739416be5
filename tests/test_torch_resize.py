"""Port capacity resize (slot table, device page pool, dense rows) vs the
JAX package, on the CPU.

Counterparts of ``tests/test_paged.py``'s dynamic-resize tests, of
``tests/test_swap.py::test_swap_in_after_resize_preserves_trash_isolation``
and of ``tests/test_swap_pool.py::test_swap_in_after_resize_remaps_consistently``:
capacity grows and shrinks between steps, with slots parked on the host
across the resize, and the tokens stay those of the JAX generator driven
the same way and of the uncached whole-batch ``Generator``.  Also:
``resize_pages`` cuts the pool tensors into fresh ones (the dropped
pages' bytes are given back), ``set_page_budget`` demotes cached prefix
pages before it shrinks, and ``retarget`` applies all four budgets as the
reference's does.  Weights ``PRNGKey(1)`` (top-2 gaps above 1e-3 on these
prompts, ``tests/test_torch_swap.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from hypothesis import given, settings, strategies as st

from repro.configs import get_config as jax_get_config
from repro.models.model import Model as JaxModel
from repro.serving.generator import ContinuousGenerator as JaxGenerator
from repro.serving.generator import GeneratorConfig as JaxGeneratorConfig
from repro.serving.kvpool import PagePool as JaxPagePool

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.serving import (ContinuousGenerator, Generator,
                                 GeneratorConfig)
from repro_torch.serving.generator import SlotTable, StaleSlotError
from repro_torch.serving.kvpool import (TRASH_PAGE, HostPagePool,
                                        PagedKVCache, PagePool)

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


def _prompts(n=6):
    return [f"query {i} topic{i % 3} alpha beta" for i in range(n)]


def _pair(tiny_model, **kw):
    cfg, params, jcfg, jparams = tiny_model
    jgen = JaxGenerator(jcfg, jparams, JaxGeneratorConfig(
        ctx_len=CTX, max_new_tokens=MAX_NEW), **kw)
    gen = ContinuousGenerator(cfg, params, GeneratorConfig(
        ctx_len=CTX, max_new_tokens=MAX_NEW), device="cpu", **kw)
    return jgen, gen


def _dense(tiny_model, prompts):
    cfg, params, _, _ = tiny_model
    return Generator(cfg, params, GeneratorConfig(
        ctx_len=CTX, max_new_tokens=MAX_NEW), device="cpu").generate(prompts)


# ------------------------------------------------------------ slot table
def test_slot_table_resize_invariants():
    t = SlotTable(4)
    a = t.acquire("a", pos=0, remaining=2)
    assert t.resize(8) == 8
    assert t.free_slots == 7 and t.capacity == 8
    # a shrink clamps to one past the highest active lease
    b = t.acquire("b", pos=0, remaining=2)       # slot 1
    assert t.resize(1) == 2
    assert t.free_slots == 0 and t.active_slots == 2
    t.release(a)
    t.release(b)
    assert t.resize(1) == 1 and t.free_slots == 1
    assert t.mask().tolist() == [False]


def test_slot_table_stale_ref_survives_shrink_grow_cycle():
    """Epoch counters survive a resize, so a SlotRef kept across a shrink
    and grow cycle never validates against a fresh lease of the re-grown
    slot."""
    t = SlotTable(4)
    for i in range(3):
        t.acquire(f"pad{i}", pos=0, remaining=2)
    old = t.acquire("x", pos=0, remaining=2)     # slot 3, epoch 0
    t.release(old)                               # slot 3 -> epoch 1
    assert t.resize(3) == 3                      # drops free slot 3
    assert t.resize(4) == 4                      # re-grows it
    fresh = t.acquire("y", pos=0, remaining=2)   # slot 3 again
    assert fresh.index == old.index
    assert fresh.epoch != old.epoch
    with pytest.raises(StaleSlotError):
        t.advance(old, token=0)


# ------------------------------------------------------------- generator
def _resize_run(cont, prompts, paged):
    pending = list(enumerate(prompts))[::-1]
    results = [None] * len(prompts)
    tick = 0
    while pending or cont.active_slots:
        if tick == 2:
            assert cont.resize(4) == 4           # grow mid-flight
            if paged:
                cont.set_page_budget(cont.kv.pool.capacity + 8)
        if tick == 6:
            cont.resize(2)                       # shrink, clamped to live
        while pending and cont.admit_capacity > 0:
            key, prompt = pending.pop()
            assert cont.join(key, prompt) is not None
        cont.step()
        for key, text, _ in cont.harvest():
            results[key] = text
        tick += 1
        assert tick < 300
    return results


@pytest.mark.parametrize("paged", [True, False])
def test_generator_resize_mid_flight(tiny_model, paged):
    """Capacity grows and shrinks between steps without touching live
    sequences; dense rows are padded and cut (``resize_cache_rows``)."""
    prompts = _prompts()
    kw = dict(paged=True, page_size=4) if paged else {}
    jgen, gen = _pair(tiny_model, num_slots=2, **kw)
    out = _resize_run(gen, prompts, paged)
    assert out == _resize_run(jgen, prompts, paged)
    assert out == _dense(tiny_model, prompts)
    assert gen.free_slots == gen.num_slots == jgen.num_slots
    assert gen.steps == jgen.steps
    if paged:
        assert gen.kv.pool.capacity == jgen.kv.pool.capacity
        assert gen.kv._tab.shape == jgen.kv._tab.shape
    else:
        k = gen.cache["blocks"][0]["k"]
        assert k.shape[0] == gen.num_slots
        assert k.untyped_storage().nbytes() == k.numel() * k.element_size()


def _resize_under_parked(cont, prompts):
    """Park a victim at tick 3, grow then shrink the pool under it, resume
    onto the resized pool and keep recycling slots through it."""
    pending = list(enumerate(prompts))[::-1]
    results = [None] * len(prompts)
    parked, caps = [], []
    tick = 0
    while pending or cont.active_slots or cont.parked_slots:
        if tick == 3:
            victim = cont.swap_victim()
            if victim is not None:
                h = cont.preempt(victim)
                if h is not None:
                    parked.append(h)
                    assert (cont.kv._tab[victim.index] == TRASH_PAGE).all()
            grown = cont.set_page_budget(cont.kv.pool.capacity + 10)
            assert grown == cont.kv.pool.capacity
            caps.append(grown)
        if tick == 5:
            caps.append(cont.set_page_budget(
                max(cont.kv.pool.capacity - 10, 1)))
        if tick >= 5:
            for h in list(parked):
                if cont.resume(h) is not None:
                    parked.remove(h)
        while pending and cont.admit_capacity > 0:
            key, prompt = pending.pop()
            assert cont.join(key, prompt) is not None
        cont.step()
        for key, text, _ in cont.harvest():
            results[key] = text
        tick += 1
        assert tick < 300
    return results, caps


def test_swap_in_after_resize_preserves_trash_isolation(tiny_model):
    """Resize the device pool while a slot is parked on the host, resume
    onto the resized pool: the same tokens and capacities as the JAX run,
    parked and freed rows trash-mapped, the pools drained."""
    prompts = _prompts()
    jgen, gen = _pair(tiny_model, num_slots=2, paged=True, page_size=2)
    out, caps = _resize_under_parked(gen, prompts)
    jout, jcaps = _resize_under_parked(jgen, prompts)
    assert out == jout == _dense(tiny_model, prompts)
    assert caps == jcaps
    assert gen.swap_outs == jgen.swap_outs >= 1
    assert (gen.kv._tab == TRASH_PAGE).all()
    assert gen.kv.pool.used_pages == 0 and gen.kv.host.used_pages == 0
    pool = gen.cache["blocks"][0]["k"]
    assert pool.shape[0] == gen.kv.array_pages


@given(cap=st.integers(min_value=2, max_value=12),
       page=st.integers(min_value=1, max_value=4),
       ln=st.integers(min_value=1, max_value=20),
       targets=st.lists(st.integers(min_value=1, max_value=30),
                        min_size=1, max_size=6))
@settings(max_examples=80, deadline=None)
def test_swap_in_after_resize_remaps_consistently(cap, page, ln, targets):
    """Device-pool resizes while a slot is parked never break the remap:
    swap_in lands on ids valid for the current capacity, as the JAX
    pool's does."""
    pool, jpool = PagePool(cap, page), JaxPagePool(cap, page)
    host = HostPagePool(cap, page)
    if not pool.admit("a", ln):
        assert not jpool.admit("a", ln)
        return
    jpool.admit("a", ln)
    pool.ensure("a", ln)
    jpool.ensure("a", ln)
    blocks = len(pool.table("a"))
    pages, res = pool.swap_out("a")
    assert (pages, res) == jpool.swap_out("a")
    assert host.acquire("a", blocks, res) is not None
    for t in targets:
        assert pool.resize(t) == jpool.resize(t)
    new = pool.swap_in("a", blocks, res)
    assert new == jpool.swap_in("a", blocks, res)
    if new is None:                      # the pool shrank below it
        assert blocks + res > pool.available_pages
        return
    host.release("a")
    assert len(new) == blocks
    assert all(1 <= p <= pool.capacity for p in new)
    assert len(set(new)) == blocks
    assert pool.reservation("a") == res


# ----------------------------------------------------- device bytes back
@pytest.mark.parametrize("fmt", ["fp32", "int8"])
def test_resize_pages_reallocates_and_keeps_live_pages(fmt):
    """A shrink cuts every pool leaf (scales too) into a fresh tensor of
    the new page count, so no view keeps the old storage; the pages kept
    read as before, and growth zero-pads."""
    cfg = get_config("llama3-8b").reduced(num_layers=1)
    kv = PagedKVCache(cfg, num_slots=2, total_len=16, page_size=4,
                      kv_format=fmt, device="cpu")
    pools = kv.init_stacked()
    for layer in pools["blocks"]:
        for name, leaf in layer.items():
            leaf.copy_(torch.arange(leaf.numel()).reshape(leaf.shape)
                       .to(leaf.dtype))
    assert kv.admit(0, 8)
    kv.ensure(0, 8)
    live = kv.pool.table(0)
    before = [layer[n][live].clone() for layer in pools["blocks"]
              for n in layer]
    old_bytes = kv.pool_nbytes(pools)
    assert kv.resize_pages(pools, 3) == 3
    assert kv.pool_nbytes(pools) == kv.page_nbytes(pools) * 4 < old_bytes
    for layer in pools["blocks"]:
        for leaf in layer.values():
            assert leaf.shape[0] == 4
            assert (leaf.untyped_storage().nbytes()
                    == leaf.numel() * leaf.element_size())
    after = [layer[n][live] for layer in pools["blocks"] for n in layer]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert kv.resize_pages(pools, 6) == 6
    for layer in pools["blocks"]:
        for leaf in layer.values():
            assert leaf.shape[0] == 7 and not leaf[4:].any()


def test_resize_pages_waits_for_queued_swap_copies():
    """The pool tensors are replaced in place, so a resize under queued
    (overlapped) swap copies raises until they are fenced."""
    cfg = get_config("llama3-8b").reduced(num_layers=1)
    kv = PagedKVCache(cfg, num_slots=2, total_len=16, page_size=4,
                      overlap=True, device="cpu")
    pools = kv.init_stacked()
    assert kv.admit(0, 8)
    kv.ensure(0, 8)
    assert kv.swap_out(pools, 0, "h0")
    assert kv.outstanding == 1
    with pytest.raises(RuntimeError):
        kv.resize_pages(pools, 4)
    kv.fence()
    assert kv.resize_pages(pools, 4) == 4
    assert kv.swap_in(pools, 0, "h0")
    kv.fence()
    assert len(kv.pool.table(0)) == 2


def test_set_page_budget_demotes_cached_pages_first(tiny_model):
    """A shrink below the pages the prefix cache holds demotes its LRU
    pages to the host tier first, then cuts the pool, as the JAX
    generator does; a later hit revives them with the same tokens."""
    prompts = ["alpha beta gamma one", "omega psi chi two"]
    jgen, gen = _pair(tiny_model, num_slots=2, paged=True, page_size=4,
                      prefix_cache=True)
    seen = {}
    for cont in (jgen, gen):
        out = {}
        for key, prompt in enumerate(prompts):
            cont.join(key, prompt)
        while cont.active_slots:
            cont.step()
        for key, text, _ in cont.harvest():
            out[key] = text
        cached = cont.prefix.device_pages
        got = cont.set_page_budget(cont.kv.nmax)
        demoted = cont.prefix.stats.demoted_pages
        cont.join(2, prompts[0])
        while cont.active_slots:
            cont.step()
        for key, text, _ in cont.harvest():
            out[key] = text
        seen[cont is gen] = (out, cached, got, demoted,
                             vars(cont.prefix.stats).copy())
    assert seen[True] == seen[False]
    out, cached, got, demoted, stats = seen[True]
    assert demoted > 0 and stats["revived_pages"] > 0
    assert out[2] == out[0] == _dense(tiny_model, prompts[:1])[0]
    assert gen.cache["blocks"][0]["k"].shape[0] == got + 1


def test_retarget_applies_every_budget(tiny_model):
    """``retarget`` clamps and applies slots, device pages, host pages
    and the prefix budget in the reference's order, and serving goes on
    with the reference's tokens."""
    prompts = _prompts(4)
    jgen, gen = _pair(tiny_model, num_slots=3, paged=True, page_size=4,
                      prefix_cache=True)
    seen = {}
    for cont in (jgen, gen):
        first = cont.run(prompts)
        applied = cont.retarget(num_slots=2, page_budget=10 ** 6,
                                host_page_budget=3, prefix_page_budget=0)
        state = (cont.prefix.device_pages, cont.prefix.host_pages,
                 cont.kv.host.capacity, cont.kv.pool.capacity)
        second = cont.run(prompts)
        seen[cont is gen] = (first, applied, state, second,
                             vars(cont.prefix.stats).copy())
    assert seen[True] == seen[False]
    first, applied, state, second, _ = seen[True]
    assert first == second == _dense(tiny_model, prompts)
    assert applied["slots"] == 2
    # asked for 2 * nmax (the tables' reach); the cache's pages, demoted
    # only after the pool resize, keep it from shrinking all the way
    assert 2 * gen.kv.nmax <= applied["pages"] < 3 * gen.kv.nmax
    assert applied["prefix_pages"] == 0 and state[0] == 0
