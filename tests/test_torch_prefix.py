"""Port prefix sharing (radix cache, copy-on-write pages) vs the JAX
package, on the CPU.

Counterparts of ``tests/test_prefix.py`` (all but the streamed case,
in ``tests/test_torch_streamed.py``): the same prompts go
through the JAX ``ContinuousGenerator`` and the port's, both with
``prefix_cache=True``, and give the same tokens, the same
``PrefixCacheStats`` and the same prefill, hit and copy-on-write counts;
the port's tokens also equal its uncached whole-batch ``Generator``'s.
Every greedy choice of the JAX run is checked for a top-2 gap above 1e-3
first (weights ``PRNGKey(1)``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models.model import Model as JaxModel
from repro.serving.generator import ContinuousGenerator as JaxGenerator
from repro.serving.generator import GeneratorConfig as JaxGeneratorConfig

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.serving import (ContinuousGenerator, Generator,
                                 GeneratorConfig, PrefixCacheStats)

CTX, MAX_NEW = 16, 5
MARGIN = 1e-3


@pytest.fixture(scope="module")
def tiny_model():
    jcfg = jax_get_config("llama3-8b").reduced(num_layers=2)
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(1),
                                               jnp.float32)
    cfg = get_config("llama3-8b").reduced(num_layers=2)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu", dtype=torch.float32)
    return cfg, params, jcfg, jparams


def _pair(tiny_model, ctx=CTX, max_new=MAX_NEW, **kw):
    """The JAX generator (its greedy margins recorded) and the port's,
    built with the same knobs."""
    cfg, params, jcfg, jparams = tiny_model
    jgen = JaxGenerator(jcfg, jparams, JaxGeneratorConfig(
        ctx_len=ctx, max_new_tokens=max_new), paged=True, **kw)
    margins = []
    _record_margins(jgen, margins)
    gen = ContinuousGenerator(cfg, params, GeneratorConfig(
        ctx_len=ctx, max_new_tokens=max_new), paged=True, device="cpu", **kw)
    return jgen, gen, margins


def _record_margins(gen, margins):
    """Top-2 gaps of every logit row the JAX generator emits a token
    from: one-shot prefill, the last chunk of a prompt, live decode rows."""
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
        if int(off[0]) + x.shape[1] >= ctx:
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


def _counts(gen):
    return dict(joins=gen.joins, prefill_tokens=gen.prefill_tokens,
                hit_tokens=gen.prefix_hit_tokens, cow=gen.cow_copies,
                steps=gen.steps, stats=vars(gen.prefix.stats).copy())


def _shared_prompts(n=6):
    """Three prefix groups: identical pairs plus divergent tails."""
    base = ["alpha beta gamma", "alpha beta delta", "omega psi chi"]
    return [f"{base[i % 3]} item{i // 3}" for i in range(n)]


def _run_serial(cont, prompts):
    """Join/step/harvest driver; joins as capacity allows (FIFO)."""
    pending = list(enumerate(prompts))[::-1]
    results = [None] * len(prompts)
    tick = 0
    while pending or cont.active_slots:
        while pending and cont.admit_capacity > 0:
            key, prompt = pending.pop()
            if cont.join(key, prompt) is None:
                pending.append((key, prompt))
                break
        cont.step()
        for key, text, _ in cont.harvest():
            results[key] = text
        tick += 1
        assert tick < 500, "prefix driver stalled"
    assert all(r is not None for r in results)
    return results


def _drained(cont):
    """All leases and tables returned; only the cache still holds pages."""
    pool = cont.kv.pool
    assert cont.free_slots == cont.num_slots
    assert pool.used_pages == 0 and pool.reserved_pages == 0
    assert pool.free_pages + pool.referenced_pages == pool.capacity
    assert pool.referenced_pages == cont.prefix.device_pages
    assert cont.kv.host.used_pages == cont.prefix.host_pages
    cont.prefix.clear(cont.kv, cont.cache)
    assert pool.free_pages == pool.capacity
    assert cont.kv.host.used_pages == 0


def _dense(tiny_model, prompts, ctx=CTX, max_new=MAX_NEW):
    cfg, params, _, _ = tiny_model
    return Generator(cfg, params, GeneratorConfig(
        ctx_len=ctx, max_new_tokens=max_new), device="cpu").generate(prompts)


def _same(jgen, gen, jout, out, margins):
    assert min(margins) > MARGIN, "the JAX run lacks a greedy margin"
    assert out == jout
    assert _counts(gen) == _counts(jgen)


# ---------------------------------------------------------------- equivalence
@pytest.mark.parametrize("chunk", [None, 7])
def test_shared_prefix_token_identical(tiny_model, chunk):
    """Cache-hit joins (full-page shares, partial boundary copies and
    divergent tails), one-shot and chunked: the JAX generator's tokens and
    stats, and the uncached whole-batch tokens."""
    prompts = _shared_prompts()
    jgen, gen, margins = _pair(tiny_model, num_slots=3, page_size=4,
                               prefix_cache=True, prefill_chunk=chunk)
    jout, out = _run_serial(jgen, prompts), _run_serial(gen, prompts)
    _same(jgen, gen, jout, out, margins)
    assert out == _dense(tiny_model, prompts)
    assert isinstance(gen.prefix.stats, PrefixCacheStats)
    assert gen.prefix.stats.hits > 0 and gen.prefix_hit_tokens > 0
    _drained(gen)


def test_cow_divergence_on_ragged_context(tiny_model):
    """ctx % page_size != 0: the donor's cached tail page is shared with
    the cache, so its first decode past the boundary detaches it by CoW,
    and the follower hitting the same prefix reads the cached page as
    it was."""
    prompts = ["recurring shared question"] * 4
    jgen, gen, margins = _pair(tiny_model, ctx=18, num_slots=2, page_size=4,
                               prefix_cache=True)
    jout, out = _run_serial(jgen, prompts), _run_serial(gen, prompts)
    _same(jgen, gen, jout, out, margins)
    assert out == _dense(tiny_model, prompts, ctx=18)
    assert gen.cow_copies >= 1, "donor tail never detached"
    assert gen.prefix.stats.hits >= 1
    _drained(gen)


def _run_with_preemption(cont, prompts, pages=None):
    pending = list(enumerate(prompts))[::-1]
    results = [None] * len(prompts)
    parked = []
    tick = cycles = 0
    while pending or cont.active_slots or cont.parked_slots:
        for due, handle in list(parked):
            if tick >= due and cont.resume(handle) is not None:
                parked.remove((due, handle))
                cycles += 1
        while pending and cont.admit_capacity > 0:
            key, prompt = pending.pop()
            if cont.join(key, prompt) is None:
                pending.append((key, prompt))
                break
        if tick % 3 == 2:
            victim = cont.swap_victim()
            if victim is not None:
                held = len(cont.kv.pool.table(victim.index))
                handle = cont.preempt(victim, pages=None if pages is None
                                      else min(pages, held))
                if handle is not None:
                    parked.append((tick + 2, handle))
        cont.step()
        for key, text, _ in cont.harvest():
            results[key] = text
        tick += 1
        assert tick < 500, "preempt driver stalled"
    return results, cycles


@pytest.mark.parametrize("pages", [None, 2])
def test_preempt_resume_of_shared_slots(tiny_model, pages):
    """Preempting a slot whose table maps cache-shared pages (all of them,
    or its 2 coldest: a partial park, whose shed pages may be shared
    while its tail stays), then resuming it onto fresh private pages: the
    same tokens, and the cache's references survive."""
    prompts = _shared_prompts()
    jgen, gen, margins = _pair(tiny_model, num_slots=3, page_size=4,
                               prefix_cache=True)
    (jout, jcycles), (out, cycles) = (
        _run_with_preemption(jgen, prompts, pages),
        _run_with_preemption(gen, prompts, pages))
    _same(jgen, gen, jout, out, margins)
    assert out == _dense(tiny_model, prompts)
    assert cycles == jcycles and cycles > 0
    assert gen.swap_outs == jgen.swap_outs
    assert gen.prefix.stats.hits > 0
    _drained(gen)


# --------------------------------------------------------- cache mechanics
def test_partial_page_boundary_copy(tiny_model):
    """A hit ending mid-page copies the boundary page into a private page
    at join: the cached page is never written by the joiner's suffix."""
    jgen, gen, _ = _pair(tiny_model, max_new=2, num_slots=2, page_size=8,
                         prefix_cache=True)
    seen = {}
    for cont in (jgen, gen):
        cont.join("a", "alpha beta gamma")
        while cont.active_slots:
            cont.step()
        cont.harvest()
        toks = cont.tok.encode("alpha beta DIVERGENT", CTX)
        if cont is gen:
            nodes, m = cont.prefix.match(toks, cont.kv, cont.cache)
        else:
            nodes, m, cont.cache = cont.prefix.match(toks, cont.kv,
                                                     cont.cache)
        cached = [n.page for n in nodes]
        cont.prefix.unpin(nodes, cont.kv)
        page = cached[m // cont.page_size]
        if cont is gen:
            before = [leaf[page].clone() for layer in gen.cache["blocks"]
                      for leaf in layer.values()]
        ref = cont.join("b", "alpha beta DIVERGENT")
        assert ref is not None
        seen[cont is gen] = (m, cont.kv.pool.table(ref.index), cached)
        while cont.active_slots:
            cont.step()
        cont.harvest()
    assert seen[False] == seen[True]
    m, tab, cached = seen[True]
    assert 0 < m < CTX and m % gen.page_size != 0   # ends inside a page
    # the boundary block is a private copy, not the cached page itself,
    # and the cached page reads as it did before the joiner's prefill
    assert tab[m // gen.page_size] not in cached
    after = [leaf[page] for layer in gen.cache["blocks"]
             for leaf in layer.values()]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    _drained(gen)


def test_eviction_never_races_a_matched_join(tiny_model):
    """The match-to-admit window: a reclaim pass between ``match`` and the
    join that maps the nodes must not free the pinned pages (refcount 2:
    cache + pin); after ``unpin`` they are evictable again."""
    cfg, params, _, _ = tiny_model
    cont = ContinuousGenerator(cfg, params, GeneratorConfig(
        ctx_len=CTX, max_new_tokens=1), num_slots=2, paged=True,
        page_size=4, prefix_cache=True, host_page_budget=0, device="cpu")
    cont.join("a", "alpha beta gamma")
    while cont.active_slots:
        cont.step()
    cont.harvest()
    toks = cont.tok.encode("alpha beta gamma", CTX)
    nodes, m = cont.prefix.match(toks, cont.kv, cont.cache)
    assert nodes and m > 0
    for n in nodes:
        assert cont.kv.pool.refcount(n.page) == 2    # cache + pin
    assert cont.prefix.reclaim(10 ** 6, cont.kv, cont.cache) == 0
    for n in nodes:
        assert n.page is not None and not n.on_host
        assert cont.kv.pool.refcount(n.page) == 2
    cont.prefix.unpin(nodes, cont.kv)
    freed = cont.prefix.reclaim(10 ** 6, cont.kv, cont.cache)
    assert freed == len(nodes)                       # now fully evictable
    assert cont.kv.pool.free_pages == cont.kv.pool.capacity
    assert cont.prefix.stats.dropped_pages == len(nodes)


def test_demote_and_revive_through_host_tier(tiny_model):
    """Cold cached prefixes demote to the host pool and revive on the next
    hit, the data copied both ways: tokens and stats as the JAX run's."""
    prompts = ["alpha beta gamma one"] * 2
    jgen, gen, margins = _pair(tiny_model, num_slots=2, page_size=4,
                               prefix_cache=True)
    outs = {}
    for cont in (jgen, gen):
        out = [None, None]
        cont.join(0, prompts[0])
        while cont.active_slots:
            cont.step()
        for key, text, _ in cont.harvest():
            out[key] = text
        if cont is gen:
            freed = cont.prefix.reclaim(10 ** 6, cont.kv, cont.cache)
        else:
            freed, cont.cache = cont.prefix.reclaim(10 ** 6, cont.kv,
                                                    cont.cache)
        assert freed > 0
        assert cont.prefix.device_pages == 0 and cont.prefix.host_pages > 0
        assert cont.join(1, prompts[1]) is not None
        assert cont.prefix.stats.revived_pages > 0
        while cont.active_slots:
            cont.step()
        for key, text, _ in cont.harvest():
            out[key] = text
        outs[cont is gen] = out
    _same(jgen, gen, outs[False], outs[True], margins)
    assert outs[True] == _dense(tiny_model, prompts)
    _drained(gen)
    assert gen.kv.host.used_pages == 0


def test_prefix_cache_knobs_are_checked():
    """The reference's refusals: a prefix cache needs the paged pool, and
    overlapped swaps do not mix with it."""
    cfg = get_config("llama3-8b").reduced(num_layers=1)
    g = GeneratorConfig(ctx_len=8, max_new_tokens=2)
    with pytest.raises(ValueError):
        ContinuousGenerator(cfg, None, g, prefix_cache=True, device="cpu")
    with pytest.raises(ValueError):
        ContinuousGenerator(cfg, None, g, paged=True, prefix_cache=True,
                            overlap_swap=True, device="cpu")
