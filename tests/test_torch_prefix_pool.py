"""Port page pool and slot table laws, run side by side with the JAX ones.

Counterparts of ``tests/test_prefix_pool.py`` (refcount conservation
under sharing), ``tests/test_paged_pool.py`` (no leak, no double lease,
the trash page never issued, the table-length law, reservations backed,
``resize`` never dropping a page in use) and ``tests/test_slots.py``
(slots partitioned, positions monotone, stale leases refused, ``mask``),
as hypothesis properties: the port's ``PagePool`` and ``SlotTable`` go
through the same random interleavings as the reference's and must agree
with them after every operation.  Copy-on-write detaches (``PagePool.cow``)
join the sharing interleavings, since they change the refcounts the laws
guard.
"""
import numpy as np
import pytest

from hypothesis import given, settings, strategies as st

from repro.serving.generator import SlotTable as JaxSlotTable
from repro.serving.kvpool import PageExhausted as JaxPageExhausted
from repro.serving.kvpool import PagePool as JaxPagePool

from repro_torch.serving.generator import SlotRef, SlotTable, StaleSlotError
from repro_torch.serving.kvpool import TRASH_PAGE, PageExhausted, PagePool


def _same_pool(pool, jpool):
    assert sorted(map(str, pool.holders())) == sorted(
        map(str, jpool.holders()))
    for k in pool.holders():
        assert pool.table(k) == jpool.table(k)
        assert pool.reservation(k) == jpool.reservation(k)
    assert pool.capacity == jpool.capacity
    assert pool._free == jpool._free
    assert pool._refs == jpool._refs


# ------------------------------------------------ sharing (test_prefix_pool)
SHARE_OPS = st.lists(
    st.tuples(st.sampled_from(["admit", "share", "ensure", "release",
                               "pin", "unpin", "cow"]),
              st.integers(min_value=0, max_value=9),
              st.integers(min_value=0, max_value=24)),
    max_size=60)


def _share_invariants(pool, tables, holds):
    """refcount == table occurrences + standalone holds, exactly."""
    want = {}
    for tab in tables.values():
        for p in tab:
            want[p] = want.get(p, 0) + 1
    for p, n in holds.items():
        if n:
            want[p] = want.get(p, 0) + n
    assert {p: pool.refcount(p) for p in want} == want
    assert pool.referenced_pages == len(want)
    free = set(range(1, pool.capacity + 1)) - set(want)
    assert pool.free_pages == len(free)               # free ∩ referenced = ∅
    assert TRASH_PAGE not in want
    assert pool.reserved_pages <= pool.free_pages


@given(cap=st.integers(min_value=2, max_value=12),
       page=st.integers(min_value=1, max_value=4), ops=SHARE_OPS)
@settings(max_examples=80, deadline=None)
def test_refcount_conservation_under_sharing(cap, page, ops):
    """Shared admission, standalone holds (cache references, match pins),
    growth, copy-on-write detaches and release keep the refcount ledger
    equal to live table references plus holds, and the JAX pool's."""
    pool, jpool = PagePool(cap, page), JaxPagePool(cap, page)
    tables, lengths, holds = {}, {}, {}
    nxt = 0
    for op, pick, amount in ops:
        if op == "admit":
            ln = max(amount, 1)
            ok = pool.admit(nxt, ln)
            assert ok == jpool.admit(nxt, ln)
            if ok:
                pool.ensure(nxt, min(ln, page))
                jpool.ensure(nxt, min(ln, page))
                tables[nxt] = list(pool.table(nxt))
                lengths[nxt] = ln
            nxt += 1
        elif op == "share" and tables:
            # a prefix of an existing table into a new key; the pins the
            # caller holds transfer to the new table
            donor = sorted(tables)[pick % len(tables)]
            shared = tables[donor][:1 + amount % max(len(tables[donor]), 1)]
            for p in shared:
                pool.incref(p)
                jpool.incref(p)
            ln = max(lengths[donor], len(shared) * page)
            ok = pool.admit(nxt, ln, shared=shared)
            assert ok == jpool.admit(nxt, ln, shared=shared)
            if ok:
                tables[nxt] = list(shared)
                lengths[nxt] = ln
            else:
                for p in shared:                       # nothing retained
                    pool.decref(p)
                    jpool.decref(p)
            nxt += 1
        elif op == "ensure" and tables:
            k = sorted(tables)[pick % len(tables)]
            want = min(lengths[k], len(tables[k]) * page + amount)
            try:
                pool.ensure(k, want)
            except PageExhausted:
                with pytest.raises(JaxPageExhausted):
                    jpool.ensure(k, want)
            else:
                jpool.ensure(k, want)
                tables[k] = list(pool.table(k))
        elif op == "release" and tables:
            k = sorted(tables)[pick % len(tables)]
            pool.release(k)
            jpool.release(k)
            del tables[k], lengths[k]
        elif op == "pin":
            got = pool.grab(1)
            assert got == jpool.grab(1)
            if got is not None:
                holds[got[0]] = holds.get(got[0], 0) + 1
        elif op == "unpin" and any(holds.values()):
            held = sorted(p for p, n in holds.items() if n)
            p = held[pick % len(held)]
            pool.decref(p)
            jpool.decref(p)
            holds[p] -= 1
            if not holds[p]:
                del holds[p]
        elif op == "cow" and tables:
            k = sorted(tables)[pick % len(tables)]
            if not tables[k]:
                continue
            block = amount % len(tables[k])
            src = tables[k][block]
            shared = pool.refcount(src) > 1
            try:
                got = pool.cow(k, block)
            except PageExhausted:
                assert shared and pool.available_pages < 1
                with pytest.raises(JaxPageExhausted):
                    jpool.cow(k, block)
            else:
                assert got == jpool.cow(k, block)
                if got is None:
                    assert not shared
                else:
                    assert got[0] == src and pool.refcount(got[1]) == 1
                    assert pool.refcount(src) >= 1    # others still hold it
                tables[k] = list(pool.table(k))
        _share_invariants(pool, tables, holds)
        _same_pool(pool, jpool)
    for k in list(tables):
        pool.release(k)
        jpool.release(k)
        del tables[k]
        _share_invariants(pool, tables, holds)
    for p in list(holds):
        for _ in range(holds.pop(p)):
            pool.decref(p)
    assert pool.free_pages == pool.capacity            # no leaks


@given(cap=st.integers(min_value=4, max_value=12),
       page=st.integers(min_value=1, max_value=4),
       n_shared=st.integers(min_value=1, max_value=3))
@settings(max_examples=60, deadline=None)
def test_no_page_freed_while_shared(cap, page, n_shared):
    """Releasing one holder of a shared page never frees it while another
    table (or a standalone hold) still references it."""
    pool = PagePool(cap, page)
    assert pool.admit("donor", n_shared * page)
    pool.ensure("donor", n_shared * page)
    shared = list(pool.table("donor"))
    for p in shared:
        pool.incref(p)
    assert pool.admit("joiner", n_shared * page, shared=shared)
    pool.release("donor")
    for p in shared:                    # the joiner's references keep them
        assert pool.refcount(p) == 1
        assert p in pool.table("joiner")
    pool.release("joiner")
    assert pool.free_pages == pool.capacity


def test_admit_shared_checks_and_cow_of_a_private_page():
    pool = PagePool(4, 2)
    with pytest.raises(ValueError):
        pool.admit("a", 4, shared=[1])        # page 1 is not referenced
    assert pool.admit("a", 4)
    pool.ensure("a", 4)
    assert pool.cow("a", 0) is None           # private: nothing to copy
    p = pool.table("a")[0]
    pool.incref(p)                            # a cache's hold
    assert pool.admit("b", 4, shared=[p])     # only 1 block reserved
    assert pool.reservation("b") == 1
    src, dst = pool.cow("b", 0)
    assert src == p and pool.table("b")[0] == dst
    assert pool.refcount(p) == 1 and pool.refcount(dst) == 1


# --------------------------------------------- the pool (test_paged_pool)
POOL_OPS = st.lists(
    st.tuples(st.sampled_from(["admit", "ensure", "grow", "release",
                               "resize"]),
              st.integers(min_value=0, max_value=9),
              st.integers(min_value=0, max_value=40)),
    max_size=60)


def _pool_invariants(pool, lengths):
    leased = [p for k in pool.holders() for p in pool.table(k)]
    assert len(leased) == len(set(leased))            # no double lease
    assert TRASH_PAGE not in leased                   # trash never issued
    assert all(1 <= p <= pool.capacity for p in leased)
    assert pool.free_pages + pool.used_pages == pool.capacity  # no leaks
    assert pool.reserved_pages <= pool.free_pages     # reservations backed
    for k in pool.holders():                          # table/length law
        assert len(pool.table(k)) == pool.blocks_for(lengths[k])


@given(cap=st.integers(min_value=1, max_value=12),
       page=st.integers(min_value=1, max_value=8), ops=POOL_OPS)
@settings(max_examples=120, deadline=None)
def test_pool_interleavings_never_leak_or_double_lease(cap, page, ops):
    """Admit, ensure, release and resize in any order, against the JAX
    pool after every step."""
    pool, jpool = PagePool(cap, page), JaxPagePool(cap, page)
    lengths = {}
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
            except PageExhausted:
                with pytest.raises(JaxPageExhausted):
                    jpool.ensure(k, want)
            else:
                jpool.ensure(k, want)
                lengths[k] = max(lengths[k], want)
        elif op == "release" and lengths:
            k = sorted(lengths)[pick % len(lengths)]
            pool.release(k)
            jpool.release(k)
            del lengths[k]
            with pytest.raises(KeyError):             # no double free
                pool.release(k)
        elif op == "resize":
            assert pool.resize(max(amount, 1)) == jpool.resize(max(amount, 1))
        _pool_invariants(pool, lengths)
        _same_pool(pool, jpool)


@given(cap=st.integers(min_value=2, max_value=16),
       page=st.integers(min_value=1, max_value=4),
       lens=st.lists(st.integers(min_value=1, max_value=30), min_size=1,
                     max_size=6))
@settings(max_examples=80, deadline=None)
def test_pool_admit_reserves_worst_case(cap, page, lens):
    """An admitted request can always ensure up to its admitted length,
    whatever the other admitted requests do."""
    pool = PagePool(cap, page)
    admitted = []
    for i, ln in enumerate(lens):
        if pool.admit(i, ln):
            admitted.append((i, ln))
    for i, ln in admitted:                 # the reservation in full
        pool.ensure(i, ln)
        assert len(pool.table(i)) == pool.blocks_for(ln)
    for i, _ in admitted:
        pool.release(i)
    assert pool.free_pages == pool.capacity


@given(cap=st.integers(min_value=2, max_value=10),
       page=st.integers(min_value=1, max_value=4),
       targets=st.lists(st.integers(min_value=1, max_value=20), min_size=1,
                        max_size=8))
@settings(max_examples=80, deadline=None)
def test_pool_resize_never_drops_leased_or_reserved_pages(cap, page,
                                                          targets):
    pool, jpool = PagePool(cap, page), JaxPagePool(cap, page)
    for p in (pool, jpool):
        assert p.admit("a", 2 * page)      # 2 pages reserved
        p.ensure("a", page)                # 1 allocated
    held = set(pool.table("a"))
    for t in targets:
        actual = pool.resize(t)
        assert actual == jpool.resize(t)
        assert actual >= len(held)
        assert set(pool.table("a")) == held          # lease untouched
        assert pool.reserved_pages <= pool.free_pages
        _pool_invariants(pool, {"a": page})
        _same_pool(pool, jpool)
    pool.ensure("a", 2 * page)             # the reservation survives
    assert len(pool.table("a")) == 2


@given(cap=st.integers(min_value=2, max_value=12),
       page=st.integers(min_value=1, max_value=4),
       ops=st.lists(st.tuples(st.sampled_from(["hold", "drop", "park",
                                               "land", "resize"]),
                              st.integers(min_value=0, max_value=30)),
                    max_size=40))
@settings(max_examples=80, deadline=None)
def test_pool_resize_spares_holds_and_inflight_pages(cap, page, ops):
    """A shrink never drops a page the prefix cache holds or one still
    in flight under a swap copy; the JAX pool agrees."""
    pool, jpool = PagePool(cap, page), JaxPagePool(cap, page)
    holds, flight, nxt = [], [], 0
    for op, amount in ops:
        if op == "hold":
            got = pool.grab(1)
            assert got == jpool.grab(1)
            holds += got or []
        elif op == "drop" and holds:
            p = holds.pop(amount % len(holds))
            pool.decref(p)
            jpool.decref(p)
        elif op == "park":
            if pool.admit(nxt, page) and jpool.admit(nxt, page):
                pool.ensure(nxt, page)
                jpool.ensure(nxt, page)
                cold, _ = pool.park(nxt, ("t", nxt), inflight=True)
                assert (cold, 0) == jpool.park(nxt, ("t", nxt),
                                               inflight=True)
                flight += cold
            nxt += 1
        elif op == "land" and flight:
            pool.complete_inflight(flight)
            jpool.complete_inflight(flight)
            flight = []
        elif op == "resize":
            got = pool.resize(max(amount, 1))
            assert got == jpool.resize(max(amount, 1))
            assert got >= max(holds + flight, default=0)
        assert all(pool.refcount(p) >= 1 for p in holds)
        assert all(pool.is_inflight(p) for p in flight)
        assert (pool.free_pages + pool.referenced_pages
                + pool.inflight_pages == pool.capacity)
        _same_pool(pool, jpool)


def test_page_pool_resize_shrink_respects_in_use():
    pool = PagePool(8, page_size=4)
    pool.admit("a", 16)                           # reserve 4
    pool.ensure("a", 16)
    assert pool.resize(2) >= 4                    # in-use pages kept
    assert pool.used_pages == 4
    pool.release("a")
    assert pool.resize(2) == 2
    assert pool.free_pages == 2
    assert pool.resize(5) == 5 and pool.free_pages == 5


# ---------------------------------------------------- slots (test_slots)
CAPS = st.integers(min_value=1, max_value=5)
SLOT_OPS = st.lists(st.tuples(st.sampled_from(["join", "step", "leave",
                                               "resize"]),
                              st.integers(min_value=0, max_value=9)),
                    max_size=80)


def _slot_invariants(table):
    assert table.free_slots + table.active_slots == table.capacity
    live = table.active_refs()
    assert len({r.index for r in live}) == len(live)   # one lease a slot
    mask = table.mask()
    assert mask.shape == (table.capacity,) and mask.dtype == bool
    assert sorted(np.flatnonzero(mask).tolist()) == [r.index for r in live]


@given(cap=CAPS, ops=SLOT_OPS)
@settings(max_examples=120, deadline=None)
def test_slot_interleavings_never_leak_or_double_lease(cap, ops):
    """Join, step, leave and resize: free + active == capacity, one lease
    a slot, ``mask`` marks exactly the leased slots, and the JAX table
    makes the same choices."""
    table, jtable = SlotTable(cap), JaxSlotTable(cap)
    nxt = 0
    for op, pick in ops:
        live = table.active_refs()
        if op == "join":
            ref = table.acquire(f"r{nxt}", pos=8, remaining=4)
            jref = jtable.acquire(f"r{nxt}", pos=8, remaining=4)
            assert (ref is None) == (jref is None)
            if ref is None:
                assert len(live) == table.capacity
            else:
                assert (ref.index, ref.epoch) == (jref.index, jref.epoch)
            nxt += 1
        elif op == "step" and live:
            ref = live[pick % len(live)]
            table.advance(ref, token=pick)
            jtable.advance(jtable.active_refs()[pick % len(live)], pick)
        elif op == "leave" and live:
            table.release(live[pick % len(live)])
            jtable.release(jtable.active_refs()[pick % len(live)])
        elif op == "resize":
            assert table.resize(pick) == jtable.resize(pick)
        _slot_invariants(table)
        assert table.capacity == jtable.capacity
        assert (table.mask() == jtable.mask()).all()
        assert ([(r.index, r.epoch) for r in table.active_refs()]
                == [(r.index, r.epoch) for r in jtable.active_refs()])


@given(cap=CAPS, ops=SLOT_OPS)
@settings(max_examples=120, deadline=None)
def test_positions_strictly_monotone_per_request(cap, ops):
    table = SlotTable(cap)
    nxt = 0
    seen = {}                             # key -> last observed pos
    for op, pick in ops:
        live = table.active_refs()
        if op == "join":
            if table.acquire(f"r{nxt}", pos=8, remaining=100) is not None:
                seen[f"r{nxt}"] = 8
            nxt += 1
        elif op == "step" and live:
            stt = table.advance(live[pick % len(live)], token=pick)
            assert stt.pos == seen[stt.key] + 1   # strictly +1 a step
            seen[stt.key] = stt.pos
        elif op == "leave" and live:
            table.release(live[pick % len(live)])
        elif op == "resize":
            table.resize(pick)
        _slot_invariants(table)


@given(cap=CAPS, ops=SLOT_OPS)
@settings(max_examples=120, deadline=None)
def test_stale_leases_never_touch_recycled_slots(cap, ops):
    """A ref kept past its release raises instead of serving a stale row,
    even after the slot is leased again, across resizes too."""
    table = SlotTable(cap)
    stale = []
    nxt = 0
    for op, pick in ops:
        live = table.active_refs()
        if op == "join":
            table.acquire(f"r{nxt}", pos=0, remaining=9)
            nxt += 1
        elif op == "step" and live:
            table.advance(live[pick % len(live)], token=pick)
        elif op == "leave" and live:
            ref = live[pick % len(live)]
            table.release(ref)
            stale.append(ref)
        elif op == "resize":
            table.resize(pick)
        for ref in stale:
            with pytest.raises(StaleSlotError):
                table.advance(ref, token=0)
            with pytest.raises(StaleSlotError):
                table.release(ref)
            with pytest.raises(StaleSlotError):
                table.state(ref)
        _slot_invariants(table)


def test_released_slot_is_immediately_reusable():
    table = SlotTable(1)
    a = table.acquire("a", pos=0, remaining=2)
    assert a is not None and table.acquire("b", 0, 2) is None
    table.release(a)
    b = table.acquire("b", pos=0, remaining=2)
    assert b is not None and b.index == a.index and b.epoch == a.epoch + 1


def test_forged_epoch_rejected():
    table = SlotTable(2)
    a = table.acquire("a", pos=0, remaining=2)
    with pytest.raises(StaleSlotError):
        table.advance(SlotRef(a.index, a.epoch + 1), token=0)


def test_capacity_validation():
    with pytest.raises(ValueError):
        SlotTable(0)
    assert SlotTable(3).mask().tolist() == [False] * 3
