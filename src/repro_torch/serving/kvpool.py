"""Paged KV cache: a block-table page pool and its host swap tier.

Ported from ``repro.serving.kvpool``:

``PagePool``
    Pure host-side bookkeeping: a free-list of fixed-size KV *pages*,
    per-slot *block tables* and per-page refcounts.  Page id 0 is the
    reserved **trash page**, never allocated: freed and parked slots'
    tables point at it, so a dead slot's decode writes can never land in
    a page re-issued to another slot.  ``admit`` books a request's
    worst-case page count up front; ``ensure`` draws pages lazily.
    ``park``/``unpark`` end and restore a slot's device residency for a
    (possibly partial) swap; pages freed under an outstanding copy stay
    *in flight*, unallocatable, until ``complete_inflight``.

    Pages carry **refcounts** so one physical page can back the same
    logical prefix in many block tables (``serving/prefixcache.py``):
    ``admit(..., shared=pages)`` maps an already-referenced prefix into a
    joining slot's table, ``incref``/``decref`` adjust standalone holds
    (the radix cache's reference, a match-time pin), and a page returns
    to the free list only when its count hits zero.  Shared pages are
    read-only: a holder that must write one first detaches it with
    ``cow`` (a fresh page, the table entry repointed, one reference
    dropped on the original; ``PagedKVCache.cow_block`` copies the data).
    ``resize`` retargets the capacity without dropping a page in use.

``HostPagePool``
    The host tier (the ``c_cpu`` share of the paper's KV placement): a
    free-list of host pages and one host tensor holding them, page-major
    (``(capacity, page_nbytes)`` bytes: every pool leaf's row of a page,
    scales included, side by side), pinned when the pool lives on the
    card so that copies to and from it run asynchronously.

``PagedKVCache``
    The device-facing half: per-layer pool tensors
    ``(num_pages + 1, page_size, kv_heads, head_dim)`` (row 0 = trash;
    int8 pools add ``(num_pages + 1, kv_heads)`` fp32 scales), the shared
    ``(num_slots, max_blocks)`` int32 block table and its device mirror,
    and the swap paths: ``swap_out`` copies a slot's pages (or its ``k``
    coldest) to the host tier and frees them, ``swap_in`` copies them
    back onto fresh pages and remaps the block table.  With
    ``overlap=True`` the copies run on a side CUDA stream and complete
    through events that ``poll`` queries (the reference runs a transfer
    thread); on the CPU the same path completes at once.  ``copy_page``
    and ``cow_block`` are the data half of copy-on-write; ``resize_pages``
    and ``resize_slots`` retarget the pool and the table, and a shrink
    reallocates the pool tensors, so the dropped pages' device bytes are
    given back.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.obs.metrics import NULL_REGISTRY
from repro_torch.obs.trace import NULL_TRACER

TRASH_PAGE = 0

# the pool leaves' type of each format ("int8" pools also carry fp32
# per-page-per-head scale leaves; see ``kernels/quant.py``)
KV_FORMAT_DTYPE = {"fp32": torch.float32, "bf16": torch.bfloat16,
                   "int8": torch.int8}

class PageExhausted(RuntimeError):
    """The pool cannot supply the pages a live sequence needs."""


class PagePool:
    """Free-list of fixed-size KV pages with per-slot block tables.

    ``capacity`` counts *usable* pages (ids ``1..capacity``); id 0 is
    the reserved trash page.  ``admit`` books a worst-case reservation,
    ``ensure`` draws pages lazily (first from the slot's reservation,
    then from unreserved spares), ``release`` returns everything.  Every
    page is free, referenced (refcount >= 1) or in flight.
    """

    def __init__(self, capacity: int, page_size: int):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.page_size = page_size
        self._capacity = capacity
        self._free: List[int] = list(range(capacity, 0, -1))  # pop() -> 1
        self._tables: Dict[Any, List[int]] = {}
        self._reserved: Dict[Any, int] = {}
        self._refs: Dict[int, int] = {}      # allocated page -> refcount
        # pages freed under an outstanding device-to-host copy: not
        # allocatable until ``complete_inflight``
        self._inflight: set = set()

    # ------------------------------------------------------------ queries
    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return sum(len(t) for t in self._tables.values())

    @property
    def reserved_pages(self) -> int:
        return sum(self._reserved.values())

    @property
    def available_pages(self) -> int:
        """Free pages not backing any slot's reservation."""
        return self.free_pages - self.reserved_pages

    @property
    def referenced_pages(self) -> int:
        """Distinct pages with refcount >= 1 (free + referenced +
        in flight = capacity)."""
        return len(self._refs)

    @property
    def inflight_pages(self) -> int:
        """Pages pinned by an outstanding swap copy."""
        return len(self._inflight)

    def is_inflight(self, page: int) -> bool:
        return page in self._inflight

    def refcount(self, page: int) -> int:
        """Live references to ``page`` (0 = free / never allocated)."""
        return self._refs.get(page, 0)

    def blocks_for(self, length: int) -> int:
        return -(-max(length, 0) // self.page_size)

    def table(self, key: Any) -> List[int]:
        return list(self._tables[key])

    def reservation(self, key: Any) -> int:
        """Unspent worst-case reservation still booked for ``key``."""
        return self._reserved.get(key, 0)

    def holders(self) -> List[Any]:
        return list(self._tables)

    def can_admit(self, length: int) -> bool:
        return self.blocks_for(length) <= self.available_pages

    def admit_capacity(self, length: int) -> int:
        """How many worst-case-``length`` requests fit right now."""
        need = self.blocks_for(length)
        if need == 0:
            return self._capacity
        return self.available_pages // need

    # ---------------------------------------------------------- lifecycle
    def _lease(self, n: int) -> List[int]:
        new = [self._free.pop() for _ in range(n)]
        for p in new:
            self._refs[p] = 1
        return new

    def admit(self, key: Any, length: int,
              shared: Sequence[int] = ()) -> bool:
        """Reserve ``blocks_for(length)`` pages for a joining request.

        ``shared`` maps an already-referenced page run (a cached prefix)
        into the head of the new block table: the caller holds one
        reference per page (a pin from ``PrefixCache.match``), and that
        reference transfers to the table entry (no incref here; ``release``
        later decrefs it like any other entry).  Only the blocks beyond
        the shared prefix are reserved.
        """
        if key in self._tables:
            raise ValueError(f"slot {key!r} already holds pages")
        for p in shared:
            if self._refs.get(p, 0) < 1:
                raise ValueError(f"shared page {p} is not referenced")
        need = max(0, self.blocks_for(length) - len(shared))
        if need > self.available_pages:
            return False
        self._tables[key] = list(shared)
        self._reserved[key] = need
        return True

    def ensure(self, key: Any, length: int) -> List[int]:
        """Grow ``key``'s block table to cover ``length`` positions.

        Returns the newly allocated page ids (possibly empty).  Draws
        from the slot's reservation first, then from unreserved spares;
        raises :class:`PageExhausted` if the pool cannot cover it.
        """
        tab = self._tables[key]
        need = self.blocks_for(length) - len(tab)
        if need <= 0:
            return []
        res = self._reserved.get(key, 0)
        extra = max(0, need - res)
        if extra > self.available_pages:
            raise PageExhausted(
                f"need {need} pages for slot {key!r}, "
                f"reservation {res} + available {self.available_pages}")
        new = self._lease(need)
        tab.extend(new)
        self._reserved[key] = max(0, res - need)
        return new

    def release(self, key: Any) -> int:
        """End ``key``'s lease: drop one reference per table entry (and
        the unspent reservation); pages whose count reaches zero return
        to the free list."""
        tab = self._tables.pop(key)       # KeyError = double free
        self._reserved.pop(key, None)
        for p in reversed(tab):           # low ids pop first again
            self.decref(p)
        return len(tab)

    def incref(self, page: int) -> None:
        """Add a standalone reference to an allocated page."""
        if page not in self._refs:
            raise ValueError(f"page {page} is not allocated")
        self._refs[page] += 1

    def decref(self, page: int, inflight: bool = False) -> None:
        """Drop one reference; the page frees when the count hits zero.

        With ``inflight=True`` a count-zero page enters the in-flight
        set instead of the free list: it cannot be re-leased until the
        copy reading it completes (:meth:`complete_inflight`).
        """
        rc = self._refs[page] - 1         # KeyError = double free
        if rc <= 0:
            del self._refs[page]
            if inflight:
                self._inflight.add(page)
            else:
                self._free.append(page)
        else:
            self._refs[page] = rc

    def complete_inflight(self, pages: Sequence[int]) -> None:
        """A device-to-host copy landed: its pages return to the free
        list."""
        for p in pages:
            if p not in self._inflight:
                raise ValueError(f"page {p} is not in flight")
            self._inflight.remove(p)
            self._free.append(p)

    def grab(self, n: int = 1) -> Optional[List[int]]:
        """Allocate ``n`` standalone pages (refcount 1, no table) from
        the unreserved spares; ``None`` when the spares cannot cover it.
        Never touches slot reservations."""
        if n < 0:
            raise ValueError("n must be >= 0")
        if n > self.available_pages:
            return None
        return self._lease(n)

    def cow(self, key: Any, block: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write detach of ``key``'s ``block`` before a write.

        A shared page (refcount > 1) is read-only for every holder; the
        writer takes a fresh page in its table and drops its reference on
        the original.  Returns ``(src, dst)`` for the caller's data copy,
        or ``None`` when the page is already private.  Draws from
        unreserved spares only (the slot's reservation covers its private
        blocks, never a detach), so it may raise :class:`PageExhausted`;
        callers then un-cache the page instead
        (``ContinuousGenerator._cow_barrier``).
        """
        tab = self._tables[key]
        src = tab[block]
        if self._refs.get(src, 0) <= 1:
            return None
        if self.available_pages < 1:
            raise PageExhausted(
                f"no spare page to detach shared page {src} for {key!r}")
        dst = self._lease(1)[0]
        tab[block] = dst
        self.decref(src)
        return src, dst

    # --------------------------------------------------------------- swap
    def park(self, key: Any, handle: Any, blocks: Optional[int] = None,
             inflight: bool = False) -> Tuple[List[int], int]:
        """End ``key``'s device residency for a (possibly partial) swap.

        The first ``blocks`` table entries, the sequence's coldest
        (oldest-position) pages, lose this slot's reference and are
        returned as ``(cold_pages, reservation)`` in logical order.  The
        hotter tail pages stay device-resident, re-keyed under
        ``handle``, until :meth:`unpark` splices them back behind the
        reloaded prefix.  ``blocks=None`` sheds the whole table.  With
        ``inflight=True`` freed pages enter the in-flight set.
        """
        tab = self._tables.pop(key)       # KeyError = not a holder
        res = self._reserved.pop(key, 0)
        k = len(tab) if blocks is None else blocks
        if not 0 <= k <= len(tab):
            self._tables[key] = tab       # restore before raising
            self._reserved[key] = res
            raise ValueError(f"cannot shed {k} of {len(tab)} pages "
                             f"for {key!r}")
        cold, tail = tab[:k], tab[k:]
        for p in reversed(cold):
            self.decref(p, inflight=inflight)
        if tail:
            self._tables[handle] = tail
        return list(cold), res

    def unpark(self, handle: Any, key: Any, blocks: int,
               reserve: int = 0) -> Optional[List[int]]:
        """Lease ``blocks`` fresh pages (and re-book ``reserve``) for a
        resuming slot, splicing any tail retained under ``handle`` behind
        them.  Returns the fresh prefix page ids, or ``None`` when the
        pool cannot cover ``blocks + reserve`` now (the tail stays put).
        Raises ``ValueError`` when ``key`` still holds pages; the holder
        check comes first, so a refused call changes nothing."""
        if blocks < 0 or reserve < 0:
            raise ValueError("blocks/reserve must be >= 0")
        if key in self._tables:
            raise ValueError(f"slot {key!r} already holds pages")
        tail = self._tables.pop(handle, [])
        if blocks + reserve > self.available_pages:
            if tail:
                self._tables[handle] = tail
            return None
        new = self._lease(blocks)
        self._tables[key] = new + tail
        self._reserved[key] = reserve
        return new

    def swap_out(self, key: Any) -> Tuple[List[int], int]:
        """End ``key``'s device residency for a full host swap: returns
        ``(pages, reservation)``, the page ids in logical order and the
        unspent reservation to re-book on swap-in.  The pages are
        re-issuable at once."""
        return self.park(key, key)

    def swap_in(self, key: Any, blocks: int,
                reserve: int = 0) -> Optional[List[int]]:
        """Lease ``blocks`` pages (and re-book ``reserve``) for a swapped
        in slot; ``None`` when the pool cannot cover it now.  The ids
        generally differ from those ``swap_out`` returned.  Raises
        ``ValueError`` when ``key`` already holds device pages."""
        return self.unpark(key, key, blocks, reserve)

    # ------------------------------------------------------------- resize
    def resize(self, target: int) -> int:
        """Retarget the usable-page capacity; returns the actual size.

        Growth mints fresh ids; a shrink removes a contiguous run of free
        pages from the top, clamped so that no referenced, in-flight or
        reserved page is ever dropped.
        """
        target = max(int(target), 1)
        if target > self._capacity:
            self._free.extend(range(self._capacity + 1, target + 1))
            self._capacity = target
            return self._capacity
        in_use_max = max(max(self._refs, default=0),
                         max(self._inflight, default=0))
        floor = max(target, in_use_max)
        budget = self.free_pages - self.reserved_pages
        free_set = set(self._free)
        new_cap = self._capacity
        while new_cap > floor and budget > 0 and new_cap in free_set:
            free_set.remove(new_cap)
            new_cap -= 1
            budget -= 1
        self._free = sorted(free_set, reverse=True)
        self._capacity = new_cap
        return self._capacity


# ---------------------------------------------------------------------------
# host page pool (swap-to-host tier)
# ---------------------------------------------------------------------------

_LEAF_NAMES = ("k", "v", "k_scale", "v_scale")


def _pool_leaves(pools) -> Iterator[torch.Tensor]:
    """Every pool tensor of a pooled cache dict, page axis 0, in a stable
    order shared with the host tier's byte layout."""
    for layer in pools["blocks"]:
        for name in _LEAF_NAMES:
            if name in layer:
                yield layer[name]


def _row_nbytes(leaf: torch.Tensor) -> int:
    return leaf.element_size() * (leaf.numel() // leaf.shape[0])


def _runs(ids: Sequence[int]) -> List[Tuple[int, int, int]]:
    """``(at, first, n)``: ids[at:at + n] == first .. first + n - 1."""
    out: List[Tuple[int, int, int]] = []
    for i, p in enumerate(ids):
        if out and out[-1][1] + out[-1][2] == p:
            at, first, n = out[-1]
            out[-1] = (at, first, n + 1)
        else:
            out.append((i, p, 1))
    return out


class HostPagePool:
    """Host-side KV page store for swapped-out slots.

    Bookkeeping mirrors :class:`PagePool` (a free-list of fixed-size
    pages) with 0-based ids and no trash page.  Each holder remembers the
    device reservation it must re-book on swap-in.  The page data lives
    in one ``(capacity, page_nbytes)`` byte tensor, built at the first
    :meth:`store` and pinned when the pools are on the card.
    ``capacity`` may be 0: such a pool cannot swap.
    """

    def __init__(self, capacity: int, page_size: int):
        if capacity < 0:
            raise ValueError("capacity must be >= 0")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.page_size = page_size
        self._capacity = capacity
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        self._held: Dict[Any, List[int]] = {}
        self._reserve: Dict[Any, int] = {}
        self.mirror: Optional[torch.Tensor] = None

    # ------------------------------------------------------------ queries
    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return sum(len(p) for p in self._held.values())

    def holders(self) -> List[Any]:
        return list(self._held)

    def pages(self, key: Any) -> List[int]:
        return list(self._held[key])

    def reservation(self, key: Any) -> int:
        return self._reserve[key]

    def can_hold(self, blocks: int) -> bool:
        return blocks <= len(self._free)

    # ---------------------------------------------------------- lifecycle
    def acquire(self, key: Any, blocks: int,
                reserve: int = 0) -> Optional[List[int]]:
        """Lease ``blocks`` host pages for a swapped-out slot, recording
        the device reservation to restore on swap-in.  ``None`` when the
        host pool cannot hold the slot."""
        if key in self._held:
            raise ValueError(f"handle {key!r} already holds host pages")
        if blocks < 0 or reserve < 0:
            raise ValueError("blocks/reserve must be >= 0")
        if blocks > len(self._free):
            return None
        got = [self._free.pop() for _ in range(blocks)]
        self._held[key] = got
        self._reserve[key] = reserve
        return got

    def release(self, key: Any) -> List[int]:
        """Return ``key``'s host pages to the free list (swap-in done,
        or the parked request was cancelled)."""
        got = self._held.pop(key)          # KeyError = double free
        self._reserve.pop(key, None)
        self._free.extend(reversed(got))
        return got

    def resize(self, target: int) -> int:
        """Retarget host capacity; returns the actual size.  Shrink drops
        only free pages from the top, clamped to one past the highest
        held page, so no parked slot's KV is ever dropped."""
        target = max(int(target), 0)
        if target > self._capacity:
            self._free = sorted(
                self._free + list(range(self._capacity, target)),
                reverse=True)
            self._capacity = target
        else:
            floor = max(target,
                        max((p for ps in self._held.values() for p in ps),
                            default=-1) + 1)
            self._free = sorted((p for p in self._free if p < floor),
                                reverse=True)
            self._capacity = floor
        if self.mirror is not None and self.mirror.shape[0] != self._capacity:
            old = self.mirror
            self.mirror = self._new_mirror(old.shape[1], old.is_pinned())
            keep = min(old.shape[0], self._capacity)
            self.mirror[:keep].copy_(old[:keep])
        return self._capacity

    # --------------------------------------------------------- page data
    def _new_mirror(self, page_nbytes: int, pinned: bool) -> torch.Tensor:
        return torch.empty((self._capacity, page_nbytes), dtype=torch.uint8,
                           pin_memory=pinned)

    def ensure_mirror(self, pools) -> torch.Tensor:
        if self.mirror is None:
            leaves = list(_pool_leaves(pools))
            self.mirror = self._new_mirror(
                sum(_row_nbytes(t) for t in leaves),
                leaves[0].device.type == "cuda")
        return self.mirror

    def store(self, pools, key: Any,
              dev_pages: Sequence[int]) -> Optional[torch.Tensor]:
        """Copy ``dev_pages`` (logical order) of every pool leaf into
        ``key``'s host pages.  On the card the copies are queued on the
        current stream and the device staging buffer is returned: it must
        live until they complete."""
        return _copy_pages(pools, self.ensure_mirror(pools),
                           self._held[key], list(dev_pages), "out")

    def load(self, pools, key: Any,
             dev_pages: Sequence[int]) -> Optional[torch.Tensor]:
        """Copy ``key``'s host pages into device pages ``dev_pages``
        (logical order), queued as :meth:`store` queues its copies."""
        return _copy_pages(pools, self.ensure_mirror(pools),
                           self._held[key], list(dev_pages), "in")


def _copy_pages(pools, mirror: torch.Tensor, hp: List[int], dp: List[int],
                direction: str) -> Optional[torch.Tensor]:
    """Move whole pages between the pool leaves and the host rows ``hp``.

    Pages are staged through one page-major device buffer ``(n,
    page_nbytes)``: a gather (or scatter) a leaf into its column of
    bytes, and one copy for each run of consecutive host pages.  On the
    card the copies are ``non_blocking`` between pinned host memory and
    the device, on the current stream."""
    n = len(dp)
    if n == 0:
        return None
    leaves = list(_pool_leaves(pools))
    dev = leaves[0].device
    idx = torch.as_tensor(dp, dtype=torch.long).to(dev, non_blocking=True)
    stage = torch.empty((n, mirror.shape[1]), dtype=torch.uint8, device=dev)
    cols, at = [], 0
    for leaf in leaves:
        nb = _row_nbytes(leaf)
        if at % leaf.element_size():
            raise ValueError("pool leaf rows must stay aligned in a page")
        cols.append((leaf, stage[:, at:at + nb].view(leaf.dtype).view(
            (n,) + tuple(leaf.shape[1:]))))
        at += nb
    if direction == "out":
        for leaf, col in cols:
            col.copy_(leaf.index_select(0, idx))
        for i, h, m in _runs(hp):
            mirror[h:h + m].copy_(stage[i:i + m], non_blocking=True)
    else:
        for i, h, m in _runs(hp):
            stage[i:i + m].copy_(mirror[h:h + m], non_blocking=True)
        for leaf, col in cols:
            leaf.index_copy_(0, idx, col)
    return stage


# ---------------------------------------------------------------------------
# device-facing paged cache
# ---------------------------------------------------------------------------

def resize_cache_rows(pools, rows: int) -> None:
    """Zero-pad or cut every leaf of a cache dict to ``rows`` along its
    leading axis, in place: the layer dicts get new tensors.  "Rows" are
    pool pages (trash page included) for a paged pool and slot rows for a
    dense cache; both keep that axis first.  A cut copies the kept rows
    into a fresh tensor, so the old storage, and with it the dropped rows'
    device bytes, is freed once the caller holds no other reference."""
    for layer in pools["blocks"]:
        for name, leaf in layer.items():
            if leaf.shape[0] == rows:
                continue
            new = leaf.new_zeros((rows,) + tuple(leaf.shape[1:]))
            keep = min(rows, leaf.shape[0])
            new[:keep].copy_(leaf[:keep])
            layer[name] = new


def _attn_only_kinds(cfg: ModelConfig) -> None:
    bad = {k for k, _ in cfg.layer_kinds()} - {"attn", "local"}
    if bad or cfg.encdec:
        raise NotImplementedError(
            f"paged KV cache supports attn/local mixers only, got "
            f"{sorted(bad)}{' + encdec' if cfg.encdec else ''}")


@dataclass
class _SwapJob:
    """One queued swap copy.

    ``kind="out"``: the device-to-host copy of ``pages`` (in flight until
    it lands).  ``kind="in"``: the host-to-device copy onto the fresh
    lease ``pages``; ``poll`` applies it (block table, host release).
    ``event`` marks the copy's end on the side stream (``None`` on the
    CPU: done at once); ``stage`` keeps its device buffer alive.
    """
    kind: str
    handle: Any
    slot: int
    pages: List[int]
    flight: List[int] = field(default_factory=list)
    event: Optional[Any] = None
    stage: Optional[torch.Tensor] = None

    def done(self) -> bool:
        return self.event is None or self.event.query()


class PagedKVCache:
    """Pool bookkeeping, the shared block table and the swap paths for
    one generator.

    The pool tensors live in the caller's cache dict (``init_stacked``)
    and are updated in place.  With ``overlap=True`` ``swap_out`` and
    ``swap_in`` queue their copies on a side CUDA stream and return;
    ``poll`` applies completed ones and ``fence`` waits for all.  Swap
    hazards on the card: the side stream waits for the compute stream
    before it reads or writes pool pages, pages freed by a swap-out stay
    in flight until its event completes, a slot with an outstanding
    swap-in keeps an all-trash table row until ``poll`` applies it, and
    the compute stream waits on that event before it decodes the slot.
    ``swap_stall_s`` adds up the wall clock the caller blocked on swap
    copies: every copy inline, only real waits with overlap.
    """

    def __init__(self, cfg: ModelConfig, num_slots: int, total_len: int,
                 page_size: int, num_pages: Optional[int] = None,
                 dtype=torch.float32, host_pages: Optional[int] = None,
                 kv_format: Optional[str] = None, overlap: bool = False,
                 device: DeviceLike = None, tracer=None, registry=None):
        _attn_only_kinds(cfg)
        if kv_format is None:
            kv_format = "bf16" if dtype == torch.bfloat16 else "fp32"
        if kv_format not in KV_FORMAT_DTYPE:
            raise ValueError(f"unknown kv_format {kv_format!r} "
                             f"(expected one of {sorted(KV_FORMAT_DTYPE)})")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num_slots = num_slots
        self.total_len = total_len
        self.page_size = page_size
        self.nmax = -(-total_len // page_size)
        worst = num_slots * self.nmax
        self.pool = PagePool(worst if num_pages is None else num_pages,
                             page_size)
        # host swap tier: by default it parks every slot worst-case
        self.host = HostPagePool(worst if host_pages is None else host_pages,
                                 page_size)
        self.kv_format = kv_format
        self.dtype = KV_FORMAT_DTYPE[kv_format]
        self.tracer = tracer or NULL_TRACER
        self.registry = registry or NULL_REGISTRY
        self._page_nbytes: Optional[int] = None
        self._tab = np.zeros((num_slots, self.nmax), np.int32)  # TRASH_PAGE
        self._tab_dev: Optional[torch.Tensor] = None
        self.swap_out_bytes = 0
        self.swap_in_bytes = 0
        self.swap_stall_s = 0.0
        self.overlap = overlap
        self._jobs: List[_SwapJob] = []
        self._side = None                    # the swap stream (card only)

    # ------------------------------------------------------ array builders
    @property
    def array_pages(self) -> int:
        """Leading pool-array dim: usable pages + the trash page row 0."""
        return self.pool.capacity + 1

    def init_stacked(self):
        """Pooled cache dict for the ``Model`` path: ``{"blocks": [{"k",
        "v"(, "k_scale", "v_scale")}] * num_layers}`` of zeroed pool
        tensors on the device."""
        from repro_torch.models import model as M
        return M.init_cache(
            self.cfg, self.array_pages, self.page_size, self.dtype,
            self.device, kv_format="int8" if self.kv_format == "int8"
            else None)

    def init_layered(self, kinds: Sequence) -> Dict[str, Any]:
        """Pooled caches for the ``StreamedExecutor`` path: the executor
        runs the ``Model``'s layers on the ``Model``'s per-layer cache
        list, so this is :meth:`init_stacked` (``kinds`` must be the
        model's layer kinds)."""
        if list(kinds) != list(self.cfg.layer_kinds()):
            raise ValueError("layer kinds differ from the model's")
        return self.init_stacked()

    def page_nbytes(self, pools) -> int:
        """Bytes one page occupies across every pool leaf (int8 pools:
        the int8 payload plus the fp32 scale rows)."""
        if self._page_nbytes is None:
            self._page_nbytes = sum(_row_nbytes(t)
                                    for t in _pool_leaves(pools))
        return self._page_nbytes

    def pool_nbytes(self, pools) -> int:
        """Bytes of every pool leaf (``page_nbytes * array_pages``)."""
        return sum(t.numel() * t.element_size() for t in _pool_leaves(pools))

    # -------------------------------------------------------- block table
    def device_tab(self) -> torch.Tensor:
        if self._tab_dev is None:
            self._tab_dev = torch.from_numpy(self._tab.copy()).to(self.device)
        return self._tab_dev

    def slot_tab(self, slot: int) -> torch.Tensor:
        """(1, nmax) block-table row for a batch=1 chunk prefill."""
        return self.device_tab()[slot:slot + 1]

    def _sync(self, slot: int, pages: List[int]) -> None:
        if pages:
            tab = self.pool.table(slot)
            self._tab[slot, :len(tab)] = tab
            self._tab_dev = None

    def _set_row(self, slot: int) -> None:
        """Point ``slot``'s table row at its pages (trash past them)."""
        tab = self.pool.table(slot)
        self._tab[slot, :] = TRASH_PAGE
        self._tab[slot, :len(tab)] = tab
        self._tab_dev = None

    def _trash_row(self, slot: int) -> None:
        self._tab[slot, :] = TRASH_PAGE
        self._tab_dev = None

    # ----------------------------------------------------------- lifecycle
    def admit(self, slot: int, length: int,
              shared: Sequence[int] = ()) -> bool:
        """Book ``slot``'s worst-case reservation; with ``shared`` the
        caller's pinned prefix pages become the head of the block table
        (references transfer, see ``PagePool.admit``)."""
        if not self.pool.admit(slot, length, shared=shared):
            return False
        if shared:
            self._tab[slot, :len(shared)] = list(shared)
            self._tab_dev = None
        return True

    def ensure(self, slot: int, length: int) -> None:
        self._sync(slot, self.pool.ensure(slot, length))

    def release(self, slot: int) -> None:
        self.pool.release(slot)
        self._trash_row(slot)

    def admit_capacity(self, length: int) -> int:
        return self.pool.admit_capacity(length)

    # ------------------------------------------------- sharing (CoW pages)
    def copy_page(self, pools, src: int, dst: int) -> None:
        """Whole-page copy ``src -> dst`` in every pool leaf, the int8
        scale rows included (the data half of copy-on-write), in place on
        the current stream."""
        for leaf in _pool_leaves(pools):
            leaf[dst] = leaf[src]

    def cow_block(self, pools, slot: int, block: int) -> bool:
        """Detach ``slot``'s ``block`` if shared: a fresh page, the data
        copied, the table entry repointed.  False when the page was
        already private.  May raise :class:`PageExhausted` (a draw from
        spares only, see ``PagePool.cow``)."""
        res = self.pool.cow(slot, block)
        if res is None:
            return False
        src, dst = res
        with self.tracer.span("kv.cow_copy", slot=slot, block=block):
            self.copy_page(pools, src, dst)
        self.registry.counter("kv.cow_copies").inc()
        self._tab[slot, block] = dst
        self._tab_dev = None
        return True

    # ------------------------------------------------------ swap-to-host
    @staticmethod
    def _tail_key(handle: Any) -> Tuple[str, Any]:
        """Device-pool key of a partial park's retained hot tail
        (namespaced: a request key never collides with a slot index)."""
        return ("kv.tail", handle)

    def can_swap_out(self, slot: int, pages: Optional[int] = None) -> bool:
        """The host pool can hold ``slot``'s pages (or the first
        ``pages`` of them) right now."""
        need = len(self.pool.table(slot)) if pages is None else pages
        return self.host.can_hold(need)

    def _side_stream(self):
        """The swap stream, after the compute stream's work so far."""
        if self.device.type != "cuda":
            return None
        if self._side is None:
            self._side = torch.cuda.Stream(device=self.device)
        self._side.wait_stream(torch.cuda.current_stream(self.device))
        return self._side

    def _queue(self, pools, handle: Any, pages: List[int], direction: str):
        """Queue one swap's copies; returns ``(event, stage)``."""
        fn = self.host.store if direction == "out" else self.host.load
        side = self._side_stream()
        if side is None:
            return None, fn(pools, handle, pages)
        with torch.cuda.stream(side):
            stage = fn(pools, handle, pages)
            event = torch.cuda.Event()
            event.record(side)
        return event, stage

    def _wait(self, event) -> None:
        """Block on a copy's event, counted as swap stall."""
        if event is not None and not event.query():
            t0 = time.perf_counter()
            event.synchronize()
            self.swap_stall_s += time.perf_counter() - t0

    def swap_out(self, pools, slot: int, handle: Any,
                 pages: Optional[int] = None) -> bool:
        """Preempt ``slot``: copy its pages to the host under ``handle``,
        free its device pages and reservation, and point its table row at
        the trash page.  ``False`` when the host pool lacks room: the
        slot stays live and untouched.

        ``pages=k`` sheds only the slot's ``k`` coldest (oldest-position)
        pages: the hot tail stays device-resident under ``handle`` and is
        spliced back behind the reloaded prefix on ``swap_in``.  With
        overlap the copy is queued and the freed pages stay in flight
        until ``poll`` sees it land; inline, the call blocks on it.
        """
        dev = self.pool.table(slot)
        k = len(dev) if pages is None else pages
        if not 0 <= k <= len(dev):
            raise ValueError(f"cannot swap {k} of {len(dev)} pages "
                             f"for slot {slot}")
        cold = dev[:k]
        if self.host.acquire(handle, k,
                             reserve=self.pool.reservation(slot)) is None:
            return False
        t0 = time.perf_counter()
        with self.tracer.span("swap.out", slot=slot, pages=k):
            event, stage = self._queue(pools, handle, cold, "out")
            if self.overlap:
                self.pool.park(slot, self._tail_key(handle), blocks=k,
                               inflight=True)
                self._jobs.append(_SwapJob(
                    kind="out", handle=handle, slot=slot, pages=list(cold),
                    flight=[p for p in cold if self.pool.is_inflight(p)],
                    event=event, stage=stage))
            else:
                if event is not None:
                    event.synchronize()
                self.pool.park(slot, self._tail_key(handle), blocks=k)
            self._trash_row(slot)
        if not self.overlap:
            self.swap_stall_s += time.perf_counter() - t0
        nbytes = k * self.page_nbytes(pools)
        self.swap_out_bytes += nbytes
        self.registry.counter("kv.swap_out_pages").inc(k)
        self.registry.counter("kv.swap_out_bytes").inc(nbytes)
        return True

    def swap_in(self, pools, slot: int, handle: Any) -> bool:
        """Resume ``handle`` into ``slot``: fresh physical pages (ids
        generally differ from the swapped-out ones), the host pages copied
        onto them in logical order, the table row remapped (a partial
        park's retained tail splices in behind).  ``False`` when the
        device pool cannot cover the pages plus the re-booked reservation
        (the request stays parked).

        With overlap the copy is queued: the slot's row stays all-trash
        (interim decode writes land on the trash page) until ``poll``
        applies the landed copy and reports the slot resumed.
        """
        blocks = len(self.host.pages(handle))
        new = self.pool.unpark(self._tail_key(handle), slot, blocks,
                               self.host.reservation(handle))
        if new is None:
            return False
        t0 = time.perf_counter()
        with self.tracer.span("swap.in", slot=slot, pages=blocks):
            event, stage = self._queue(pools, handle, new, "in")
            job = _SwapJob(kind="in", handle=handle, slot=slot, pages=new,
                           event=event, stage=stage)
            if self.overlap:
                self._jobs.append(job)
            else:
                if event is not None:
                    event.synchronize()
                self._apply_swap_in(job)
        if not self.overlap:
            self.swap_stall_s += time.perf_counter() - t0
        nbytes = blocks * self.page_nbytes(pools)
        self.swap_in_bytes += nbytes
        self.registry.counter("kv.swap_in_pages").inc(blocks)
        self.registry.counter("kv.swap_in_bytes").inc(nbytes)
        return True

    def _apply_swap_in(self, job: _SwapJob) -> None:
        if job.event is not None:   # decode reads the pages after the copy
            torch.cuda.current_stream(self.device).wait_event(job.event)
        self.host.release(job.handle)
        self._set_row(job.slot)

    # ------------------------------------------ async swap/decode overlap
    @property
    def outstanding(self) -> int:
        """Queued swap jobs not yet applied."""
        return len(self._jobs)

    def poll(self) -> Tuple[List[int], int]:
        """Apply completed jobs FIFO from the head; returns
        ``(resumed_slots, applied_count)``.  Never blocks."""
        resumed: List[int] = []
        applied = 0
        while self._jobs and self._jobs[0].done():
            job = self._jobs.pop(0)
            if job.kind == "out":
                self.pool.complete_inflight(job.flight)
            else:
                self._apply_swap_in(job)
                resumed.append(job.slot)
            applied += 1
        return resumed, applied

    def wait_any(self) -> bool:
        """Block (stall-counted) until the head job completes."""
        if not self._jobs:
            return False
        self._wait(self._jobs[0].event)
        return True

    def fence(self) -> Tuple[List[int], int]:
        """Wait for every queued swap copy and apply it; returns
        ``(resumed_slots, applied_count)`` like ``poll``."""
        for job in self._jobs:
            self._wait(job.event)
        return self.poll()

    def close(self) -> None:
        """Wait for queued copies without applying them (shutdown)."""
        for job in self._jobs:
            if job.event is not None:
                job.event.synchronize()

    def set_host_budget(self, pages: int) -> int:
        """Retarget the host pool (the placement's ``c_cpu`` KV share).
        Fence first: the resize replaces the host tensor queued copies
        use.  Copies the prefix cache queued on the current stream (its
        demotions) are waited for: the resize reads the old host tensor
        on the CPU."""
        if self._jobs:
            raise RuntimeError("fence outstanding swap copies before "
                               "resizing the host pool")
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return self.host.resize(pages)

    # ------------------------------------------------------ one-shot join
    def scatter_row_stacked(self, cache, row_cache, slot: int,
                            length: int) -> None:
        """Write a batch=1 dense prefill row's ``[0:length]`` prefix into
        the slot's pages, in place (``cache`` is the pooled dict of
        :meth:`init_stacked`, ``row_cache`` a dense one of one row).
        Int8 pools quantize on append: every touched page is written from
        offset 0 (a fresh lease), so its scales are reset, then set."""
        self.ensure(slot, length)
        idx = np.arange(length)
        pages = torch.from_numpy(
            self._tab[slot, idx // self.page_size].astype(np.int64)).to(
                self.device)
        offs = torch.from_numpy(idx % self.page_size).to(self.device)
        if self.kv_format == "int8":
            from repro_torch.kernels import quant
            with self.tracer.span("kv.quant_append", slot=slot,
                                  tokens=length):
                for pool, row in zip(cache["blocks"], row_cache["blocks"]):
                    for name in ("k", "v"):
                        quant.quantize_rows(pool[name], pool[name + "_scale"],
                                            row[name][:, :length], pages,
                                            offs)
            self.registry.counter("kv.quant_bytes").inc(
                length * self.cfg.kv_cache_bytes_per_token(1))
            self.registry.counter("kv.quant_tokens").inc(length)
            return
        for pool, row in zip(cache["blocks"], row_cache["blocks"]):
            for name in ("k", "v"):
                pool[name][pages, offs] = row[name][0, :length].to(
                    pool[name].dtype)

    def scatter_row_layered(self, caches, row_caches, slot: int,
                            length: int) -> None:
        """The same, for the ``StreamedExecutor`` path, whose caches have
        the ``Model``'s layout (see :meth:`init_layered`)."""
        self.scatter_row_stacked(caches, row_caches, slot, length)

    # -------------------------------------------------------------- resize
    def resize_slots(self, num_slots: int) -> None:
        """Retarget the block table's rows (new rows point at trash)."""
        if num_slots == self.num_slots:
            return
        tab = np.zeros((num_slots, self.nmax), np.int32)
        keep = min(num_slots, self.num_slots)
        tab[:keep] = self._tab[:keep]
        self._tab = tab
        self._tab_dev = None
        self.num_slots = num_slots

    def resize_pages(self, pools, target: int) -> int:
        """Retarget the page budget; returns the actual page count.
        Growth zero-pads the pool tensors; a shrink cuts them into fresh
        tensors (the pool guarantees the dropped ids are free), so their
        device bytes are given back.  Fence first: queued swap copies
        read and write the old tensors."""
        if self._jobs:
            raise RuntimeError("fence outstanding swap copies before "
                               "resizing the device pool")
        old = self.pool.capacity
        actual = self.pool.resize(target)
        if actual != old:
            resize_cache_rows(pools, actual + 1)
        return actual
