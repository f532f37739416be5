"""Paged KV cache: a block-table page pool for continuous batching.

The device tier of ``repro.serving.kvpool``:

``PagePool``
    Pure host-side bookkeeping: a free-list of fixed-size KV *pages* and
    per-slot *block tables*.  Page id 0 is the reserved
    **trash page**, never allocated: freed slots' tables are reset to it,
    so a recycled slot's parked decode writes can never land in a page
    re-issued to another slot.  ``admit`` books a request's worst-case
    page count up front; ``ensure`` draws pages lazily as it grows.

``PagedKVCache``
    The device-facing half: per-layer pool tensors
    ``(num_pages + 1, page_size, kv_heads, head_dim)`` (row 0 = trash),
    the shared ``(num_slots, max_blocks)`` int32 block table and its
    device mirror.  Position ``p`` of slot ``s`` lives at
    ``(block_tab[s, p // page_size], p % page_size)`` in every layer.
    ``scatter_row_stacked`` writes a one-shot prefill's dense row into a
    joining slot's pages.

The host swap tier (``HostPagePool``, preemption, partial swap,
swap/decode overlap) and copy-on-write prefix pages come with the swap
slice of the port; the fp32 and bf16 formats are served, int8 pages come
with the quantized-KV slice.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig

TRASH_PAGE = 0

KV_FORMAT_DTYPE = {"fp32": torch.float32, "bf16": torch.bfloat16}

SWAP_SLICE = "the swap slice of the port (host page pool, preemption, CoW)"


class PageExhausted(RuntimeError):
    """The pool cannot supply the pages a live sequence needs."""


class PagePool:
    """Free-list of fixed-size KV pages with per-slot block tables.

    ``capacity`` counts *usable* pages (ids ``1..capacity``); id 0 is
    the reserved trash page.  ``admit`` books a worst-case reservation,
    ``ensure`` draws pages lazily (first from the slot's reservation,
    then from unreserved spares), ``release`` returns everything.
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

    # ------------------------------------------------------------ queries
    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def reserved_pages(self) -> int:
        return sum(self._reserved.values())

    @property
    def available_pages(self) -> int:
        """Free pages not backing any slot's reservation."""
        return self.free_pages - self.reserved_pages

    def blocks_for(self, length: int) -> int:
        return -(-max(length, 0) // self.page_size)

    def table(self, key: Any) -> List[int]:
        return list(self._tables[key])

    def admit_capacity(self, length: int) -> int:
        """How many worst-case-``length`` requests fit right now."""
        need = self.blocks_for(length)
        if need == 0:
            return self._capacity
        return self.available_pages // need

    # ---------------------------------------------------------- lifecycle
    def admit(self, key: Any, length: int) -> bool:
        """Reserve ``blocks_for(length)`` pages for a joining request."""
        if key in self._tables:
            raise ValueError(f"slot {key!r} already holds pages")
        need = self.blocks_for(length)
        if need > self.available_pages:
            return False
        self._tables[key] = []
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
        new = [self._free.pop() for _ in range(need)]
        tab.extend(new)
        self._reserved[key] = max(0, res - need)
        return new

    def release(self, key: Any) -> int:
        """End ``key``'s lease: its pages return to the free list and its
        unspent reservation lapses."""
        tab = self._tables.pop(key)       # KeyError = double free
        self._reserved.pop(key, None)
        self._free.extend(reversed(tab))  # low ids pop first again
        return len(tab)


def _attn_only_kinds(cfg: ModelConfig) -> None:
    bad = {k for k, _ in cfg.layer_kinds()} - {"attn", "local"}
    if bad or cfg.encdec:
        raise NotImplementedError(
            f"paged KV cache supports attn/local mixers only, got "
            f"{sorted(bad)}{' + encdec' if cfg.encdec else ''}")


class PagedKVCache:
    """Pool bookkeeping + the shared block table for one generator.

    The pool tensors live in the caller's cache dict (``init_stacked``);
    this object owns the :class:`PagePool`, the host block table and its
    lazily refreshed device mirror.
    """

    def __init__(self, cfg: ModelConfig, num_slots: int, total_len: int,
                 page_size: int, num_pages: Optional[int] = None,
                 dtype=torch.float32, host_pages: Optional[int] = None,
                 kv_format: Optional[str] = None,
                 device: DeviceLike = None):
        _attn_only_kinds(cfg)
        if host_pages:
            raise NotImplementedError(f"host swap pool: {SWAP_SLICE}")
        if kv_format is None:
            kv_format = "bf16" if dtype == torch.bfloat16 else "fp32"
        if kv_format == "int8":
            raise NotImplementedError("int8 KV pages: the quantized-KV slice")
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
        self.kv_format = kv_format
        self.dtype = KV_FORMAT_DTYPE[kv_format]
        self._tab = np.zeros((num_slots, self.nmax), np.int32)  # TRASH_PAGE
        self._tab_dev: Optional[torch.Tensor] = None

    @property
    def array_pages(self) -> int:
        """Leading pool-array dim: usable pages + the trash page row 0."""
        return self.pool.capacity + 1

    def init_stacked(self):
        """Pooled cache dict for the ``Model`` path: ``{"blocks": [{"k",
        "v"}] * num_layers}`` of zeroed pool tensors on the device."""
        from repro_torch.models import model as M
        return M.init_cache(self.cfg, self.array_pages, self.page_size,
                            self.dtype, self.device)

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

    # ----------------------------------------------------------- lifecycle
    def admit(self, slot: int, length: int) -> bool:
        return self.pool.admit(slot, length)

    def ensure(self, slot: int, length: int) -> None:
        self._sync(slot, self.pool.ensure(slot, length))

    def release(self, slot: int) -> None:
        self.pool.release(slot)
        self._tab[slot, :] = TRASH_PAGE
        self._tab_dev = None

    def admit_capacity(self, length: int) -> int:
        return self.pool.admit_capacity(length)

    # ------------------------------------------------------ one-shot join
    def scatter_row_stacked(self, cache, row_cache, slot: int,
                            length: int) -> None:
        """Write a batch=1 dense prefill row's ``[0:length]`` prefix into
        the slot's pages, in place (``cache`` is the pooled dict of
        :meth:`init_stacked`, ``row_cache`` a dense one of one row)."""
        self.ensure(slot, length)
        idx = np.arange(length)
        pages = torch.from_numpy(
            self._tab[slot, idx // self.page_size].astype(np.int64)).to(
                self.device)
        offs = torch.from_numpy(idx % self.page_size).to(self.device)
        for pool, row in zip(cache["blocks"], row_cache["blocks"]):
            for name in ("k", "v"):
                pool[name][pages, offs] = row[name][0, :length].to(
                    pool[name].dtype)
