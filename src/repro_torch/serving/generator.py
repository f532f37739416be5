"""Generation workers: whole-batch and continuous, on a dense or paged cache.

The two disciplines of ``repro.serving.generator``, each on the resident
``Model`` path or, with ``streamed=True``, on the offloading
:class:`~repro_torch.core.prefetch.StreamedExecutor` path (layers stream
from pinned host memory through a prefetch queue on every pass; the same
tokens):

``Generator``
    The whole-batch loop: prefill the batch together (one-shot, into a
    dense ``(B, ctx + new, KV, hd)`` cache), decode it together, return
    when every row is done.  It serves ``SerialRAGEngine`` and the
    whole-batch branch of ``RagdollEngine``.

``ContinuousGenerator``
    Iteration-level scheduling over a fixed-capacity **slot table**:
    requests ``join`` at any decode step, every ``step`` advances all
    live slots one greedy token, and ``harvest`` returns rows the moment
    they exhaust their token budget (or emit EOS).  Two KV layouts:

    * **dense** (default): one cache row of ``ctx + new`` positions per
      slot; ``join`` prefills at batch=1 and scatters the row into the
      slot (``_scatter_row``); dead slots keep riding the batched decode.
    * **paged** (``paged=True``): KV lives in a shared
      :class:`~repro_torch.serving.kvpool.PagedKVCache` pool and a join
      reserves only ``ceil((ctx + budget) / page_size)`` pages.  With
      ``prefill_chunk=N`` the prompt is prefilled ``N`` tokens per
      ``step`` interleaved with live decode; without it the join prefills
      one-shot and scatters the row into the slot's pages.

    With ``prefix_cache=True`` a radix tree over prompt tokens
    (:class:`~repro_torch.serving.prefixcache.PrefixCache`) keeps the KV
    pages of finished prefills; a joining prompt that matches a cached
    prefix maps those pages into its block table (refcount+1, read-only)
    and prefills only the novel suffix.  The partially matched boundary
    page is copied at join; a decode write that lands in a page still
    shared (a donor's cached tail) is detached copy-on-write before the
    step runs.  Cold cached prefixes demote to the host tier and revive
    on the next hit.

    The paged layout takes ``kv_format="int8"`` (pages quantized on
    append, per-page-per-head fp32 scales) and preemption to the host:
    ``preempt(ref)`` copies a live slot's pages (``pages=k``: its ``k``
    coldest) to the :class:`~repro_torch.serving.kvpool.HostPagePool` and
    ends its lease, ``resume(key)`` brings the request back into any free
    slot on fresh pages.  With ``overlap_swap=True`` the copies run on a
    side CUDA stream while unaffected slots decode; a slot whose swap-in
    is still in flight stays out of decode until ``step`` polls it in.

Slot lifecycle::

    free --acquire--> active --step*--> finished --harvest--> free
                      |    ^   (epoch bumped on release; stale SlotRefs
                 preempt   |    raise, across preempt/resume too)
                      v    resume (any free slot, fresh pages, remapped
                    parked         block table)

``resize``, ``set_page_budget`` and ``retarget`` change the slot table's
and the pools' capacity between steps (the placement policy's knobs).
Both paths keep one cache layout (the ``Model``'s per-layer list, written
in place), so every mechanism above serves both.  On the streamed path a
step's chunk prefills of one width ride one batched call (the layers
stream once a width group, not once a joiner), and its decode passes the
slot mask (a step with no live slot streams nothing).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.prefetch import PrefetchPolicy, StreamedExecutor
from repro_torch.models.model import Model, init_cache
from repro_torch.obs.metrics import NULL_REGISTRY
from repro_torch.obs.trace import NULL_SPAN, NULL_TRACER
from repro_torch.models.transformer import serves_tokens
from repro_torch.serving.kvpool import (TRASH_PAGE, PagedKVCache,
                                        PageExhausted, resize_cache_rows)
from repro_torch.serving.prefixcache import PrefixCache


class HashTokenizer:
    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def encode(self, text: str, length: int) -> np.ndarray:
        ids = []
        for w in text.lower().split()[:length]:
            h = int.from_bytes(
                hashlib.blake2b(w.encode(), digest_size=4).digest(), "little")
            ids.append(h % (self.vocab_size - 2) + 2)   # 0=pad, 1=bos
        ids = [1] + ids
        ids = ids[:length]
        ids = ids + [0] * (length - len(ids))
        return np.asarray(ids, np.int32)

    def decode(self, ids: Sequence[int]) -> str:
        return " ".join(f"tok{int(i)}" for i in ids)


@dataclass
class GeneratorConfig:
    ctx_len: int = 64
    max_new_tokens: int = 16
    dtype: object = torch.float32
    eos_id: Optional[int] = None   # None: always decode max_new_tokens


def _trim_at_eos(tokens: List[int], eos_id: Optional[int]) -> List[int]:
    if eos_id is None:
        return tokens
    for j, t in enumerate(tokens):
        if t == eos_id:
            return tokens[:j + 1]
    return tokens


class _GeneratorBase:
    """Shared model/tokenizer substrate for both batching disciplines.

    ``streamed=True`` runs the layers through a :class:`StreamedExecutor`
    (queue depths from ``policy``, default :class:`PrefetchPolicy`); the
    resident ``Model`` path ignores ``policy``.  ``device`` defaults to
    CUDA and raises when it is absent."""

    def __init__(self, cfg: ModelConfig, params, gen_cfg: GeneratorConfig,
                 streamed: bool = False,
                 policy: Optional[PrefetchPolicy] = None,
                 device: DeviceLike = None):
        if not serves_tokens(cfg):
            # the reference's generators crash on these (seamless: its
            # encoder is handed enc_embeds=None; chameleon: KeyError 'embed')
            raise NotImplementedError(
                f"{cfg.name}: the generators take token-frontend decoders "
                f"only (encdec={cfg.encdec}, frontend={cfg.frontend!r}); "
                "serve it through Model.prefill and Model.decode")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.gen_cfg = gen_cfg
        self.tok = HashTokenizer(cfg.vocab_size)
        self.streamed = streamed
        if streamed:
            self.exec: Optional[StreamedExecutor] = StreamedExecutor(
                cfg, params, policy or PrefetchPolicy(), device=self.device)
            self.model = None
            self.params = None
        else:
            self.exec = None
            self.model = Model(cfg, self.device)
            self.params = params

    def _device_ints(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _prefill(self, toks: torch.Tensor, cache) -> torch.Tensor:
        if self.streamed:
            return self.exec.prefill(toks, cache)
        return self.model.prefill(self.params, toks, cache)

    def _chunk_prefill(self, toks: torch.Tensor, cache, off: torch.Tensor,
                       block_tab: torch.Tensor, kv_span: int) -> torch.Tensor:
        if self.streamed:
            return self.exec.prefill_chunk(toks, cache, off,
                                           block_tab=block_tab,
                                           kv_span=kv_span)
        return self.model.chunk_prefill(self.params, toks, cache, off,
                                        block_tab, kv_span=kv_span)

    def _decode(self, cur: torch.Tensor, cache, pos: torch.Tensor,
                block_tab: Optional[torch.Tensor] = None,
                kv_span: Optional[int] = None,
                slot_mask: Optional[np.ndarray] = None) -> torch.Tensor:
        if self.streamed:
            return self.exec.decode(cur, cache, pos, slot_mask=slot_mask,
                                    block_tab=block_tab, kv_span=kv_span)
        return self.model.decode(self.params, cur, cache, pos, block_tab,
                                 kv_span=kv_span)


class Generator(_GeneratorBase):
    """Whole-batch prefill + greedy decode over a fixed-context batch."""

    def generate(self, prompts: List[str]) -> List[str]:
        g = self.gen_cfg
        b = len(prompts)
        toks = self._device_ints(
            np.stack([self.tok.encode(p, g.ctx_len) for p in prompts]))
        cache = init_cache(self.cfg, b, g.ctx_len + g.max_new_tokens,
                           g.dtype, self.device)
        logits = self._prefill(toks, cache)
        cur = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        outs = [cur]                # stay on the device: one copy at the end
        for t in range(g.max_new_tokens - 1):
            pos = torch.full((b,), g.ctx_len + t, dtype=torch.int32,
                             device=self.device)
            logits = self._decode(cur, cache, pos)
            cur = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            outs.append(cur)
        mat = torch.cat(outs, dim=1).cpu().numpy()     # (B, new)
        return [self.tok.decode(_trim_at_eos([int(t) for t in row],
                                             g.eos_id))
                for row in mat]


# ---------------------------------------------------------------------------
# slot table (pure bookkeeping)
# ---------------------------------------------------------------------------

class StaleSlotError(RuntimeError):
    """A SlotRef outlived its slot's lease (the slot was recycled)."""


@dataclass
class SlotState:
    key: Any                      # caller's request handle
    pos: int                      # absolute position: ctx_len + emitted
    remaining: int                # decode steps left in the token budget
    tokens: List[int] = field(default_factory=list)


@dataclass(frozen=True)
class SlotRef:
    """Capability to one lease of one slot: (index, epoch) pair."""
    index: int
    epoch: int


class SlotTable:
    """Fixed-capacity slot allocator with per-slot lease epochs.

    ``acquire`` leases the lowest free slot; ``release`` bumps the slot's
    epoch so any retained :class:`SlotRef` from the previous lease raises
    :class:`StaleSlotError` instead of touching a recycled slot.  Free
    and active slots partition the capacity.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        self._epochs: List[int] = [0] * capacity
        self._active: Dict[int, SlotState] = {}

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def active_slots(self) -> int:
        return len(self._active)

    def active_refs(self) -> List[SlotRef]:
        return [SlotRef(i, self._epochs[i]) for i in sorted(self._active)]

    def mask(self) -> np.ndarray:
        """(capacity,) bool: True where a slot is leased."""
        m = np.zeros(self.capacity, bool)
        for i in self._active:
            m[i] = True
        return m

    def state(self, ref: SlotRef) -> SlotState:
        self._check(ref)
        return self._active[ref.index]

    def _check(self, ref: SlotRef) -> None:
        if (ref.index not in self._active
                or self._epochs[ref.index] != ref.epoch):
            raise StaleSlotError(f"slot {ref.index} epoch {ref.epoch} "
                                 f"is not the live lease")

    def acquire(self, key: Any, pos: int, remaining: int
                ) -> Optional[SlotRef]:
        """Lease a free slot, or None when the table is full."""
        if not self._free:
            return None
        idx = self._free.pop()
        self._active[idx] = SlotState(key=key, pos=pos, remaining=remaining)
        return SlotRef(idx, self._epochs[idx])

    def advance(self, ref: SlotRef, token: int) -> SlotState:
        """Record one decode step for a live slot (position +1)."""
        self._check(ref)
        st = self._active[ref.index]
        st.tokens.append(int(token))
        st.pos += 1
        st.remaining -= 1
        return st

    def release(self, ref: SlotRef) -> SlotState:
        """End the lease: bump the epoch, return the slot to the free list."""
        self._check(ref)
        st = self._active.pop(ref.index)
        self._epochs[ref.index] += 1
        self._free.append(ref.index)
        return st

    def resize(self, target: int) -> int:
        """Retarget capacity; returns the actual new capacity.

        Growth appends fresh free slots; a shrink drops only free slots
        from the top, so the result is clamped to one past the highest
        active lease.  Dropped slots keep their epoch counters, so a
        SlotRef kept across a shrink and grow cycle still raises
        :class:`StaleSlotError` instead of validating against a fresh
        lease of the re-grown slot.
        """
        target = max(int(target), 1)
        if target > self.capacity:
            grown = list(range(self.capacity, target))
            if target > len(self._epochs):      # epochs survive a shrink
                self._epochs.extend([0] * (target - len(self._epochs)))
            self._free = sorted(self._free + grown, reverse=True)
            self.capacity = target
            return self.capacity
        floor = max(target, max(self._active, default=-1) + 1)
        self._free = sorted((i for i in self._free if i < floor),
                            reverse=True)
        self.capacity = floor
        return self.capacity


# ---------------------------------------------------------------------------
# continuous (iteration-level) generator
# ---------------------------------------------------------------------------

@dataclass
class _ChunkJob:
    """A join whose prompt is still being prefilled chunk by chunk."""
    ref: SlotRef
    toks: np.ndarray          # (ctx_len,) full padded prompt
    offset: int = 0           # next unwritten position


class _ParkHandle:
    """Opaque resume handle for an unhashable request key: the parked
    dict and the host pool index by identity, so mutable keys (the
    ``Request`` dataclass) work without touching their equality."""
    __slots__ = ("key",)

    def __init__(self, key: Any):
        self.key = key


def _park_handle(key: Any) -> Any:
    try:
        hash(key)
    except TypeError:
        return _ParkHandle(key)
    return key


@dataclass
class _Parked:
    """Host-side state of a preempted request, beside its KV pages in
    the host pool: the decode scalars and the tokens emitted so far."""
    key: Any
    tokens: List[int]         # emitted so far (harvest continuity)
    pos: int                  # SlotState.pos at preemption
    remaining: int            # decode budget left
    cur: int                  # pending token awaiting its KV write
    dec_pos: int              # _pos value: the next decode position
    trace_ids: Tuple = ()     # request trace scope, restored on resume


class ContinuousGenerator(_GeneratorBase):
    """Decode-step batching over a dense cache or a paged pool.

    Dead slots keep riding the batched decode: dense rows are fully
    overwritten by the next join's scatter; paged block-table rows point
    at the trash page, so their writes never land in a live page.
    Outputs are token-identical to the JAX ``ContinuousGenerator`` and to
    the whole-batch :class:`Generator` on the same weights
    (``tests/test_torch_engine.py``, ``tests/test_torch_serve_batch.py``).
    """

    def __init__(self, cfg: ModelConfig, params, gen_cfg: GeneratorConfig,
                 num_slots: int = 4, streamed: bool = False,
                 policy: Optional[PrefetchPolicy] = None,
                 paged: bool = False, page_size: int = 8,
                 page_budget: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 host_page_budget: Optional[int] = None,
                 prefix_cache: bool = False,
                 prefix_page_budget: Optional[int] = None,
                 kv_format: Optional[str] = None,
                 overlap_swap: bool = False,
                 device: DeviceLike = None,
                 tracer=None, registry=None):
        if prefill_chunk is not None and not paged:
            raise ValueError("prefill_chunk requires paged=True")
        if kv_format is not None and not paged:
            raise ValueError("kv_format requires paged=True")
        if overlap_swap and not paged:
            raise ValueError("overlap_swap requires paged=True")
        if prefix_cache and not paged:
            raise ValueError("prefix_cache requires paged=True")
        if overlap_swap and prefix_cache:
            # the prefix cache copies to and from the host tier inline
            # (demote, revive), beside the queued swap copies
            raise ValueError("overlap_swap is incompatible with "
                             "prefix_cache")
        super().__init__(cfg, params, gen_cfg, streamed=streamed,
                         policy=policy, device=device)
        self.tracer = tracer or NULL_TRACER
        self.registry = registry or NULL_REGISTRY
        # slot -> the joining request's trace-id scope, so decode spans
        # (outside the engine's per-request scope) tag their requests
        self._slot_scope: Dict[int, Tuple] = {}
        self.num_slots = num_slots
        self.table = SlotTable(num_slots)
        total = gen_cfg.ctx_len + gen_cfg.max_new_tokens
        self._total = total
        self.paged = paged
        self.page_size = page_size
        self.prefill_chunk = prefill_chunk
        self.prefix: Optional[PrefixCache] = (
            PrefixCache(page_size, prefix_page_budget) if prefix_cache
            else None)
        # prefill and sharing counts (deterministic; fig8 reports them)
        self.joins = 0
        self.prefill_tokens = 0       # prompt tokens actually prefilled
        self.prefix_hit_tokens = 0    # prompt tokens served from the cache
        self.cow_copies = 0
        self._prefilling: Dict[int, _ChunkJob] = {}
        self._parked: Dict[Any, _Parked] = {}
        # slots whose swap-in copy is in flight: leased, but out of decode
        # until ``poll`` applies it
        self._pending_resume: set = set()
        self.swap_outs = 0
        self.swap_ins = 0
        self.peak_in_flight = 0
        if paged:
            self.kv: Optional[PagedKVCache] = PagedKVCache(
                cfg, num_slots, total, page_size, num_pages=page_budget,
                dtype=gen_cfg.dtype, host_pages=host_page_budget,
                kv_format=kv_format, overlap=overlap_swap,
                device=self.device, tracer=self.tracer,
                registry=self.registry)
            self.cache = (self.kv.init_layered(self.exec.layer_kinds())
                          if streamed else self.kv.init_stacked())
        else:
            self.kv = None
            self.cache = init_cache(cfg, num_slots, total, gen_cfg.dtype,
                                    self.device)
        # host-side per-slot scalars (tiny; copied to the device per step)
        self._cur = np.zeros(num_slots, np.int32)
        self._pos = np.zeros(num_slots, np.int32)
        self._finished: List[Tuple[Any, str, List[int]]] = []
        self.steps = 0

    # ------------------------------------------------------------ helpers
    def bind_obs(self, tracer=None, registry=None) -> None:
        """Late-bind the engine's tracer/registry."""
        if tracer is not None:
            self.tracer = tracer
            if self.kv is not None:
                self.kv.tracer = tracer
        if registry is not None:
            self.registry = registry
            if self.kv is not None:
                self.kv.registry = registry

    def _scope_ids(self, slots) -> List:
        ids = set()
        for s in slots:
            ids.update(self._slot_scope.get(s, ()))
        return sorted(ids, key=str)

    @property
    def kv_format(self) -> str:
        """The KV byte format: the paged pool's, else the dense dtype's."""
        if self.kv is not None:
            return self.kv.kv_format
        return "bf16" if self.gen_cfg.dtype == torch.bfloat16 else "fp32"

    @property
    def free_slots(self) -> int:
        return self.table.free_slots

    @property
    def active_slots(self) -> int:
        return self.table.active_slots

    @property
    def admit_capacity(self) -> int:
        """Joins guaranteed to succeed right now (slots AND pages).  With
        a prefix cache, pages it could give up (refcount 1) count as
        available: ``join`` reclaims them on demand."""
        if not self.paged:
            return self.table.free_slots
        worst = self.gen_cfg.ctx_len + self.gen_cfg.max_new_tokens
        cap = self.kv.admit_capacity(worst)
        if self.prefix is not None and cap == 0:
            spare = (self.kv.pool.available_pages
                     + self.prefix.evictable_pages(self.kv))
            cap = spare // max(1, self.kv.pool.blocks_for(worst))
        return min(self.table.free_slots, cap)

    def _scatter_row(self, row_cache, slot: int) -> None:
        """Overwrite slot ``slot``'s dense cache row with a batch=1 cache:
        every leaf of each layer (``k``/``v``, MLA's ``ckv``/``krope``,
        Mamba's ``conv``/``state``)."""
        for tc, rc in zip(self.cache["blocks"], row_cache["blocks"]):
            for name, leaf in tc.items():
                leaf[slot] = rc[name][0]

    def _emit(self, ref: SlotRef, token: int) -> None:
        """Append one token; finish + free the slot on EOS / budget end."""
        st = self.table.advance(ref, token)
        self._cur[ref.index] = token
        # the emitted token is pending its KV write: the next decode call
        # runs at pos - 1
        self._pos[ref.index] = st.pos - 1
        eos = self.gen_cfg.eos_id
        if st.remaining <= 0 or (eos is not None and token == eos):
            st = self.table.release(ref)
            self._cur[ref.index] = 0
            # park the dead slot's writes on its last position: dense rows
            # are fully overwritten by the next join's scatter; a paged
            # slot's table points at the trash page, so its writes can
            # never hit a reissued page
            if self.paged:
                self.kv.release(ref.index)
            self._slot_scope.pop(ref.index, None)
            self._finished.append(
                (st.key, self.tok.decode(st.tokens), list(st.tokens)))

    # ------------------------------------------------------------- public
    def join(self, key: Any, prompt: str,
             max_new_tokens: Optional[int] = None) -> Optional[SlotRef]:
        """Prefill ``prompt`` into a free slot; None when the table is full
        or (paged) the page pool cannot cover the request's worst case.

        The first token is emitted by the prefill itself (as in the
        whole-batch loop), so a budget of 1 finishes without any step.
        With chunked prefill the slot is leased at once, but the prompt's
        chunks ride the following ``step`` calls and the first token
        appears after the last chunk lands.

        With ``prefix_cache=True`` the prompt is first walked against the
        radix cache: matched full pages map into the block table, shared,
        a partially matched boundary page is copied into a private page,
        and only the ``ctx_len - matched`` suffix tokens are prefilled
        (``matched`` is capped at ``ctx_len - 1``, so the suffix prefill
        always gives the first token's logits)."""
        g = self.gen_cfg
        req = g.max_new_tokens if max_new_tokens is None else max_new_tokens
        # prefill always emits the first token, so the budget floor is 1
        budget = max(1, min(req, g.max_new_tokens))
        ref = self.table.acquire(key, pos=g.ctx_len, remaining=budget)
        if ref is None:
            return None
        ptoks = self.tok.encode(prompt, g.ctx_len)
        matched = 0
        if self.paged:
            if self.prefix is not None:
                m = self._admit_shared(ref, ptoks, g.ctx_len + budget)
                if m is None:
                    self.table.release(ref)     # page backpressure
                    return None
                matched = m
            elif not self.kv.admit(ref.index, g.ctx_len + budget):
                self.table.release(ref)         # page backpressure
                return None
        self.joins += 1
        self.prefill_tokens += g.ctx_len - matched
        self.peak_in_flight = max(self.peak_in_flight, self.in_flight)
        if self.tracer.enabled:
            self._slot_scope[ref.index] = self.tracer.current_scope()
        if self.prefill_chunk is not None:
            # park decode writes on the last position: its page is either
            # unallocated (-> trash) or self-overwritten by the final
            # decode step before it is ever read.  A prefix hit starts the
            # job at the matched offset: only the suffix chunks run
            self._prefilling[ref.index] = _ChunkJob(ref=ref, toks=ptoks,
                                                    offset=matched)
            self._cur[ref.index] = 0
            self._pos[ref.index] = self._total - 1
            return ref
        if matched > 0:
            # suffix-only prefill through the block table (the shared
            # prefix pages give positions [0, matched) to attention)
            with self.tracer.span("prefill", slot=ref.index,
                                  tokens=g.ctx_len - matched,
                                  matched=matched):
                self.kv.ensure(ref.index, g.ctx_len)
                off = torch.full((1,), matched, dtype=torch.int32,
                                 device=self.device)
                logits = self._chunk_prefill(
                    self._device_ints(ptoks[None, matched:]), self.cache,
                    off, self.kv.slot_tab(ref.index), g.ctx_len)
            self._prefix_insert(ref.index, ptoks)
            self._emit(ref, int(torch.argmax(logits[0])))
            return ref
        with self.tracer.span("prefill", slot=ref.index, tokens=g.ctx_len):
            row = init_cache(self.cfg, 1, self._total, g.dtype, self.device)
            logits = self._prefill(self._device_ints(ptoks[None]), row)
            if self.paged and self.streamed:
                self.kv.scatter_row_layered(self.cache, row, ref.index,
                                            g.ctx_len)
            elif self.paged:
                self.kv.scatter_row_stacked(self.cache, row, ref.index,
                                            g.ctx_len)
            else:
                self._scatter_row(row, ref.index)
        if self.paged:
            self._prefix_insert(ref.index, ptoks)
        self._emit(ref, int(torch.argmax(logits[0])))
        return ref

    # --------------------------------------------------- prefix sharing
    def _admit_shared(self, ref: SlotRef, toks: np.ndarray,
                      length: int) -> Optional[int]:
        """Prefix-aware admission: match, map the shared pages, copy the
        boundary page.  Returns the matched token count (0: a miss), or
        ``None`` on page backpressure (nothing retained).

        The match pins every node it returns, so an eviction between here
        and the admit below can never free a matched page.  Full-page pins
        transfer to the joiner's block table; the boundary pin is dropped
        once its page is copied.
        """
        g = self.gen_cfg
        nodes, m = self.prefix.match(toks, self.kv, self.cache)
        # the suffix prefill must cover >= 1 token: it emits the first
        # output token
        m = min(m, g.ctx_len - 1)
        f, t = divmod(m, self.page_size)
        shared = [n.page for n in nodes[:f]]
        ok = self.kv.admit(ref.index, length, shared=shared)
        if not ok:
            # evict cold cached pages to fund the reservation, retry once
            short = (self.kv.pool.blocks_for(length) - f
                     - self.kv.pool.available_pages)
            if short > 0:
                self.prefix.reclaim(short, self.kv, self.cache)
                ok = self.kv.admit(ref.index, length, shared=shared)
        if not ok:
            self.prefix.unpin(nodes, self.kv)
            return None
        if t > 0:
            # the partially matched boundary page becomes a private copy
            # (the suffix prefill overwrites its tail in place)
            self.kv.ensure(ref.index, m)
            dst = self.kv.pool.table(ref.index)[f]
            self.kv.copy_page(self.cache, nodes[f].page, dst)
        self.prefix.unpin(nodes[f:], self.kv)
        if m > 0:
            self.prefix.stats.hits += 1
            self.prefix.stats.hit_tokens += m
            self.prefix_hit_tokens += m
        else:
            self.prefix.stats.misses += 1
        return m

    def _prefix_insert(self, slot: int, toks: np.ndarray) -> None:
        """Cache a freshly prefilled prompt's pages (refcount+1 each).
        Called once a prefill completes, before the first ``_emit``, so a
        budget-1 request that finishes at once still donates its prefix
        (the cache's references keep the pages past the release)."""
        if self.prefix is None:
            return
        blocks = self.kv.pool.blocks_for(self.gen_cfg.ctx_len)
        pages = self.kv.pool.table(slot)[:blocks]
        self.prefix.insert(toks, pages, self.kv, self.cache)

    def _cow_barrier(self, refs: List[SlotRef]) -> None:
        """Detach shared pages that this step's decode will write.

        A slot's pending write lands at ``_pos``; if that block is still
        shared (a donor's cached tail page), it is copied out first.  When
        no spare page can fund the copy, the page is un-cached instead:
        the cache is then the only other holder, so dropping its reference
        makes the page private and the write may go ahead in place.
        """
        for ref in refs:
            blk = int(self._pos[ref.index]) // self.page_size
            tab = self.kv.pool.table(ref.index)
            if blk >= len(tab) or self.kv.pool.refcount(tab[blk]) <= 1:
                continue
            try:
                if self.kv.cow_block(self.cache, ref.index, blk):
                    self.cow_copies += 1
            except PageExhausted:
                if not self.prefix.drop_page(tab[blk], self.kv):
                    raise

    def _advance_prefills(self) -> int:
        """Prefill one chunk for every joining slot.

        On the streamed path, slots whose next chunk has the same width
        ride one batched call (per-row offsets; the batch padded to a
        power of two with all-trash block-table rows at offset 0), so the
        offloaded layers stream once a width group, not once a joiner.
        On the resident path there is no copy to amortize, so each slot
        runs a batch=1 call.  Rows are independent, so neither choice
        changes tokens (in fp32; bf16 rounds other matmul shapes
        otherwise)."""
        g = self.gen_cfg
        groups: Dict[int, List[Tuple[int, _ChunkJob]]] = {}
        for slot in sorted(self._prefilling):
            job = self._prefilling[slot]
            c = min(self.prefill_chunk, g.ctx_len - job.offset)
            groups.setdefault(c, []).append((slot, job))
        finished: List[Tuple[int, int]] = []
        span = (self.tracer.span(
                    "prefill.chunk", slots=len(self._prefilling),
                    trace_ids=self._scope_ids(self._prefilling))
                if self.tracer.enabled else NULL_SPAN)
        with span:
            for c, members in sorted(groups.items()):
                for slot, job in members:
                    self.kv.ensure(slot, job.offset + c)
                tab = self.kv.device_tab()
                if not self.streamed:
                    for slot, job in members:
                        chunk = self._device_ints(
                            job.toks[None, job.offset:job.offset + c])
                        off = torch.full((1,), job.offset, dtype=torch.int32,
                                         device=self.device)
                        logits = self._chunk_prefill(
                            chunk, self.cache, off, tab[slot:slot + 1],
                            g.ctx_len)
                        job.offset += c
                        if job.offset >= g.ctx_len:
                            finished.append(
                                (slot, int(torch.argmax(logits[0]))))
                    continue
                n = len(members)
                padn = 1 << (n - 1).bit_length()
                rows = np.zeros((padn, c), np.int32)   # pad rows: token 0
                offs = np.zeros(padn, np.int32)        # ... at offset 0
                for r, (_, job) in enumerate(members):
                    rows[r] = job.toks[job.offset:job.offset + c]
                    offs[r] = job.offset
                bt = torch.full((padn, self.kv.nmax), TRASH_PAGE,
                                dtype=tab.dtype, device=self.device)
                bt[:n] = tab[self._device_ints(
                    np.asarray([slot for slot, _ in members]))]
                logits = self._chunk_prefill(
                    self._device_ints(rows), self.cache,
                    self._device_ints(offs), bt, g.ctx_len)
                nxt = torch.argmax(logits, dim=-1).cpu().numpy()
                for r, (slot, job) in enumerate(members):
                    job.offset += c
                    if job.offset >= g.ctx_len:
                        finished.append((slot, int(nxt[r])))
        progressed = len(self._prefilling)
        for slot, token in finished:
            job = self._prefilling.pop(slot)
            self._prefix_insert(slot, job.toks)  # donate before any release
            self._emit(job.ref, token)      # first token, as full prefill
        return progressed

    def step(self) -> int:
        """Advance every live slot one greedy decode step (and every
        joining slot one prefill chunk).  Returns the number of slots that
        made progress (0 = idle)."""
        progressed = 0
        overlap = self.paged and self.kv.overlap
        if overlap:
            progressed += self._poll_swaps()
        if self._prefilling:
            progressed += self._advance_prefills()
        refs = [r for r in self.table.active_refs()
                if r.index not in self._prefilling
                and r.index not in self._pending_resume]
        if not refs:
            if not progressed and overlap and self.kv.outstanding:
                # nothing can decode until a copy lands: wait for the
                # head job (stall-counted) so the pump keeps pumping
                self.kv.wait_any()
                progressed += self._poll_swaps()
            if progressed:
                self.steps += 1
            return progressed
        bt, span_len = None, None
        if self.paged:
            if self.prefix is not None:
                # copy-on-write: detach a still-shared page this step's
                # decode writes would land in (a donor's tail page)
                self._cow_barrier(refs)
            # allocate the page each live slot's pending write needs
            for ref in refs:
                self.kv.ensure(ref.index, int(self._pos[ref.index]) + 1)
            bt, span_len = self.kv.device_tab(), self._total
        span = (self.tracer.span(
                    "decode.step", slots=len(refs),
                    trace_ids=self._scope_ids(r.index for r in refs))
                if self.tracer.enabled else NULL_SPAN)
        mask = None
        if self.streamed:
            # live rows only: still prefilling or awaiting a swap-in is not
            mask = self.table.mask()
            mask[list(self._prefilling)] = False
            mask[list(self._pending_resume)] = False
        with span:
            cur = self._device_ints(self._cur)[:, None]
            pos = self._device_ints(self._pos)
            logits = self._decode(cur, self.cache, pos, bt, span_len, mask)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        if (self.paged and self.registry.enabled
                and self.kv.kv_format == "int8"):
            # dequantized reads: every live slot's context this step,
            # priced at its int8 payload bytes
            toks = sum(int(self._pos[r.index]) + 1 for r in refs)
            self.registry.counter("kv.dequant_bytes").inc(
                toks * self.cfg.kv_cache_bytes_per_token(1))
            self.registry.counter("kv.dequant_tokens").inc(toks)
        for ref in refs:
            self._emit(ref, int(nxt[ref.index]))
        self.steps += 1
        return len(refs) + progressed

    # ---------------------------------------------- preemption (swap-to-host)
    @property
    def parked_slots(self) -> int:
        return len(self._parked)

    def parked_keys(self) -> List[Any]:
        """Resume handles in preemption order (FIFO resume is fair)."""
        return list(self._parked)

    def parked_request(self, handle: Any) -> Any:
        """The request key a resume handle parks."""
        return self._parked[handle].key

    @property
    def pending_resumes(self) -> FrozenSet[int]:
        """Slots leased to a resumed request whose swap-in copy has not
        landed yet: they stay out of decode until ``step`` polls it."""
        return frozenset(self._pending_resume)

    @property
    def in_flight(self) -> int:
        """Requests admitted and unfinished: live slots + parked."""
        return self.table.active_slots + len(self._parked)

    def preemptible(self, ref: SlotRef) -> bool:
        """A live slot may be parked unless it is still chunk-prefilling
        or awaiting a swap-in."""
        return (ref.index not in self._prefilling
                and ref.index not in self._pending_resume)

    def swap_victim(self) -> Optional[SlotRef]:
        """The live slot with the most remaining budget (the last to
        finish), excluding slots still chunk-prefilling or awaiting a
        swap-in; ties to the lowest slot index.  The priority-aware form
        is ``RequestScheduler.select_victim``."""
        best, best_rem = None, -1
        for ref in self.table.active_refs():
            if not self.preemptible(ref):
                continue
            rem = self.table.state(ref).remaining
            if rem > best_rem:
                best, best_rem = ref, rem
        return best

    def preempt(self, ref: SlotRef,
                pages: Optional[int] = None) -> Optional[Any]:
        """Park a live slot: copy its KV pages to the host pool and end
        its lease.  Returns the resume handle, or ``None`` when the host
        pool cannot hold the pages (or the slot is still chunk-prefilling
        or awaiting a swap-in): the slot stays live.

        ``pages=k`` is a partial park: only the slot's ``k`` coldest
        pages move to the host, the hot tail stays on the device under
        the handle, and ``resume`` reloads just the shed prefix.  The
        release bumps the slot's epoch, so a SlotRef kept from before
        raises :class:`StaleSlotError`, against the resumed lease too.
        """
        if not self.paged:
            raise ValueError("preempt requires paged=True")
        st = self.table.state(ref)              # validates the lease
        if not self.preemptible(ref):
            return None
        handle = _park_handle(st.key)
        scope = self._slot_scope.get(ref.index, ())
        span = (self.tracer.span("swap.preempt", slot=ref.index,
                                 trace_ids=list(scope))
                if self.tracer.enabled else NULL_SPAN)
        with span:
            if not self.kv.swap_out(self.cache, ref.index, handle,
                                    pages=pages):
                return None                      # host pool exhausted
            st = self.table.release(ref)
        self._slot_scope.pop(ref.index, None)
        self._parked[handle] = _Parked(
            key=st.key, tokens=list(st.tokens), pos=st.pos,
            remaining=st.remaining, cur=int(self._cur[ref.index]),
            dec_pos=int(self._pos[ref.index]), trace_ids=tuple(scope))
        # the freed row rides the batched decode like any dead slot; its
        # table row points at the trash page
        self._cur[ref.index] = 0
        self.swap_outs += 1
        return handle

    def resume(self, key: Any) -> Optional[SlotRef]:
        """Bring a preempted request back into any free slot: a fresh
        lease (new epoch), fresh physical pages, its table row remapped.
        ``None`` when slots or device pages are still short: the request
        stays parked."""
        if not self.paged:
            raise ValueError("resume requires paged=True")
        parked = self._parked[key]
        ref = self.table.acquire(parked.key, pos=parked.pos,
                                 remaining=parked.remaining)
        if ref is None:
            return None
        span = (self.tracer.span("swap.resume", slot=ref.index,
                                 trace_ids=list(parked.trace_ids))
                if self.tracer.enabled else NULL_SPAN)
        with span:
            if not self.kv.swap_in(self.cache, ref.index, key):
                self.table.release(ref)          # pages still short
                return None
        if self.kv.overlap:
            # the copy is in flight: the slot is leased, its table row
            # stays all-trash, and decode skips it until poll applies it
            self._pending_resume.add(ref.index)
        if self.tracer.enabled and parked.trace_ids:
            self._slot_scope[ref.index] = parked.trace_ids
        self.table.state(ref).tokens.extend(parked.tokens)
        self._cur[ref.index] = parked.cur
        self._pos[ref.index] = parked.dec_pos
        del self._parked[key]
        self.swap_ins += 1
        return ref

    def _poll_swaps(self) -> int:
        """Apply landed swap copies (overlap); returns the number applied
        (step progress, so the pump keeps pumping while copies drain)."""
        resumed, applied = self.kv.poll()
        self._pending_resume.difference_update(resumed)
        return applied

    def fence(self) -> None:
        """Wait for every queued swap copy and apply it.  No-op without
        overlap."""
        if self.kv is None or not self.kv.overlap:
            return
        resumed, _ = self.kv.fence()
        self._pending_resume.difference_update(resumed)

    # -------------------------------------------------- dynamic capacity
    def resize(self, num_slots: int) -> int:
        """Grow or shrink the slot table; returns the actual capacity.

        A shrink drops only free top slots (never live work).  Paged mode
        touches just the block table; dense mode pads or cuts the cache
        rows (``resize_cache_rows``).
        """
        actual = self.table.resize(num_slots)
        if actual == self.num_slots:
            return actual
        keep = min(actual, self.num_slots)
        for name in ("_cur", "_pos"):
            arr = np.zeros(actual, np.int32)
            arr[:keep] = getattr(self, name)[:keep]
            setattr(self, name, arr)
        if self.paged:
            self.kv.resize_slots(actual)
        else:
            resize_cache_rows(self.cache, actual)
        self.num_slots = actual
        return actual

    def set_page_budget(self, pages: int) -> int:
        """Retarget the paged pool's usable-page budget (paged only).  A
        shrink first evicts cold cached prefix pages (LRU demotion to the
        host tier) so the cache never keeps the pool from its smaller
        share; the dropped pages' device bytes are given back."""
        if not self.paged:
            raise ValueError("set_page_budget requires paged=True")
        if self.prefix is not None:
            over = self.kv.pool.referenced_pages - pages
            if over > 0:
                self.prefix.reclaim(over, self.kv, self.cache)
        return self.kv.resize_pages(self.cache, pages)

    def set_host_page_budget(self, pages: int) -> int:
        """Retarget the host swap pool's page budget (paged only)."""
        if not self.paged:
            raise ValueError("set_host_page_budget requires paged=True")
        return self.kv.set_host_budget(pages)

    def retarget(self, num_slots: Optional[int] = None,
                 page_budget: Optional[int] = None,
                 host_page_budget: Optional[int] = None,
                 prefix_page_budget: Optional[int] = None
                 ) -> Dict[str, int]:
        """Apply a placement's capacity at a policy boundary.

        Outstanding swap copies are fenced first.  The page budget is
        clamped to what the block tables can address (``num_slots *
        nmax``) and floored at one worst-case request (``nmax``).  The
        host budget is capped at parking every slot worst-case; zero
        disables preemption.  The prefix budget caps the device pages the
        radix cache may hold, enforced at once by LRU demotion.
        """
        out: Dict[str, int] = {}
        self.fence()
        if num_slots is not None:
            out["slots"] = self.resize(num_slots)
        if page_budget is not None and self.paged:
            budget = max(min(page_budget, self.num_slots * self.kv.nmax),
                         self.kv.nmax)
            out["pages"] = self.set_page_budget(budget)
        if host_page_budget is not None and self.paged:
            budget = min(host_page_budget, self.num_slots * self.kv.nmax)
            out["host_pages"] = self.set_host_page_budget(budget)
        if (prefix_page_budget is not None and self.paged
                and self.prefix is not None):
            budget = max(0, min(prefix_page_budget, self.kv.pool.capacity))
            self.prefix.budget = budget
            self.prefix.enforce(self.kv, self.cache)
            out["prefix_pages"] = budget
        return out

    def harvest(self) -> List[Tuple[Any, str, List[int]]]:
        """Drain (key, text, tokens) for rows finished since last call."""
        out, self._finished = self._finished, []
        return out

    def run(self, prompts: List[str],
            schedule: Optional[Sequence[int]] = None) -> List[str]:
        """Convenience driver: join everything (as slots free), pump, drain.

        ``schedule[i]`` caps how many queued prompts may join before step
        ``i`` (joins beyond the schedule are unthrottled): the equivalence
        tests randomize join/leave interleavings with it.
        """
        pending = list(enumerate(prompts))[::-1]    # pop() = arrival order
        results: List[Optional[str]] = [None] * len(prompts)
        tick = 0
        while pending or self.active_slots:
            allow = len(pending)
            if schedule is not None and tick < len(schedule):
                allow = min(allow, schedule[tick])
            joined = 0
            while pending and joined < allow and self.admit_capacity > 0:
                key, prompt = pending.pop()
                if self.join(key, prompt) is None:
                    raise RuntimeError(f"join of prompt {key} refused "
                                       "with capacity to spare")
                joined += 1
            self.step()
            for key, text, _ in self.harvest():
                results[key] = text
            tick += 1
        for key, text, _ in self.harvest():
            results[key] = text
        return results     # type: ignore[return-value]
