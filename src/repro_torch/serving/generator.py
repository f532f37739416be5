"""Generation workers: whole-batch and continuous, on a dense or paged cache.

The two disciplines of ``repro.serving.generator``, on the ``Model`` path:

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

Not in the port yet, and raising ``NotImplementedError``: the
layer-streamed executor, prefix sharing, int8 KV pages, and preemption to
a host swap pool.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model, init_cache
from repro_torch.obs.metrics import NULL_REGISTRY
from repro_torch.obs.trace import NULL_SPAN, NULL_TRACER
from repro_torch.serving.kvpool import SWAP_SLICE, PagedKVCache


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

    ``device`` defaults to CUDA and raises when it is absent."""

    def __init__(self, cfg: ModelConfig, params, gen_cfg: GeneratorConfig,
                 streamed: bool = False, policy=None,
                 device: DeviceLike = None):
        if streamed or policy is not None:
            raise NotImplementedError("streamed: the layer-streaming slice")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.gen_cfg = gen_cfg
        self.tok = HashTokenizer(cfg.vocab_size)
        self.model = Model(cfg, self.device)
        self.params = params

    def _device_ints(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)


class Generator(_GeneratorBase):
    """Whole-batch prefill + greedy decode over a fixed-context batch."""

    def generate(self, prompts: List[str]) -> List[str]:
        g = self.gen_cfg
        b = len(prompts)
        toks = self._device_ints(
            np.stack([self.tok.encode(p, g.ctx_len) for p in prompts]))
        cache = init_cache(self.cfg, b, g.ctx_len + g.max_new_tokens,
                           g.dtype, self.device)
        logits = self.model.prefill(self.params, toks, cache)
        cur = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        outs = [cur]                # stay on the device: one copy at the end
        for t in range(g.max_new_tokens - 1):
            pos = torch.full((b,), g.ctx_len + t, dtype=torch.int32,
                             device=self.device)
            logits = self.model.decode(self.params, cur, cache, pos)
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
    :class:`StaleSlotError` instead of touching a recycled slot.
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


# ---------------------------------------------------------------------------
# continuous (iteration-level) generator
# ---------------------------------------------------------------------------

@dataclass
class _ChunkJob:
    """A join whose prompt is still being prefilled chunk by chunk."""
    ref: SlotRef
    toks: np.ndarray          # (ctx_len,) full padded prompt
    offset: int = 0           # next unwritten position


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
                 num_slots: int = 4, streamed: bool = False, policy=None,
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
        if prefix_cache or prefix_page_budget is not None or overlap_swap:
            raise NotImplementedError(f"prefix cache / overlap: {SWAP_SLICE}")
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
        self._prefilling: Dict[int, _ChunkJob] = {}
        if paged:
            self.kv: Optional[PagedKVCache] = PagedKVCache(
                cfg, num_slots, total, page_size, num_pages=page_budget,
                dtype=gen_cfg.dtype, host_pages=host_page_budget,
                kv_format=kv_format, device=self.device)
            self.cache = self.kv.init_stacked()
        else:
            self.kv = None
            self.cache = init_cache(cfg, num_slots, total, gen_cfg.dtype,
                                    self.device)
        # host-side per-slot scalars (tiny; copied to the device per step)
        self._cur = np.zeros(num_slots, np.int32)
        self._pos = np.zeros(num_slots, np.int32)
        self._finished: List[Tuple[Any, str, List[int]]] = []

    # ------------------------------------------------------------ helpers
    def bind_obs(self, tracer=None, registry=None) -> None:
        """Late-bind the engine's tracer/registry."""
        if tracer is not None:
            self.tracer = tracer
        if registry is not None:
            self.registry = registry

    def _scope_ids(self, slots) -> List:
        ids = set()
        for s in slots:
            ids.update(self._slot_scope.get(s, ()))
        return sorted(ids, key=str)

    @property
    def free_slots(self) -> int:
        return self.table.free_slots

    @property
    def active_slots(self) -> int:
        return self.table.active_slots

    @property
    def admit_capacity(self) -> int:
        """Joins guaranteed to succeed right now (slots AND pages)."""
        if not self.paged:
            return self.table.free_slots
        worst = self.gen_cfg.ctx_len + self.gen_cfg.max_new_tokens
        return min(self.table.free_slots, self.kv.admit_capacity(worst))

    def _scatter_row(self, row_cache, slot: int) -> None:
        """Overwrite slot ``slot``'s dense KV row with a batch=1 cache."""
        for tc, rc in zip(self.cache["blocks"], row_cache["blocks"]):
            for name in ("k", "v"):
                tc[name][slot] = rc[name][0]

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
        appears after the last chunk lands."""
        g = self.gen_cfg
        req = g.max_new_tokens if max_new_tokens is None else max_new_tokens
        # prefill always emits the first token, so the budget floor is 1
        budget = max(1, min(req, g.max_new_tokens))
        ref = self.table.acquire(key, pos=g.ctx_len, remaining=budget)
        if ref is None:
            return None
        ptoks = self.tok.encode(prompt, g.ctx_len)
        if self.paged and not self.kv.admit(ref.index, g.ctx_len + budget):
            self.table.release(ref)         # page backpressure
            return None
        if self.tracer.enabled:
            self._slot_scope[ref.index] = self.tracer.current_scope()
        if self.prefill_chunk is not None:
            # park decode writes on the last position: its page is either
            # unallocated (-> trash) or self-overwritten by the final
            # decode step before it is ever read
            self._prefilling[ref.index] = _ChunkJob(ref=ref, toks=ptoks)
            self._cur[ref.index] = 0
            self._pos[ref.index] = self._total - 1
            return ref
        with self.tracer.span("prefill", slot=ref.index, tokens=g.ctx_len):
            row = init_cache(self.cfg, 1, self._total, g.dtype, self.device)
            logits = self.model.prefill(self.params,
                                        self._device_ints(ptoks[None]), row)
            if self.paged:
                self.kv.scatter_row_stacked(self.cache, row, ref.index,
                                            g.ctx_len)
            else:
                self._scatter_row(row, ref.index)
        self._emit(ref, int(torch.argmax(logits[0])))
        return ref

    def _advance_prefills(self) -> int:
        """Prefill one chunk for every joining slot, one batch=1 call per
        slot (resident weights: nothing to amortize by batching them)."""
        g = self.gen_cfg
        finished: List[Tuple[int, int]] = []
        span = (self.tracer.span(
                    "prefill.chunk", slots=len(self._prefilling),
                    trace_ids=self._scope_ids(self._prefilling))
                if self.tracer.enabled else NULL_SPAN)
        with span:
            jobs = sorted(self._prefilling.items(),
                          key=lambda sj: (min(self.prefill_chunk,
                                              g.ctx_len - sj[1].offset),
                                          sj[0]))
            for slot, job in jobs:
                self.kv.ensure(slot, job.offset + min(
                    self.prefill_chunk, g.ctx_len - job.offset))
            tab = self.kv.device_tab()
            for slot, job in jobs:
                c = min(self.prefill_chunk, g.ctx_len - job.offset)
                chunk = self._device_ints(
                    job.toks[None, job.offset:job.offset + c])
                off = torch.full((1,), job.offset, dtype=torch.int32,
                                 device=self.device)
                logits = self.model.chunk_prefill(
                    self.params, chunk, self.cache, off, tab[slot:slot + 1],
                    kv_span=g.ctx_len)
                job.offset += c
                if job.offset >= g.ctx_len:
                    finished.append((slot, int(torch.argmax(logits[0]))))
        progressed = len(self._prefilling)
        for slot, token in finished:
            job = self._prefilling.pop(slot)
            self._emit(job.ref, token)      # first token, as full prefill
        return progressed

    def step(self) -> int:
        """Advance every live slot one greedy decode step (and every
        joining slot one prefill chunk).  Returns the number of slots that
        made progress (0 = idle)."""
        progressed = 0
        if self._prefilling:
            progressed += self._advance_prefills()
        refs = [r for r in self.table.active_refs()
                if r.index not in self._prefilling]
        if not refs:
            return progressed
        bt, span_len = None, None
        if self.paged:
            # allocate the page each live slot's pending write needs
            for ref in refs:
                self.kv.ensure(ref.index, int(self._pos[ref.index]) + 1)
            bt, span_len = self.kv.device_tab(), self._total
        span = (self.tracer.span(
                    "decode.step", slots=len(refs),
                    trace_ids=self._scope_ids(r.index for r in refs))
                if self.tracer.enabled else NULL_SPAN)
        with span:
            cur = self._device_ints(self._cur)[:, None]
            pos = self._device_ints(self._pos)
            logits = self.model.decode(self.params, cur, self.cache, pos, bt,
                                       kv_span=span_len)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        for ref in refs:
            self._emit(ref, int(nxt[ref.index]))
        return len(refs) + progressed

    @property
    def parked_slots(self) -> int:
        """Requests swapped to the host: none without the swap slice."""
        return 0

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
