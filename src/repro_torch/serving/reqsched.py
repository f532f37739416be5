"""Request scheduler: the generation-side admission, preemption and
resume policy.

Ported from ``repro.serving.reqsched``.  It owns the request lifecycle::

    queued -> admitted -> running -> parked(full|partial) -> done
                 ^                        |
                 +------- resume ---------+

**Priority classes.**  ``Request.priority`` (1 = interactive outranks
0 = batch) orders admission, swap-victim selection (lowest class first,
then longest remaining budget) and resume.  The **aging rule** keeps
batch work from starving: a request's effective priority is ``priority +
waited / aging_s``.  A joiner may only preempt a victim of priority <= its
own, so batch arrivals never evict interactive work.

**Partial-slot swap.**  With ``partial_swap=True`` a preemption sheds only
the pages the blocked join needs (the victim's coldest); the hot tail
stays on the device and resume reloads just the shed prefix.

**Swap/decode overlap** is the generator's ``overlap_swap``: ``preempt``
and ``resume`` queue their copies on a side stream.

With default knobs (one priority class, full swap, inline copies) the
scheduler admits in arrival order and picks the victims of
``ContinuousGenerator.swap_victim``.  At every policy boundary
``apply_split`` applies the device-byte market's clearing to the
generator (slots, device, host and prefix page budgets), and
``priority_pressure`` is the signal the clearing weighs.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from repro_torch.obs.metrics import NULL_REGISTRY
from repro_torch.obs.trace import NULL_SPAN, NULL_TRACER
from repro_torch.serving.generator import ContinuousGenerator, SlotRef


def request_priority(key: Any) -> int:
    """Priority class of a request key (0 when the key carries none)."""
    return int(getattr(key, "priority", 0) or 0)


def _rid_of(key: Any) -> Optional[Any]:
    return getattr(key, "rid", None)


class RequestScheduler:
    """Owns admission, preemption and resume for one continuous engine.

    The engine wires ``capacity`` / ``admit`` into its ``StepPumpWorker``
    and calls ``tick`` before every decode step and ``apply_split`` at
    every policy boundary.  Every method runs on the single pump thread
    (or the ``pump_once`` seam).
    """

    def __init__(self, generator: ContinuousGenerator, context_queue,
                 *, aging_s: float = 30.0, partial_swap: bool = False,
                 tracer=None, registry=None):
        self.gen = generator
        self.queue = context_queue
        self.aging_s = max(float(aging_s), 1e-9)
        self.partial_swap = partial_swap
        self.tracer = tracer or NULL_TRACER
        self.registry = registry or NULL_REGISTRY
        self._seq: Dict[int, int] = {}      # id(req) -> intake order
        self._enq_t: Dict[int, float] = {}  # id(req) -> first-seen time
        self._next_seq = 0
        self._state: Dict[Any, str] = {}    # rid -> lifecycle state

    # ----------------------------------------------------------- lifecycle
    def _note(self, key: Any, state: str) -> None:
        rid = _rid_of(key)
        if rid is not None:
            self._state[rid] = state

    def note_queued(self, req: Any) -> None:
        self._note(req, "queued")

    def note_done(self, reqs: List[Any]) -> None:
        for r in reqs:
            self._note(r, "done")

    def in_flight_rids(self) -> List[Any]:
        """Rids of every request seen but not yet done (drain errors)."""
        return sorted((r for r, s in self._state.items() if s != "done"),
                      key=str)

    def snapshot(self) -> Dict[str, Any]:
        gen = self.gen
        by_state: Dict[str, List[Any]] = {}
        for rid, st in self._state.items():
            by_state.setdefault(st, []).append(rid)
        return {
            "queued": len(self.queue),
            "active_slots": gen.active_slots,
            "parked": gen.parked_slots,
            "pending_resume": len(gen.pending_resumes),
            "swap_jobs": gen.kv.outstanding if gen.paged else 0,
            "states": {k: sorted(v, key=str)
                       for k, v in sorted(by_state.items())},
        }

    # ------------------------------------------------------------ intake
    def _register(self, req: Any, t: float) -> None:
        if id(req) not in self._seq:
            self._seq[id(req)] = self._next_seq
            self._next_seq += 1
            self._enq_t[id(req)] = t

    def _effective(self, req: Any, t: float) -> float:
        """Aged priority: class + waited/aging_s (batch cannot starve)."""
        waited = max(0.0, t - self._enq_t.get(id(req), t))
        return request_priority(req) + waited / self.aging_s

    def capacity(self) -> int:
        """Joins the pump may pop right now.

        ``admit_capacity`` counts sure admits (free slots AND pages); a
        paged generator with host swap room also reports one speculative
        join when a victim of no higher priority than the best waiting
        request could be preempted for it, so a page- or slot-starved
        backlog takes the swap path instead of waiting for a leave.
        """
        gen = self.gen
        cap = gen.admit_capacity
        if cap != 0 or not gen.paged:
            return cap
        waiting = self.queue.snapshot()
        if not waiting:
            return 0
        limit = max(request_priority(r) for r in waiting)
        victim = self.select_victim(limit=limit)
        if victim is not None and gen.kv.can_swap_out(victim.index):
            return 1
        return 0

    def admit(self, reqs: List[Any]) -> None:
        """Join arrivals into free slots.  The popped items plus the rest
        of the context queue are ranked by aged priority (ties FIFO) and
        the top ``len(reqs)`` dispatch.  A join that does not fit preempts
        victims of no higher priority until it does; when no victim can
        be swapped out, the tail returns to the FRONT of the queue so
        admission order survives backpressure."""
        gen, q = self.gen, self.queue
        t = time.perf_counter()
        backlog = list(reqs) + q.pop_batch(len(q))
        for r in backlog:
            self._register(r, t)
        order = sorted(backlog, key=lambda r: (-self._effective(r, t),
                                               self._seq[id(r)]))
        dispatch, rest = order[:len(reqs)], order[len(reqs):]
        if rest:
            q.requeue(rest)
        span = (self.tracer.span("sched.admit", batch=len(dispatch))
                if self.tracer.enabled and dispatch else NULL_SPAN)
        with span:
            for i, r in enumerate(dispatch):
                with self.tracer.scope(getattr(r, "rid", None)):
                    ref = gen.join(r, r.prompt, r.max_new_tokens)
                    while ref is None and self.preempt_for_join(r):
                        ref = gen.join(r, r.prompt, r.max_new_tokens)
                if ref is None:
                    q.requeue(dispatch[i:])
                    break
                self._note(r, "running")
                r.t_gen_start = t
        if self.registry.enabled:
            self.registry.gauge("sched.queue_depth").set(
                float(len(self.queue)))
            self.registry.gauge("sched.parked").set(
                float(gen.parked_slots))

    # ---------------------------------------------------------- preemption
    def select_victim(self, limit: Optional[int] = None
                      ) -> Optional[SlotRef]:
        """Among live decodable slots of priority <= ``limit``: the lowest
        priority class, then the longest remaining budget, then the
        lowest slot index.  With one class this is
        ``ContinuousGenerator.swap_victim``'s choice."""
        gen = self.gen
        best_ref, best_key = None, None
        for ref in gen.table.active_refs():
            if not gen.preemptible(ref):
                continue
            st = gen.table.state(ref)
            pr = request_priority(st.key)
            if limit is not None and pr > limit:
                continue
            k = (pr, -st.remaining, ref.index)
            if best_key is None or k < best_key:
                best_ref, best_key = ref, k
        return best_ref

    def _shed_pages(self, victim: SlotRef, joiner: Any) -> Optional[int]:
        """Pages the victim must shed for ``joiner`` to fit (partial
        swap): the join's worst case less what freeing the slot already
        gives (spares and the victim's unspent reservation), clamped to
        [1, held].  ``None``: shed everything."""
        gen = self.gen
        g = gen.gen_cfg
        req = getattr(joiner, "max_new_tokens", None)
        budget = max(1, min(req if req is not None else g.max_new_tokens,
                            g.max_new_tokens))
        pool = gen.kv.pool
        need = pool.blocks_for(g.ctx_len + budget)
        held = len(pool.table(victim.index))
        short = (need - pool.available_pages
                 - pool.reservation(victim.index))
        if short >= held:
            return None
        return max(short, 1)

    def preempt_for_join(self, joiner: Any) -> bool:
        """Park the lowest-priority live slot so a blocked join can take
        its pages and its slot.  Victims are limited to the joiner's own
        class or below.  True when a victim was swapped out; False leaves
        pure backpressure (requeue)."""
        gen = self.gen
        if not gen.paged:
            return False
        victim = self.select_victim(limit=request_priority(joiner))
        if victim is None:
            return False
        pages = (self._shed_pages(victim, joiner) if self.partial_swap
                 else None)
        key = gen.table.state(victim).key
        span = (self.tracer.span("sched.preempt", slot=victim.index,
                                 pages=(pages if pages is not None
                                        else len(gen.kv.pool.table(
                                            victim.index))))
                if self.tracer.enabled else NULL_SPAN)
        with span:
            handle = gen.preempt(victim, pages=pages)
        if handle is None:
            return False
        self._note(key, "parked_partial" if pages is not None
                   else "parked")
        return True

    # -------------------------------------------------------------- resume
    def tick(self) -> None:
        """Swap parked requests back in, highest class first, FIFO within
        a class.  Backlogged joins of the same or a higher class go first,
        so swap never thrashes against admission; a parked request of a
        strictly higher class than everything waiting resumes ahead of the
        backlog.  With one class: resume only once the queue is empty."""
        gen = self.gen
        if not gen.parked_slots:
            return
        parked = [(h, gen.parked_request(h)) for h in gen.parked_keys()]
        order = sorted(parked, key=lambda hr: -request_priority(hr[1]))
        waiting = self.queue.snapshot()
        if waiting:
            best_wait = max(request_priority(r) for r in waiting)
            order = [hr for hr in order
                     if request_priority(hr[1]) > best_wait]
        for handle, req in order:
            if gen.resume(handle) is None:
                break               # slots/pages exhausted: retry later
            self._note(req, "running")

    # ------------------------------------------------------ policy boundary
    def apply_split(self, num_slots: int, split=None) -> Dict[str, int]:
        """Retarget the generator from the market's clearing: the slot
        count and, for a paged generator, the device, host and prefix page
        budgets (``retarget`` fences queued swap copies first, so tokens
        stay identical across the boundary)."""
        if split is None:
            return self.gen.retarget(num_slots=num_slots)
        # retarget ignores the page budgets of a dense generator and the
        # prefix budget of one without a prefix cache
        return self.gen.retarget(num_slots=num_slots,
                                 page_budget=split.kv_page_budget,
                                 host_page_budget=split.host_page_budget,
                                 prefix_page_budget=split.prefix_page_budget)

    def priority_pressure(self) -> float:
        """Fraction of waiting, live and parked work that is interactive
        (priority > 0): the market's priority-weighted clearing signal,
        under which the placement buys more decode throughput (KV pages)
        relative to retrieval residency."""
        n = hot = 0
        for r in self.queue.snapshot():
            n += 1
            hot += request_priority(r) > 0
        gen = self.gen
        for ref in gen.table.active_refs():
            n += 1
            hot += request_priority(gen.table.state(ref).key) > 0
        for handle in gen.parked_keys():
            n += 1
            hot += request_priority(gen.parked_request(handle)) > 0
        return hot / n if n else 0.0
