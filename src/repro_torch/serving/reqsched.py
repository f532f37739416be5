"""Request scheduler: the generation-side admission policy, default knobs.

Ported from ``repro.serving.reqsched``.  It owns the request lifecycle::

    queued -> admitted -> running -> done

and ranks admission by aged priority: a request's effective priority is
``priority + waited / aging_s`` (ties FIFO, so with one priority class
admission IS arrival order).  Preemption needs the host swap pool, which
comes with the swap slice of the port: here no victim can be swapped
out, so ``capacity`` never reports a speculative join and a join that
does not fit is requeued at the front (pure backpressure), which is the
JAX scheduler's own behaviour when its host pool is empty.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from repro_torch.obs.metrics import NULL_REGISTRY
from repro_torch.obs.trace import NULL_SPAN, NULL_TRACER
from repro_torch.serving.generator import ContinuousGenerator
from repro_torch.serving.kvpool import SWAP_SLICE


def request_priority(key: Any) -> int:
    """Priority class of a request key (0 when the key carries none)."""
    return int(getattr(key, "priority", 0) or 0)


def _rid_of(key: Any) -> Optional[Any]:
    return getattr(key, "rid", None)


class RequestScheduler:
    """Owns admission for one continuous engine.

    The engine wires ``capacity`` / ``admit`` into its ``StepPumpWorker``
    and calls ``tick`` before every decode step.  Every method runs on the
    single pump thread (or the ``pump_once`` seam).
    """

    def __init__(self, generator: ContinuousGenerator, context_queue,
                 *, aging_s: float = 30.0, partial_swap: bool = False,
                 tracer=None, registry=None):
        if partial_swap:
            raise NotImplementedError(f"partial swap: {SWAP_SLICE}")
        self.gen = generator
        self.queue = context_queue
        self.aging_s = max(float(aging_s), 1e-9)
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
        by_state: Dict[str, List[Any]] = {}
        for rid, st in self._state.items():
            by_state.setdefault(st, []).append(rid)
        return {
            "queued": len(self.queue),
            "active_slots": self.gen.active_slots,
            "parked": self.gen.parked_slots,
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
        """Joins the pump may pop right now (free slots AND pages; with no
        host swap tier there is no speculative preemption join)."""
        return self.gen.admit_capacity

    def admit(self, reqs: List[Any]) -> None:
        """Join arrivals into free slots.  The popped items plus the rest
        of the context queue are ranked by aged priority and the top
        ``len(reqs)`` dispatch; a join that does not fit returns the tail
        to the FRONT of the queue so admission order survives."""
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
                if ref is None:
                    q.requeue(dispatch[i:])
                    break
                self._note(r, "running")
                r.t_gen_start = t
        if self.registry.enabled:
            self.registry.gauge("sched.queue_depth").set(
                float(len(self.queue)))

    def tick(self) -> None:
        """Resume parked requests; nothing is ever parked in this slice."""
