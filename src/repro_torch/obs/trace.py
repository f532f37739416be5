"""Low-overhead span tracer emitting Chrome/Perfetto trace-event JSON.

The serving path is three threads (retrieval worker, generation pump,
partition-streamer I/O) plus the caller, and the whole point of RAGDoll
is what happens *between* them: a swap DMA stalling a decode step, a
partition load overlapped (or not) by the streamer, a market clearing
starving a sweep.  This tracer makes those relationships visible as one
Perfetto timeline:

* ``Tracer.span(name, **attrs)`` — context manager emitting a balanced
  ``B``/``E`` duration pair on the current thread's track.
* ``Tracer.begin(name)`` / ``Tracer.end(token)`` — explicit async
  (``b``/``e``) events for spans that start on one thread and end on
  another (a request's submit→completion lifetime crosses the retrieval
  and generation workers).
* ``Tracer.scope(*trace_ids)`` — a thread-local request-id scope: every
  span opened inside it is tagged ``args.trace_ids``, so a request's
  queue wait → probe → partition loads → prefill chunks → decode steps
  → swap out/in render as one per-request timeline across threads.
  ``current_scope()`` lets code that hops threads (the streamer's I/O
  worker) carry the ids across explicitly.
* ``Tracer.instant(name)`` / ``Tracer.counter(name, value)`` — point
  events and counter tracks.

Events land in a thread-safe **ring buffer** (bounded memory; the
oldest events drop first and ``dropped`` counts them), stored as plain
tuples — no dict per event until ``export``.  ``export(path)`` writes
the Chrome trace-event JSON object format (``{"traceEvents": [...]}``),
events sorted by timestamp (stable, so per-thread ``B``/``E`` nesting
survives ties), with thread-name metadata rows.  Open the file at
https://ui.perfetto.dev or chrome://tracing.

Disabled tracing costs one branch: the module-level :data:`NULL_TRACER`
is a :class:`NullTracer` whose ``span``/``scope`` return a shared no-op
context manager (one singleton, zero per-span event allocations) and
whose ``enabled`` flag lets hot loops skip even the attr packing::

    span = tracer.span("decode.step", slots=n) if tracer.enabled \
        else NULL_SPAN
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple


class _NullSpan:
    """Shared no-op context manager (also the null scope)."""
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracing: every call is a no-op costing one branch/call.

    ``span``/``scope`` return the shared :data:`NULL_SPAN` singleton —
    no event, no buffer touch, no per-span allocation beyond the
    interpreter's own call frame.
    """
    __slots__ = ()
    enabled = False

    def span(self, name: str, **attrs) -> _NullSpan:
        return NULL_SPAN

    def scope(self, *trace_ids) -> _NullSpan:
        return NULL_SPAN

    def current_scope(self) -> Tuple:
        return ()

    def begin(self, name: str, **attrs) -> None:
        return None

    def end(self, token) -> None:
        pass

    def instant(self, name: str, **attrs) -> None:
        pass

    def counter(self, name: str, value: float) -> None:
        pass

    def export(self, path: str) -> None:
        pass

    def events(self) -> List[Tuple]:
        return []


NULL_TRACER = NullTracer()


class _Span:
    """One live ``B``/``E`` pair; created per ``Tracer.span`` call."""
    __slots__ = ("_tr", "_name", "_attrs")

    def __init__(self, tr: "Tracer", name: str,
                 attrs: Optional[Dict[str, Any]]):
        self._tr = tr
        self._name = name
        self._attrs = attrs

    def __enter__(self) -> "_Span":
        self._tr._record("B", self._name, self._attrs)
        return self

    def __exit__(self, *exc) -> bool:
        self._tr._record("E", self._name, None)
        return False


class _Scope:
    """Thread-local trace-id scope pushed by ``Tracer.scope``."""
    __slots__ = ("_tr", "_ids")

    def __init__(self, tr: "Tracer", ids: Tuple):
        self._tr = tr
        self._ids = ids

    def __enter__(self) -> "_Scope":
        stack = getattr(self._tr._tls, "scope", None)
        if stack is None:
            stack = self._tr._tls.scope = []
        stack.append(self._ids)
        return self

    def __exit__(self, *exc) -> bool:
        self._tr._tls.scope.pop()
        return False


class Tracer:
    """Thread-safe ring-buffer span tracer (see module docstring)."""

    enabled = True

    def __init__(self, capacity: int = 1 << 16):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self._tnames: Dict[int, str] = {}
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self.dropped = 0

    # ------------------------------------------------------------- record
    def _record(self, ph: str, name: str, attrs: Optional[Dict[str, Any]],
                aid: Optional[int] = None) -> None:
        ts = (time.perf_counter() - self._t0) * 1e6   # microseconds
        tid = threading.get_ident()
        with self._lock:
            if tid not in self._tnames:
                self._tnames[tid] = threading.current_thread().name
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append((ph, name, ts, tid, aid, attrs))

    # ------------------------------------------------------------- public
    def span(self, name: str, **attrs) -> _Span:
        """Duration span on the current thread's track.  Tags the
        ambient :meth:`scope` trace ids as ``args.trace_ids`` unless the
        caller passed explicit ``trace_id``/``trace_ids``."""
        if "trace_id" not in attrs and "trace_ids" not in attrs:
            ids = self.current_scope()
            if ids:
                attrs["trace_ids"] = list(ids)
        return _Span(self, name, attrs or None)

    def scope(self, *trace_ids) -> _Scope:
        """Tag every span opened inside with these request/trace ids."""
        return _Scope(self, tuple(trace_ids))

    def current_scope(self) -> Tuple:
        """The innermost ambient trace-id tuple (empty outside a scope)."""
        stack = getattr(self._tls, "scope", None)
        return stack[-1] if stack else ()

    def begin(self, name: str, **attrs) -> Tuple[str, int]:
        """Open an async span that may :meth:`end` on another thread."""
        if "trace_id" not in attrs and "trace_ids" not in attrs:
            ids = self.current_scope()
            if ids:
                attrs["trace_ids"] = list(ids)
        aid = next(self._ids)
        self._record("b", name, attrs or None, aid=aid)
        return (name, aid)

    def end(self, token: Optional[Tuple[str, int]]) -> None:
        """Close an async span from any thread (None token = no-op, so
        callers can hold tokens from a possibly-null tracer)."""
        if token is None:
            return
        name, aid = token
        self._record("e", name, None, aid=aid)

    def instant(self, name: str, **attrs) -> None:
        if "trace_id" not in attrs and "trace_ids" not in attrs:
            ids = self.current_scope()
            if ids:
                attrs["trace_ids"] = list(ids)
        self._record("i", name, attrs or None)

    def counter(self, name: str, value: float) -> None:
        self._record("C", name, {"value": float(value)})

    def events(self) -> List[Tuple]:
        """Snapshot of the raw ring (tests / introspection)."""
        with self._lock:
            return list(self._ring)

    # ------------------------------------------------------------- export
    def export(self, path: str) -> int:
        """Write Chrome/Perfetto trace-event JSON; returns event count.

        Events are sorted by timestamp with a stable sort, so per-thread
        ``B``/``E`` nesting (already correct in ring order) survives
        timestamp ties.
        """
        pid = os.getpid()
        with self._lock:
            ring = list(self._ring)
            tnames = dict(self._tnames)
        ring.sort(key=lambda e: e[2])
        out: List[Dict[str, Any]] = []
        for tid, tname in sorted(tnames.items()):
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tid, "args": {"name": tname}})
        for ph, name, ts, tid, aid, attrs in ring:
            ev: Dict[str, Any] = {"name": name, "cat": "repro", "ph": ph,
                                  "ts": round(ts, 3), "pid": pid,
                                  "tid": tid}
            if aid is not None:
                ev["id"] = aid
            if ph == "i":
                ev["s"] = "t"          # thread-scoped instant
            if attrs:
                ev["args"] = attrs
            out.append(ev)
        with open(path, "w") as f:
            json.dump({"traceEvents": out, "displayTimeUnit": "ms",
                       "otherData": {"dropped_events": self.dropped}},
                      f, default=str)
        return len(ring)
