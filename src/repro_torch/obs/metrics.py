"""Central metrics registry: counters, gauges, log-bucket histograms.

Before this module, runtime accounting was scattered — ``SearchStats``
on the store, swap/CoW counters on the generator, occupancy on each
page pool, ``PolicyEvent`` as a bare list on the engine — so lining up,
say, swap bytes against prefix-cache demotions meant knowing five
different attribute paths.  The :class:`MetricsRegistry` gives them one
namespace:

* :meth:`MetricsRegistry.counter` — monotonic ``inc(n)`` totals
  (swap bytes, cache hits, partitions loaded).
* :meth:`MetricsRegistry.gauge` — last-write-wins ``set(v)`` levels
  (page-pool occupancy, slot utilization, resident bytes).
* :meth:`MetricsRegistry.histogram` — **fixed log-spaced bucket
  boundaries** chosen at construction, so distributions recorded by
  different runs (or merged across shards) are bucket-compatible;
  records latencies without storing samples.
* :meth:`MetricsRegistry.event` — a bounded structured event journal;
  the engine's per-boundary ``PolicyEvent`` payloads live here rather
  than as an unbounded list on the engine object.

``snapshot()`` returns one plain nested dict (JSON-safe), ``export``
writes it to disk, and everything is lock-protected so the retrieval
worker, generation pump, and streamer I/O thread can all record
concurrently.  The module-level :data:`NULL_REGISTRY` is a no-op
(:class:`NullRegistry`) whose instruments swallow updates, so
uninstrumented runs cost one attribute call per site.
"""
from __future__ import annotations

import json
import math
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple


class Counter:
    """Monotonic counter; ``inc`` with negative n is rejected."""
    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._v = 0.0
        self._lock = lock

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative inc {n}")
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        return self._v


class Gauge:
    """Last-write-wins level; ``add`` for relative moves."""
    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._v = 0.0
        self._lock = lock

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def add(self, dv: float) -> None:
        with self._lock:
            self._v += dv

    @property
    def value(self) -> float:
        return self._v


def log_buckets(lo: float = 1e-6, hi: float = 1e3,
                per_decade: int = 2) -> Tuple[float, ...]:
    """Fixed log-spaced boundaries from ``lo`` to ``hi`` inclusive.

    ``per_decade=2`` gives boundaries at every half-decade
    (1e-6, ~3.16e-6, 1e-5, ...): coarse enough to stay cheap, fine
    enough to separate a 3 ms decode step from a 30 ms swap.  The
    boundaries are a pure function of (lo, hi, per_decade), so two
    histograms built with the same parameters are always
    bucket-compatible — the stability property tests pin this down.
    """
    if not (0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
    n = int(round(math.log10(hi / lo) * per_decade))
    return tuple(lo * 10.0 ** (i / per_decade) for i in range(n + 1))


class Histogram:
    """Log-bucket histogram: counts per bucket, plus sum/count/min/max.

    Bucket i counts observations ``<= bounds[i]``; the implicit final
    bucket counts overflow (``> bounds[-1]``).
    """
    __slots__ = ("name", "bounds", "counts", "total", "count",
                 "min", "max", "_lock")

    def __init__(self, name: str, lock: threading.Lock,
                 bounds: Optional[Sequence[float]] = None):
        self.name = name
        self.bounds = tuple(bounds) if bounds is not None else log_buckets()
        if list(self.bounds) != sorted(self.bounds) or len(self.bounds) < 1:
            raise ValueError(f"histogram {name}: bounds must be sorted")
        self.counts = [0] * (len(self.bounds) + 1)
        self.total = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf
        self._lock = lock

    def observe(self, v: float) -> None:
        # Linear scan: bucket counts are small (~20) and observations
        # skew to the low buckets, so this beats bisect's call overhead.
        i = 0
        bounds = self.bounds
        n = len(bounds)
        while i < n and v > bounds[i]:
            i += 1
        with self._lock:
            self.counts[i] += 1
            self.total += v
            self.count += 1
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "count": self.count,
                "sum": self.total,
                "mean": self.mean,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "bounds": list(self.bounds),
                "counts": list(self.counts),
            }


class _NullInstrument:
    """Absorbs counter/gauge/histogram updates for NullRegistry."""
    __slots__ = ()
    name = "null"
    value = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def add(self, dv: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


_NULL_INSTRUMENT = _NullInstrument()


class NullRegistry:
    """Disabled metrics: every instrument is the shared null singleton."""
    __slots__ = ()
    enabled = False

    def counter(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def gauge(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def event(self, kind: str, **payload) -> None:
        pass

    def events(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        return []

    def snapshot(self) -> Dict[str, Any]:
        return {}

    def export(self, path: str) -> None:
        pass


NULL_REGISTRY = NullRegistry()


class MetricsRegistry:
    """One namespace for every runtime counter/gauge/histogram/event.

    Instruments are created on first use (``registry.counter("x")``)
    and cached by name, so call sites never need registration
    boilerplate; asking for the same name twice returns the same
    instrument.  Asking for a name already registered as a *different*
    instrument kind raises — a silent type collision would corrupt the
    snapshot.
    """

    enabled = True

    def __init__(self, max_events: int = 4096):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self._journal: deque = deque(maxlen=max_events)
        self._seq = 0

    # -------------------------------------------------------- instruments
    def _get(self, table: Dict[str, Any], name: str, factory):
        with self._lock:
            inst = table.get(name)
            if inst is None:
                for other in (self._counters, self._gauges, self._hists):
                    if other is not table and name in other:
                        raise ValueError(
                            f"metric {name!r} already registered as a "
                            f"different instrument kind")
                inst = table[name] = factory()
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name,
                         lambda: Counter(name, self._lock))

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name,
                         lambda: Gauge(name, self._lock))

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        h = self._get(self._hists, name,
                      lambda: Histogram(name, self._lock, bounds))
        if bounds is not None and tuple(bounds) != h.bounds:
            raise ValueError(
                f"histogram {name!r} re-registered with different bounds")
        return h

    # ------------------------------------------------------------ journal
    def event(self, kind: str, **payload) -> None:
        """Append a structured event (e.g. a policy-boundary decision)
        to the bounded journal."""
        with self._lock:
            self._seq += 1
            self._journal.append({"seq": self._seq, "kind": kind,
                                  **payload})

    def events(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            evs = list(self._journal)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs

    # ----------------------------------------------------------- snapshot
    def snapshot(self) -> Dict[str, Any]:
        """One JSON-safe nested dict of everything recorded so far."""
        with self._lock:
            counters = {n: c._v for n, c in self._counters.items()}
            gauges = {n: g._v for n, g in self._gauges.items()}
            hist_objs = dict(self._hists)
            evs = list(self._journal)
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": {n: h.to_dict() for n, h in hist_objs.items()},
            "events": evs,
        }

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, default=str,
                      sort_keys=True)
