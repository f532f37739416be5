"""Observability: span tracing + central metrics for the serving path.

Two halves, both with free no-op defaults so uninstrumented code pays
one branch per site:

* :mod:`repro_torch.obs.trace` — :class:`Tracer` (Perfetto trace-event
  export, per-request trace-id scopes, cross-thread async spans) and
  the :data:`NULL_TRACER` no-op.
* :mod:`repro_torch.obs.metrics` — :class:`MetricsRegistry` (counters,
  gauges, log-bucket histograms, bounded event journal) and the
  :data:`NULL_REGISTRY` no-op.
"""
from repro_torch.obs.trace import (  # noqa: F401
    NULL_SPAN,
    NULL_TRACER,
    NullTracer,
    Tracer,
)
from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NULL_REGISTRY,
    NullRegistry,
    log_buckets,
)

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "NULL_SPAN",
    "MetricsRegistry", "NullRegistry", "NULL_REGISTRY",
    "Counter", "Gauge", "Histogram", "log_buckets",
]
