"""Observability: typed metrics and deterministic tracing, with the same
metric names, span names and attributes as the JAX package."""
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry, StatsShim
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Span, Tracer, trace_id_for

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "StatsShim",
           "NULL_TRACER", "NullTracer", "Span", "Tracer", "trace_id_for"]
