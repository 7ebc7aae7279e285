"""Observability plane: deterministic tracing, typed metrics, PHI-safe export.

Three layers, all clock-injected and fully deterministic under a SimClock:

- :mod:`repro_torch.obs.metrics` — typed Counter/Gauge/Histogram with label sets,
  a :class:`MetricsRegistry` that aggregates across instances on snapshot,
  and :class:`StatsShim`, which lets the existing ``*.stats.field`` attribute
  surfaces keep working while the values live in real metrics.
- :mod:`repro_torch.obs.trace` — :class:`Tracer`/:class:`Span` with explicit
  context propagation (trace ids derived from ticket key + attempt),
  deterministic span ids, and a canonical SHA-256 trace digest so a seeded
  fleet run replays bit-identically. ``NULL_TRACER`` is a zero-overhead
  no-op used wherever tracing is disabled.
- :mod:`repro_torch.obs.export` — allowlist :class:`Redactor` plus JSONL and
  Chrome-trace exporters; *every* attribute and label crosses the redactor
  before leaving the process, making exported telemetry provably PHI-free.

On top of those sit the consumers (DESIGN.md §13):

- :mod:`repro_torch.obs.slo` — declarative :class:`SloSpec` objectives evaluated
  incrementally with multi-window burn-rate alerting; the full alert
  sequence replays from the engine's own observation log.
- :mod:`repro_torch.obs.profile` — :class:`CriticalPathProfiler`, folding finished
  spans into a deterministic per-(temperature, modality, stage) self-time
  profile with PHI-safe folded/Chrome exports.
- :mod:`repro_torch.obs.health` — :class:`HealthController`, turning SLO state
  into operator :class:`HealthReport` snapshots and a burn-rate pressure
  signal the autoscaler consumes.
"""
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry, StatsShim
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Span, Tracer, trace_id_for
from repro_torch.obs.export import (
    Redactor,
    export_metrics_jsonl,
    export_spans_jsonl,
    to_chrome_trace,
)
from repro_torch.obs.slo import (
    AlertEvent,
    BurnRule,
    SloEngine,
    SloSpec,
    default_burn_rules,
    derive_serve_observations,
)
from repro_torch.obs.profile import CriticalPathProfiler
from repro_torch.obs.health import HealthController, HealthReport

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "StatsShim",
    "NULL_TRACER",
    "NullTracer",
    "Span",
    "Tracer",
    "trace_id_for",
    "Redactor",
    "export_metrics_jsonl",
    "export_spans_jsonl",
    "to_chrome_trace",
    "AlertEvent",
    "BurnRule",
    "SloEngine",
    "SloSpec",
    "default_burn_rules",
    "derive_serve_observations",
    "CriticalPathProfiler",
    "HealthController",
    "HealthReport",
]
