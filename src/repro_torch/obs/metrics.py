"""Typed metrics: Counter/Gauge/Histogram, a registry, and the stats shim.

Naming convention (validated): ``repro_<subsystem>_<name>``, lowercase
``[a-z0-9_]``. Labels are plain string→string dicts; a metric family keys its
series by the canonical sorted label rendering, so iteration order of the
caller's kwargs never matters.

The registry is a *collection point*, not a uniqueness authority: several
components may each own an instance of the same family (e.g. every
``DeidPipeline`` has its own ``DetectStats``), and ``snapshot()`` aggregates
them by summing per-series — the same model as Prometheus multiprocess mode.
That keeps per-component attribute reads (``pipeline.scrub.detect_stats.detected``)
exact while fleet-level reads (``registry.value(...)``) see the total.

:class:`StatsShim` preserves the pre-obs attribute surfaces: subclasses
declare ``_SUBSYSTEM`` and ``_FIELDS`` and both ``stats.field`` reads and
``stats.field += 1`` writes route to label-free counters registered under
``repro_<subsystem>_<field>``.
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, Optional, Tuple

_NAME_RE = re.compile(r"^repro_[a-z0-9]+_[a-z0-9_]+$")
_LABEL_RE = re.compile(r"^[a-z_][a-z0-9_]*$")

DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0, float("inf"),
)


def _series_key(labels: Dict[str, str]) -> str:
    """Canonical label rendering: ``{a="1",b="x"}`` with sorted keys."""
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{labels[k]}"' for k in sorted(labels)) + "}"


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"metric name {name!r} must match repro_<subsystem>_<name>")
    return name


class _Metric:
    """Common family plumbing: name/help/registry + per-series storage."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", registry: Optional["MetricsRegistry"] = None):
        self.name = _check_name(name)
        self.help = help
        self._series: Dict[str, object] = {}
        if registry is not None:
            registry.register(self)

    def _key(self, labels: Dict[str, str]) -> str:
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"bad label name {k!r} on {self.name}")
        return _series_key({k: str(v) for k, v in labels.items()})


class Counter(_Metric):
    """Monotone (by convention) additive counter with optional labels."""

    kind = "counter"

    def inc(self, n: float = 1, **labels) -> None:
        key = self._key(labels)
        self._series[key] = self._series.get(key, 0) + n

    def set_total(self, value: float, **labels) -> None:
        """Shim escape hatch: ``stats.field += 1`` desugars to a read + set."""
        self._series[self._key(labels)] = value

    @property
    def value(self):
        """Label-free series value (0 when never incremented)."""
        return self._series.get("", 0)

    def series(self) -> Dict[str, float]:
        return dict(self._series)


class Gauge(_Metric):
    """Point-in-time value; ``set``/``inc``/``dec`` with optional labels."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._series[self._key(labels)] = value

    def inc(self, n: float = 1, **labels) -> None:
        key = self._key(labels)
        self._series[key] = self._series.get(key, 0) + n

    def dec(self, n: float = 1, **labels) -> None:
        self.inc(-n, **labels)

    @property
    def value(self):
        return self._series.get("", 0)

    def series(self) -> Dict[str, float]:
        return dict(self._series)


class Histogram(_Metric):
    """Fixed-bucket histogram; per-series cumulative bucket counts + sum."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        registry: Optional["MetricsRegistry"] = None,
        buckets: Iterable[float] = DEFAULT_BUCKETS,
    ):
        super().__init__(name, help, registry)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds or bounds[-1] != float("inf"):
            bounds = bounds + (float("inf"),)
        self.buckets = bounds

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        state = self._series.get(key)
        if state is None:
            state = {"counts": [0] * len(self.buckets), "sum": 0.0, "count": 0,
                     "min": value, "max": value}
            self._series[key] = state
        for i, bound in enumerate(self.buckets):
            if value <= bound:
                state["counts"][i] += 1
                break
        state["sum"] += value
        state["count"] += 1
        state["min"] = min(state["min"], value)
        state["max"] = max(state["max"], value)

    def series(self) -> Dict[str, dict]:
        # min/max are quantile-estimation internals; the exported series
        # surface (and therefore registry snapshots/digests) stays exactly
        # counts/sum/count.
        return {k: {"counts": list(v["counts"]), "sum": v["sum"], "count": v["count"]}
                for k, v in self._series.items()}

    def quantile(self, q: float, **labels) -> Optional[float]:
        """Estimate the q-quantile (q in [0, 1]) for one series.

        Rank-based with linear interpolation inside the containing bucket,
        clamped to the observed min/max — so the error is at most the width
        of that bucket, the open top bucket degrades to the observed max
        rather than infinity, and a series whose observations all share one
        value returns that value exactly. None when the series is empty.
        """
        if not (0.0 <= q <= 1.0):
            raise ValueError(f"quantile q must be in [0, 1], got {q}")
        state = self._series.get(self._key(labels))
        if state is None or state["count"] == 0:
            return None
        return self._quantile_of(state, q)

    def _quantile_of(self, state: dict, q: float) -> float:
        rank = q * state["count"]
        cum = 0
        prev = float("-inf")
        for bound, n in zip(self.buckets, state["counts"]):
            if n and cum + n >= rank:
                lo = max(prev, state["min"])
                hi = min(bound, state["max"])
                frac = min(1.0, max(0.0, (rank - cum) / n))
                return lo + (hi - lo) * frac
            cum += n
            prev = bound
        return state["max"]

    def snapshot(self) -> Dict[str, dict]:
        """Per-series summary with estimated quantiles:
        ``{count, sum, min, max, p50, p95, p99}`` (quantiles carry the
        ±bucket-width error documented on :meth:`quantile`)."""
        out: Dict[str, dict] = {}
        for key, st in self._series.items():
            out[key] = {
                "count": st["count"],
                "sum": st["sum"],
                "min": st["min"],
                "max": st["max"],
                "p50": self._quantile_of(st, 0.50),
                "p95": self._quantile_of(st, 0.95),
                "p99": self._quantile_of(st, 0.99),
            }
        return out


class MetricsRegistry:
    """Aggregation point for metric families owned by many components."""

    def __init__(self) -> None:
        self._metrics: list[_Metric] = []

    def register(self, metric: _Metric) -> _Metric:
        self._metrics.append(metric)
        return metric

    def snapshot(self) -> Dict[str, float]:
        """Flat ``{name+labels: value}`` map, summed across family instances.

        Histograms expand to ``<name>_count``, ``<name>_sum`` and cumulative
        ``<name>_bucket{le="..."}`` series. Deterministic: sorted keys, and
        summation order is registration order (ints stay ints).
        """
        out: Dict[str, float] = {}
        for m in self._metrics:
            if m.kind == "histogram":
                for key, st in m.series().items():
                    base = m.name + key
                    out[f"{base}_count"] = out.get(f"{base}_count", 0) + st["count"]
                    out[f"{base}_sum"] = out.get(f"{base}_sum", 0) + st["sum"]
                    cum = 0
                    for bound, n in zip(m.buckets, st["counts"]):
                        cum += n
                        le = "+Inf" if bound == float("inf") else repr(bound)
                        lk = f'{m.name}_bucket{{le="{le}"}}{key}'
                        out[lk] = out.get(lk, 0) + cum
            else:
                for key, v in m.series().items():
                    full = m.name + key
                    out[full] = out.get(full, 0) + v
        return {k: out[k] for k in sorted(out)}

    def value(self, name: str, **labels):
        """Sum of one series (by exact name + labels) across instances."""
        key = name + _series_key({k: str(v) for k, v in labels.items()})
        total = 0
        for m in self._metrics:
            if m.name == name and m.kind != "histogram":
                total += m.series().get(key[len(name):] or "", 0)
        return total

    def families(self) -> Dict[str, str]:
        """``{name: kind}`` for every registered family (deduped)."""
        return {m.name: m.kind for m in self._metrics}


class StatsShim:
    """Attribute-compatible stats object backed by real counters.

    Subclasses set ``_SUBSYSTEM`` and ``_FIELDS``; each field becomes a
    label-free :class:`Counter` named ``repro_<subsystem>_<field>``. Reads
    return plain numbers (ints stay ints), writes — including augmented
    assignment — route to the counter, so call sites and tests written
    against the old dataclasses keep working unchanged. Constructing one
    without a registry gives it a private registry (standalone use in unit
    tests); fleet wiring passes the shared registry so every component's
    numbers land in one snapshot.
    """

    _SUBSYSTEM = "misc"
    _FIELDS: Tuple[str, ...] = ()

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        object.__setattr__(self, "registry", registry if registry is not None else MetricsRegistry())
        counters: Dict[str, Counter] = {}
        object.__setattr__(self, "_counters", counters)
        for f in self._FIELDS:
            counters[f] = Counter(f"repro_{self._SUBSYSTEM}_{f}", registry=self.registry)

    def __getattr__(self, name: str):
        # Only reached when normal attribute lookup fails.
        counters = object.__getattribute__(self, "_counters")
        if name in counters:
            return counters[name].value
        raise AttributeError(f"{type(self).__name__} has no field {name!r}")

    def __setattr__(self, name: str, value) -> None:
        counters = self.__dict__.get("_counters")
        if counters is not None and name in counters:
            counters[name].set_total(value)
        else:
            object.__setattr__(self, name, value)

    def counter(self, name: str) -> Counter:
        return self._counters[name]

    def as_dict(self) -> Dict[str, float]:
        return {f: self._counters[f].value for f in self._FIELDS}

    def __repr__(self) -> str:  # keeps debug output close to the old dataclasses
        body = ", ".join(f"{f}={self._counters[f].value}" for f in self._FIELDS)
        return f"{type(self).__name__}({body})"

    def __eq__(self, other) -> bool:
        if isinstance(other, StatsShim):
            return self.as_dict() == other.as_dict()
        return NotImplemented
