"""Streaming SLO engine with multi-window burn-rate alerting (DESIGN.md §13).

The observability plane's first *consumer*: tracing and metrics record everything, this
module decides whether the fleet is keeping its promises. Declarative
:class:`SloSpec` objectives (cold-serve latency per modality, warm-hit
latency, cohort end-to-end, ingest freshness, DLQ rate) are evaluated
incrementally from the same event stream the trace/metric layers see, using
the standard SRE multi-window multi-burn-rate scheme:

* a **burn rate** is the bad-event fraction over a window divided by the
  budgeted bad fraction ``1 - objective`` — burn 1.0 consumes the error
  budget exactly at the sustainable rate, burn N consumes it N× too fast;
* an alert **fires** only when BOTH the long and the short window of a
  :class:`BurnRule` exceed the rule's threshold (the long window gives
  confidence, the short window makes the alert resolve quickly once the
  regression stops), and **resolves** when the short window recovers;
* the canonical production windows are the fast 5m/1h pair and the slow
  6h/3d pair (:func:`default_burn_rules`); simulated fleets pass a
  ``scale`` so the same shape fits a ~600 s horizon.

Determinism contract (same as the tracer): the engine owns no clock — every
``observe``/``evaluate`` call carries its timestamp — so the full alert
sequence is a pure function of (specs, observation log, evaluation times).
:meth:`SloEngine.replay` rebuilds a fresh engine from those inputs and must
reproduce the alert list bit-for-bit; the sim's ``SloConformance`` checker
enforces exactly that, plus a cross-check of cold-serve observations against
latencies re-derived from the span stream (:func:`derive_serve_observations`)
— every alert is recomputable from the trace.
"""
from __future__ import annotations

import hashlib
import json
from bisect import bisect_right
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.obs.trace import Span, _canonical, trace_id_for


@dataclass(frozen=True)
class BurnRule:
    """One multi-window burn-rate alerting rule.

    Fires when the burn rate over BOTH ``long_window`` and ``short_window``
    is >= ``threshold``; resolves when the short window drops back under.
    """

    long_window: float
    short_window: float
    threshold: float
    severity: str = "page"

    def __post_init__(self) -> None:
        if self.short_window > self.long_window:
            raise ValueError(
                f"short window {self.short_window} > long window {self.long_window}"
            )
        if self.threshold <= 0:
            raise ValueError(f"burn threshold must be > 0, got {self.threshold}")


def default_burn_rules(scale: float = 1.0) -> Tuple[BurnRule, ...]:
    """The SRE fast (5m/1h, page) + slow (6h/3d, ticket) window pairs.

    ``scale`` shrinks every window by the same factor so a simulated fleet
    with a ~600 s horizon alerts with the same *shape* a production fleet
    would over days (the sim default is 1/60: 1 h becomes 60 s).
    """
    return (
        BurnRule(3600.0 * scale, 300.0 * scale, 6.0, "page"),
        BurnRule(259200.0 * scale, 21600.0 * scale, 2.0, "ticket"),
    )


@dataclass(frozen=True)
class SloSpec:
    """A declarative service-level objective.

    ``objective`` is the required good-event fraction. ``threshold`` turns a
    value observation into good/bad (``value <= threshold`` is good); counts
    observed via :meth:`SloEngine.observe_counts` skip it. ``kind`` routes
    health-controller policy ("latency" SLOs feed the autoscaler's burn
    pressure signal); ``budget_window`` is the error-budget accounting
    horizon reported by :meth:`SloEngine.budget_remaining`.
    """

    name: str
    objective: float = 0.99
    threshold: Optional[float] = None
    unit: str = "s"
    kind: str = "latency"
    rules: Tuple[BurnRule, ...] = field(default_factory=default_burn_rules)
    budget_window: float = 86400.0

    def __post_init__(self) -> None:
        if not (0.0 < self.objective < 1.0):
            raise ValueError(f"objective must be in (0, 1), got {self.objective}")
        if not self.rules:
            raise ValueError(f"SLO {self.name!r} has no burn rules")


@dataclass(frozen=True)
class AlertEvent:
    """One deterministic fire/resolve transition of one (SLO, rule) pair."""

    t: float
    slo: str
    rule: int          # index into the spec's rules tuple
    action: str        # "fire" | "resolve"
    severity: str
    burn_long: float
    burn_short: float

    def to_dict(self) -> Dict[str, object]:
        return {
            "t": self.t,
            "slo": self.slo,
            "rule": self.rule,
            "action": self.action,
            "severity": self.severity,
            "burn_long": self.burn_long,
            "burn_short": self.burn_short,
        }


class _SloSeries:
    """Per-SLO observation stream with O(1)-amortized window sums: parallel
    time/prefix arrays (observation times are required non-decreasing, which
    every clock-driven caller satisfies by construction)."""

    __slots__ = ("times", "cum_bad", "cum_total")

    def __init__(self) -> None:
        self.times: List[float] = []
        self.cum_bad: List[int] = [0]
        self.cum_total: List[int] = [0]

    def add(self, t: float, bad: int, total: int) -> None:
        if self.times and t < self.times[-1]:
            raise ValueError(
                f"observation at t={t} before the previous one at {self.times[-1]}"
            )
        self.times.append(t)
        self.cum_bad.append(self.cum_bad[-1] + bad)
        self.cum_total.append(self.cum_total[-1] + total)

    def window(self, t: float, w: float) -> Tuple[int, int]:
        """(bad, total) over observations with time in (t - w, t]."""
        lo = bisect_right(self.times, t - w)
        hi = bisect_right(self.times, t)
        return (
            self.cum_bad[hi] - self.cum_bad[lo],
            self.cum_total[hi] - self.cum_total[lo],
        )


class SloEngine:
    """Incremental SLO evaluator; every output replays from its own log.

    Feed it with :meth:`observe` (one value or good/bad event) or
    :meth:`observe_counts` (batched good/bad deltas, e.g. DLQ vs ack counts
    per tick), then call :meth:`evaluate` at whatever cadence the fleet
    ticks; newly emitted :class:`AlertEvent`\\ s are returned AND retained in
    :attr:`alerts`. The engine is clockless and allocation-light — the hot
    path is two list appends and a counter increment.
    """

    def __init__(self, specs: Iterable[SloSpec] = (), registry=None) -> None:
        self.specs: Dict[str, SloSpec] = {}
        self._series: Dict[str, _SloSeries] = {}
        # replay inputs: everything alerts are a function of
        self.obs_log: List[Dict[str, object]] = []
        self.eval_log: List[float] = []
        self.alerts: List[AlertEvent] = []
        self._active: Dict[Tuple[str, int], bool] = {}
        self._metrics = None
        if registry is not None:
            from repro_torch.obs.metrics import Counter

            self._metrics = {
                "observations": Counter("repro_slo_observations", registry=registry),
                "alerts_fired": Counter("repro_slo_alerts_fired", registry=registry),
                "alerts_resolved": Counter(
                    "repro_slo_alerts_resolved", registry=registry
                ),
            }
        for spec in specs:
            self.ensure(spec)

    # ------------------------------------------------------------------ specs
    def ensure(self, spec: SloSpec) -> SloSpec:
        """Idempotently register a spec (dynamic per-modality objectives are
        minted from a template on first observation). First registration
        wins; the insertion order is part of the deterministic contract."""
        if spec.name not in self.specs:
            self.specs[spec.name] = spec
            self._series[spec.name] = _SloSeries()
        return self.specs[spec.name]

    # ----------------------------------------------------------- observations
    def observe(
        self,
        name: str,
        t: float,
        value: Optional[float] = None,
        good: Optional[bool] = None,
    ) -> bool:
        """Record one event; returns whether it counted as good. Either pass
        ``value`` (judged against the spec's threshold) or ``good``."""
        spec = self.specs[name]
        if good is None:
            if value is None:
                raise ValueError(f"observe({name!r}) needs value= or good=")
            good = spec.threshold is None or value <= spec.threshold
        self._ingest(name, t, value, 0 if good else 1, 1)
        return bool(good)

    def observe_counts(self, name: str, t: float, good: int = 0, bad: int = 0) -> None:
        """Record a batch of pre-judged events (e.g. per-tick ack/DLQ deltas)."""
        if name not in self.specs:
            raise KeyError(f"unknown SLO {name!r}")
        if good < 0 or bad < 0:
            raise ValueError(f"negative counts good={good} bad={bad}")
        if good + bad == 0:
            return
        self._ingest(name, t, None, bad, good + bad)

    def _ingest(
        self, name: str, t: float, value: Optional[float], bad: int, total: int
    ) -> None:
        self._series[name].add(t, bad, total)
        self.obs_log.append(
            {"t": t, "slo": name, "value": value, "bad": bad, "total": total}
        )
        if self._metrics is not None:
            self._metrics["observations"].inc(total)

    # ------------------------------------------------------------- evaluation
    def burn_rate(self, name: str, window: float, t: float) -> float:
        """Bad fraction over the window divided by the budgeted bad fraction
        (``1 - objective``); 0.0 when the window holds no observations."""
        spec = self.specs[name]
        bad, total = self._series[name].window(t, window)
        if total == 0:
            return 0.0
        return (bad / total) / (1.0 - spec.objective)

    def evaluate(self, t: float) -> List[AlertEvent]:
        """Run the fire/resolve state machine for every (spec, rule) pair at
        time ``t``; returns (and records) the newly emitted transitions."""
        self.eval_log.append(t)
        new: List[AlertEvent] = []
        for name, spec in self.specs.items():
            for ri, rule in enumerate(spec.rules):
                burn_long = self.burn_rate(name, rule.long_window, t)
                burn_short = self.burn_rate(name, rule.short_window, t)
                key = (name, ri)
                active = self._active.get(key, False)
                if not active and burn_long >= rule.threshold and burn_short >= rule.threshold:
                    self._active[key] = True
                    new.append(AlertEvent(
                        t, name, ri, "fire", rule.severity, burn_long, burn_short
                    ))
                elif active and burn_short < rule.threshold:
                    self._active[key] = False
                    new.append(AlertEvent(
                        t, name, ri, "resolve", rule.severity, burn_long, burn_short
                    ))
        self.alerts.extend(new)
        if self._metrics is not None:
            for ev in new:
                which = "alerts_fired" if ev.action == "fire" else "alerts_resolved"
                self._metrics[which].inc()
        return new

    # -------------------------------------------------------------- reporting
    def active_alerts(self) -> List[Tuple[str, int]]:
        return sorted(k for k, v in self._active.items() if v)

    def state(self, name: str) -> str:
        return "burning" if any(s == name for s, _ in self.active_alerts()) else "ok"

    def states(self) -> Dict[str, str]:
        return {name: self.state(name) for name in self.specs}

    def budget_remaining(self, name: str, t: float) -> float:
        """Fraction of the error budget left over the spec's budget window:
        1.0 = untouched, 0.0 = exhausted, negative = overdrawn. A window with
        no traffic has a full budget."""
        spec = self.specs[name]
        bad, total = self._series[name].window(t, spec.budget_window)
        if total == 0:
            return 1.0
        allowed = total * (1.0 - spec.objective)
        return 1.0 - bad / allowed

    def digest(self) -> str:
        """SHA-256 over the canonical JSONL of the alert sequence (same float
        rounding contract as the tracer/EventLog digests)."""
        h = hashlib.sha256()
        for a in self.alerts:
            line = json.dumps(
                _canonical(a.to_dict()), sort_keys=True, separators=(",", ":")
            )
            h.update(line.encode())
            h.update(b"\n")
        return h.hexdigest()

    # ----------------------------------------------------------------- replay
    def replay(self) -> "SloEngine":
        """Rebuild a fresh engine from this engine's own recorded inputs.

        The returned engine's :attr:`alerts` must equal this one's — the
        SloConformance invariant. Any tampering with the alert list (or any
        hidden state the alerts secretly depended on) breaks the equality.
        """
        fresh = SloEngine(self.specs.values())
        events = (
            [("obs", rec["t"], rec) for rec in self.obs_log]
            + [("eval", t, None) for t in self.eval_log]
        )
        # interleave by time; same-time observations land before the same-time
        # evaluation, matching the live call order (observe happens first in
        # every tick handler), with the original per-stream order preserved
        events.sort(key=lambda e: (e[1], 0 if e[0] == "obs" else 1))
        for kind, t, rec in events:
            if kind == "obs":
                fresh._ingest(rec["slo"], t, rec["value"], rec["bad"], rec["total"])
            else:
                fresh.evaluate(t)
        return fresh


def derive_serve_observations(spans: Iterable[Span]) -> List[Tuple[float, str, float]]:
    """Re-derive every cold-serve latency from the span stream alone.

    For each acked delivery whose ``worker.process`` span completed with
    ``ok`` (a journaled completion, not a dedup/fence/zombie), the end-to-end
    latency is ``ack.t1 - first_publish.t0`` — the same quantity the fleet
    observes live from ``Message.publish_time`` (which survives redelivery
    and speculative cloning). Returns ``(t, key, latency)`` sorted by the
    ack's span sequence, so the list is bit-stable for a given trace.

    This is the SloConformance cross-check: the SLO engine's cold-serve
    observation stream must equal this reconstruction exactly, which makes
    every latency alert recomputable from the trace.
    """
    spans = list(spans)
    publishes: Dict[str, List[Span]] = {}
    procs: Dict[str, Span] = {}
    for s in spans:
        if s.name == "broker.publish":
            publishes.setdefault(s.trace_id, []).append(s)
        elif s.name == "worker.process":
            procs[s.trace_id] = s
    for group in publishes.values():
        group.sort(key=lambda s: s.seq)
    out: List[Tuple[int, float, str, float]] = []
    for s in spans:
        if s.name != "broker.ack":
            continue
        proc = procs.get(s.trace_id)
        if proc is None or not proc.attrs.get("ok"):
            continue  # dedup ack, fence, or zombie-raced clone
        # a superseded key is re-published under the same (key, attempt 1)
        # trace id — each serve starts at the LATEST publish preceding its
        # ack, which is exactly the Message.publish_time the fleet sees live
        group = publishes.get(trace_id_for(s.attrs["key"], 1))
        if not group:
            continue
        first = None
        for pub in group:
            if pub.seq > s.seq:
                break
            first = pub
        if first is None:
            continue
        out.append((s.seq, s.t1, s.attrs["key"], s.t1 - first.t0))
    out.sort()
    return [(t, key, latency) for _, t, key, latency in out]
