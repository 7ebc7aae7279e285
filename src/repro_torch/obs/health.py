"""Health controller loop: SLO state → operator snapshot + autoscaler signal.

Closes the observability loop (DESIGN.md §13). Two outputs:

* :meth:`HealthController.snapshot` — a :class:`HealthReport` of SLO states,
  burn rates, remaining error budgets, active alerts, and the top regressing
  pipeline stages from the critical-path profiler. Surfaced to operators via
  ``DeidService.health_report()``.
* :meth:`HealthController.pressure` — a deterministic scale-up multiplier
  (≥ 1.0) derived from *active latency-SLO alerts only*: each burning
  (slo, rule) pair whose spec kind is "latency" adds ``boost_per_alert``,
  capped at ``max_pressure``. The autoscaler multiplies its backlog-derived
  target by this, so a burning latency SLO buys instances the backlog math
  alone would not — recovery from a straggler storm provably shortens
  (the sim's burn→autoscaler scenario asserts it, with an off-switch
  negative control).

The controller holds no clock and no mutable state of its own: pressure and
snapshots are pure functions of the engine/profiler at call time, so the
closed loop stays bit-replayable from one seed.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.profile import CriticalPathProfiler
from repro_torch.obs.slo import SloEngine


@dataclass
class HealthReport:
    """One point-in-time health snapshot; ``to_dict()`` is print-ready."""

    t: float
    states: Dict[str, str] = field(default_factory=dict)
    burn: Dict[str, float] = field(default_factory=dict)
    budget_remaining: Dict[str, float] = field(default_factory=dict)
    active_alerts: List[str] = field(default_factory=list)
    top_stages: List[Tuple[str, float]] = field(default_factory=list)

    @property
    def burning(self) -> List[str]:
        return [name for name, st in self.states.items() if st == "burning"]

    def to_dict(self) -> Dict[str, object]:
        return {
            "t": round(self.t, 9),
            "states": dict(self.states),
            "burn": {k: round(v, 6) for k, v in self.burn.items()},
            "budget_remaining": {
                k: round(v, 6) for k, v in self.budget_remaining.items()
            },
            "active_alerts": list(self.active_alerts),
            "top_stages": [[s, round(v, 6)] for s, v in self.top_stages],
        }

    def summary(self) -> str:
        burning = self.burning
        head = (
            f"{len(burning)}/{len(self.states)} SLOs burning"
            if self.states else "no SLOs registered"
        )
        if burning:
            head += f" ({', '.join(sorted(burning))})"
        if self.top_stages:
            stage, secs = self.top_stages[0]
            head += f"; top stage {stage} ({secs:.1f}s)"
        return head


class HealthController:
    """Pure-function bridge from SLO engine (+ profiler) to consumers."""

    def __init__(
        self,
        engine: SloEngine,
        profiler: Optional[CriticalPathProfiler] = None,
        boost_per_alert: float = 1.0,
        max_pressure: float = 4.0,
    ) -> None:
        self.engine = engine
        self.profiler = profiler
        self.boost_per_alert = boost_per_alert
        self.max_pressure = max_pressure

    def pressure(self) -> float:
        """Scale-up multiplier from active latency-SLO alerts; 1.0 when
        nothing latency-shaped is burning."""
        n = sum(
            1
            for slo, _rule in self.engine.active_alerts()
            if self.engine.specs[slo].kind == "latency"
        )
        return min(self.max_pressure, 1.0 + self.boost_per_alert * n)

    def snapshot(self, t: float) -> HealthReport:
        eng = self.engine
        burn = {}
        for name, spec in eng.specs.items():
            # report the fastest rule's long-window burn — the paging signal
            rule = spec.rules[0]
            burn[name] = eng.burn_rate(name, rule.long_window, t)
        return HealthReport(
            t=t,
            states=eng.states(),
            burn=burn,
            budget_remaining={
                name: eng.budget_remaining(name, t) for name in eng.specs
            },
            active_alerts=[f"{slo}#{rule}" for slo, rule in eng.active_alerts()],
            top_stages=self.profiler.top_stages(3) if self.profiler else [],
        )
