"""Auto-scaling policy (paper §Method c): "instantiates an appropriate number
of de-identification compute instances based on the size of the message queue
... and the expected delivery window", deleting instances when the queue is
empty.

``target = clamp(ceil(backlog_bytes / (per_instance_throughput × remaining
window)), min, max)`` with hysteresis (scale-down cooldown) so lease churn
doesn't thrash the pool — the cloud-VM analogue of avoiding TPU slice
reallocation storms. Scale events drive the elastic farm re-mesh in
`repro_torch.distributed.elastic`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from repro_torch.queueing.broker import Broker
from repro_torch.utils.timing import SimClock


@dataclass
class AutoscalerConfig:
    delivery_window: float = 3600.0          # seconds to drain the request (SLA)
    per_instance_throughput: float = 160e6   # bytes/s (paper: 1.25 GB/s / 8 instances)
    min_instances: int = 0
    max_instances: int = 64
    scale_down_cooldown: float = 120.0       # hysteresis
    instance_cost_per_hour: float = 0.85     # USD, calibrated to paper Table 1


@dataclass
class ScaleEvent:
    t: float
    old: int
    new: int
    backlog_bytes: int
    reason: str


class Autoscaler:
    def __init__(self, broker: Broker, config: AutoscalerConfig, clock: Optional[SimClock] = None) -> None:
        self.broker = broker
        self.config = config
        self.clock = clock or broker.clock
        self.current = 0
        # optional burn-rate pressure signal (DESIGN.md §13): a zero-arg
        # callable returning a multiplier >= 1.0 (e.g. HealthController
        # .pressure). While > 1, the backlog-derived target is multiplied up
        # so a burning latency SLO buys capacity that queue depth alone
        # would not request. None = pure backlog scaling (the default).
        self.pressure_fn = None
        self.events: List[ScaleEvent] = []
        self._window_start: Optional[float] = None
        self._last_scale_down: float = -math.inf
        self.instance_seconds = 0.0  # integral for the cost model
        self._last_tick: Optional[float] = None
        # (tick time, pool size after the tick): the piecewise-constant record
        # the conformance suite re-integrates to audit instance_seconds
        self.tick_log: List[Tuple[float, int]] = []

    def target_for(self, backlog_bytes: int) -> int:
        cfg = self.config
        if backlog_bytes <= 0:
            return cfg.min_instances
        if self._window_start is None:
            self._window_start = self.clock.now()
        elapsed = self.clock.now() - self._window_start
        remaining = max(cfg.delivery_window - elapsed, 60.0)  # never divide by ~0
        need = math.ceil(backlog_bytes / (cfg.per_instance_throughput * remaining))
        return max(cfg.min_instances, min(cfg.max_instances, need))

    def tick(self) -> int:
        """Re-evaluate the pool size. Returns the (possibly new) instance count."""
        now = self.clock.now()
        if self._last_tick is not None:
            self.instance_seconds += self.current * (now - self._last_tick)
        self._last_tick = now

        stats = self.broker.stats()
        target = self.target_for(stats.backlog_bytes)
        reason = "scale-up"
        if stats.outstanding > 0 and self.pressure_fn is not None:
            pressure = self.pressure_fn()
            if pressure > 1.0:
                boosted = min(self.config.max_instances,
                              math.ceil(max(target, 1) * pressure))
                if boosted > target:
                    target = boosted
                    reason = "burn-scale-up"
        if stats.outstanding == 0:
            target = self.config.min_instances  # paper: delete when queue empty
            self._window_start = None
        if target > self.current:
            self.events.append(ScaleEvent(now, self.current, target, stats.backlog_bytes, reason))
            self.current = target
        elif target < self.current:
            if now - self._last_scale_down >= self.config.scale_down_cooldown or target == 0:
                self.events.append(ScaleEvent(now, self.current, target, stats.backlog_bytes, "scale-down"))
                self.current = target
                self._last_scale_down = now
        self.tick_log.append((now, self.current))
        return self.current

    def cost_usd(self) -> float:
        return self.instance_seconds / 3600.0 * self.config.instance_cost_per_hour
