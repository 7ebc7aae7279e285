"""Wall-clock timing and a deterministic simulated clock.

The broker/autoscaler/tracer layers accept any object satisfying the
:class:`Clock` protocol (``now()`` + ``advance(dt)``); tests and benchmarks use
:class:`SimClock` so queue/lease/scaling/trace behaviour is fully
deterministic, while production wiring passes :class:`WallClock`.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Protocol, runtime_checkable


@runtime_checkable
class Clock(Protocol):
    """Structural interface every clock-consuming component relies on."""

    def now(self) -> float: ...

    def advance(self, dt: float) -> float: ...


class Timer:
    """Context-manager stopwatch: ``with Timer() as t: ...; t.seconds``.

    Re-entrant: nested ``with`` blocks on the same instance each time their
    own region (a LIFO stack of start times), so an inner use never clobbers
    the outer region's start. ``seconds`` always reflects the most recently
    *exited* region. An optional ``clock`` makes the stopwatch deterministic
    under a :class:`SimClock`.
    """

    def __init__(self, clock: Clock | None = None) -> None:
        self._clock = clock
        self._starts: list[float] = []
        self.seconds = 0.0

    def _now(self) -> float:
        return self._clock.now() if self._clock is not None else time.perf_counter()

    def __enter__(self) -> "Timer":
        self._starts.append(self._now())
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = self._now() - self._starts.pop()


@dataclass
class SimClock:
    """Deterministic manually-advanced clock (seconds)."""

    t: float = 0.0
    history: list = field(default_factory=list)

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        assert dt >= 0, "time cannot go backwards"
        self.t += dt
        self.history.append(self.t)
        return self.t


class WallClock:
    """Real clock with the same interface as SimClock.

    ``now()`` reads ``time.perf_counter()``: monotonic, so a span's width is
    never negative, and the clock a device trace is tied to on the host (a
    marker kernel stamped with it). Its zero is arbitrary: it tells
    durations, not the time of day."""

    def now(self) -> float:
        return time.perf_counter()

    def advance(self, dt: float) -> float:  # pragma: no cover - real sleep
        time.sleep(dt)
        return self.now()
