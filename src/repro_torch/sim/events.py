"""Discrete-event machinery for the fleet simulator (DESIGN.md §7).

Two pieces, both deliberately tiny and fully deterministic:

* :class:`EventQueue` — a (time, seq)-ordered heap of :class:`Event`\\ s.
  ``seq`` is a monotone tiebreaker so two events scheduled for the same
  sim-time always pop in scheduling order, which is what makes a whole run
  replayable from one seed: the heap never consults identity or hash order.
* :class:`EventLog` — the append-only record of everything the simulator
  did. Two runs of the same scenario are *defined* equal when their logs are
  byte-identical (:meth:`EventLog.digest`), which is the bit-replayability
  contract the conformance suite enforces.

There is intentionally no wall-clock anywhere in this module; sim-time comes
from the shared :class:`repro_torch.utils.timing.SimClock` the whole stack already
runs on.
"""
from __future__ import annotations

import hashlib
import heapq
import itertools
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple


@dataclass(frozen=True, order=True)
class Event:
    t: float
    seq: int
    kind: str = field(compare=False)
    payload: Dict[str, Any] = field(compare=False, default_factory=dict)


class EventQueue:
    """Min-heap of events keyed by (sim-time, scheduling order)."""

    def __init__(self) -> None:
        self._heap: List[Event] = []
        self._seq = itertools.count()

    def push(self, t: float, kind: str, **payload: Any) -> Event:
        ev = Event(t=float(t), seq=next(self._seq), kind=kind, payload=payload)
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> Event:
        return heapq.heappop(self._heap)

    def peek_time(self) -> Optional[float]:
        return self._heap[0].t if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


def _canonical(v: Any) -> Any:
    """Make a payload JSON-stable: tuples -> lists, floats rounded so the log
    digest never depends on platform float-repr noise."""
    if isinstance(v, float):
        return round(v, 9)
    if isinstance(v, (list, tuple)):
        return [_canonical(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _canonical(x) for k, x in sorted(v.items())}
    return v


class EventLog:
    """Append-only structured log; the replayability unit of account."""

    def __init__(self) -> None:
        self.records: List[Dict[str, Any]] = []

    def append(self, t: float, kind: str, **detail: Any) -> None:
        rec = {"t": round(float(t), 9), "kind": kind}
        rec.update({k: _canonical(v) for k, v in detail.items()})
        self.records.append(rec)

    def to_jsonl(self, exclude_kinds: Tuple[str, ...] = ()) -> str:
        recs = self.records
        if exclude_kinds:
            recs = [r for r in recs if r["kind"] not in exclude_kinds]
        return "\n".join(json.dumps(r, sort_keys=True) for r in recs)

    def digest(self, exclude_kinds: Tuple[str, ...] = ()) -> str:
        """SHA-256 over the canonical JSONL serialization. Two runs with the
        same seed must produce the same digest — the conformance suite's
        bit-replayability check compares exactly this. ``exclude_kinds``
        filters record kinds out first, for comparisons across configs that
        only differ by a known-additive record stream (e.g. ``slo_alert``)."""
        return hashlib.sha256(self.to_jsonl(exclude_kinds).encode()).hexdigest()

    def by_kind(self, kind: str) -> List[Dict[str, Any]]:
        return [r for r in self.records if r["kind"] == kind]

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return iter(self.records)

    def __len__(self) -> int:
        return len(self.records)


class HashRng:
    """Stateless, order-independent randomness: every draw is a pure function
    of (seed, *parts). The same trick as `FailureInjector` — schedules built
    from it are reproducible regardless of Python hash randomization or call
    ordering, and composable (two models with different namespaces never
    correlate)."""

    def __init__(self, seed: int, namespace: str = "") -> None:
        self.seed = seed
        self.namespace = namespace

    def u(self, *parts: object) -> float:
        """Uniform in [0, 1)."""
        blob = "|".join(map(str, (self.seed, self.namespace) + parts)).encode()
        h = hashlib.sha256(blob).digest()
        return int.from_bytes(h[:8], "big") / 2**64

    def randint(self, lo: int, hi: int, *parts: object) -> int:
        """Integer in [lo, hi] inclusive."""
        return lo + int(self.u(*parts) * (hi - lo + 1))

    def choice(self, seq: List, *parts: object):
        return seq[self.randint(0, len(seq) - 1, "choice", *parts)]

    def sample(self, seq: List, k: int, *parts: object) -> List:
        """k distinct elements, order-deterministic (sort by per-element u)."""
        keyed = sorted(seq, key=lambda x: self.u("sample", x, *parts))
        return keyed[: min(k, len(seq))]

    def exp(self, mean: float, *parts: object) -> float:
        """Exponential inter-arrival draw (clamped away from u=0)."""
        import math

        u = max(self.u(*parts), 1e-12)
        return -mean * math.log(u)
