"""Deterministic tracing with explicit context propagation.

Design constraints, in order:

1. **Bit-replayability.** Timestamps come from the injected clock and ids are
   derived, never random: a span id is the tracer's start-sequence counter,
   and a work-item trace id is ``trace_id_for(key, attempt)`` — a SHA-256 of
   the ticket key + delivery attempt. A seeded FleetSim run therefore
   produces a bit-identical ``digest()``, which the sim enforces as an
   invariant.
2. **Zero overhead when disabled.** ``NULL_TRACER`` is a module singleton
   whose ``span()`` returns one shared no-op context manager — no clock
   reads, no allocation beyond the call itself, no behavior change.
3. **Single-threaded context.** The whole stack is step-driven off one event
   loop, so the active-span *stack* is the context: a span opened inside
   another parents to it automatically; roots name their trace explicitly.
4. **Stage spans time host work.** ``Tracer.stage()`` opens the spans that
   split a study's host time by stage (lake, tag rules, scrub, collect,
   commit, select). They are recorded only on a clock that runs by itself:
   on a ``SimClock`` they would be zero-width and would only shift the span
   ids of a trace that is replayed, and held span for span to the
   reference's.

Spans never carry free-text values from data; attributes cross the
:mod:`repro_torch.obs.export` redactor before leaving the process.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional


def trace_id_for(key: str, attempt: int = 1) -> str:
    """Deterministic trace id for one delivery attempt of one work item."""
    return hashlib.sha256(f"trace|{key}|{attempt}".encode()).hexdigest()[:16]


@dataclass
class Span:
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    name: str
    t0: float
    t1: Optional[float] = None
    seq: int = 0
    attrs: Dict[str, object] = field(default_factory=dict)

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    @property
    def duration(self) -> float:
        return (self.t1 if self.t1 is not None else self.t0) - self.t0

    def to_dict(self) -> Dict[str, object]:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "t0": self.t0,
            "t1": self.t1,
            "seq": self.seq,
            "attrs": self.attrs,
        }


class _ActiveSpan:
    """Context manager handle for an open span."""

    __slots__ = ("_tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span) -> None:
        self._tracer = tracer
        self.span = span

    def set(self, **attrs) -> "_ActiveSpan":
        self.span.attrs.update(attrs)
        return self

    def __enter__(self) -> "_ActiveSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.span.attrs["error"] = exc_type.__name__
        self._tracer._finish(self.span)
        # exceptions propagate


class _NoopSpan:
    """Shared do-nothing handle used by :class:`NullTracer`."""

    __slots__ = ()
    span = None

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NOOP_SPAN = _NoopSpan()


def _canonical(obj):
    """Round floats (9 places) so digests survive re-serialization."""
    if isinstance(obj, float):
        return round(obj, 9)
    if isinstance(obj, dict):
        return {k: _canonical(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_canonical(v) for v in obj]
    return obj


# The executor's spans name the path that ran (``core/batch.py``): on the
# card the kernels, on the CPU the host two-pass and the numpy detector.
# Each card label beside the host label of the same work.
HOST_PATH_LABELS = {
    ("kernel.dispatch", "fused"): "host",
    ("kernel.entropy_code", "device_plan"): "host_encode",
    ("kernel.entropy_code", "device_res"): "host_encode",
    ("kernel.detect_dispatch", "textdetect"): "oracle",
    ("kernel.collect", "scrub_only"): "done",
}


def host_path_digest(spans) -> str:
    """:meth:`Tracer.digest` of ``spans`` as the host path records them:
    each executor span's ``path`` label replaced by the host path's. A run
    on the card and the same run on the CPU differ in those labels and
    nowhere else, so this digest of the one equals the other's digest."""
    h = hashlib.sha256()
    for s in spans:
        d = s.to_dict()
        label = HOST_PATH_LABELS.get((s.name, s.attrs.get("path")))
        if label is not None:
            d["attrs"] = {**s.attrs, "path": label}
        h.update(json.dumps(_canonical(d), sort_keys=True, separators=(",", ":")).encode())
        h.update(b"\n")
    return h.hexdigest()


class Tracer:
    """Clock-injected span recorder with a LIFO active-span stack.

    ``timed`` says whether :meth:`stage` records: on any clock but a
    ``SimClock`` (this package's or a twin of the same name), whose time
    moves only when the caller advances it."""

    enabled = True

    def __init__(self, clock) -> None:
        self.clock = clock
        self.timed = type(clock).__name__ != "SimClock"
        self.finished: List[Span] = []
        self._stack: List[Span] = []
        self._seq = 0

    # -- recording ---------------------------------------------------------

    def span(self, name: str, trace_id: Optional[str] = None, **attrs) -> _ActiveSpan:
        """Open a span. Parents to the innermost open span; a root span with
        no explicit ``trace_id`` gets one minted from its own sequence number
        (deterministic)."""
        self._seq += 1
        seq = self._seq
        parent = self._stack[-1] if self._stack else None
        if trace_id is None:
            trace_id = parent.trace_id if parent is not None else f"root{seq:08d}"
        span = Span(
            trace_id=trace_id,
            span_id=f"s{seq:08d}",
            parent_id=parent.span_id if parent is not None and parent.trace_id == trace_id else None,
            name=name,
            t0=self.clock.now(),
            seq=seq,
            attrs=dict(attrs),
        )
        self._stack.append(span)
        return _ActiveSpan(self, span)

    def event(self, name: str, trace_id: Optional[str] = None, **attrs) -> Span:
        """Instant (zero-duration) span, e.g. a broker publish or an ack."""
        with self.span(name, trace_id=trace_id, **attrs) as h:
            return h.span

    def stage(self, name: str, **attrs):
        """A span that times one stage of host work: :meth:`span` when the
        tracer is ``timed``, else the shared no-op handle."""
        return self.span(name, **attrs) if self.timed else _NOOP_SPAN

    def _finish(self, span: Span) -> None:
        # Tolerate out-of-order exits defensively, but the integrity checker
        # treats any still-open span at end of run as a violation.
        if self._stack and self._stack[-1] is span:
            self._stack.pop()
        elif span in self._stack:  # pragma: no cover - misuse guard
            self._stack.remove(span)
        span.t1 = self.clock.now()
        self.finished.append(span)

    # -- inspection --------------------------------------------------------

    @property
    def open_count(self) -> int:
        return len(self._stack)

    def spans(self, name: Optional[str] = None) -> List[Span]:
        if name is None:
            return list(self.finished)
        return [s for s in self.finished if s.name == name]

    def traces(self) -> Dict[str, List[Span]]:
        out: Dict[str, List[Span]] = {}
        for s in self.finished:
            out.setdefault(s.trace_id, []).append(s)
        return out

    def digest(self) -> str:
        """SHA-256 over the canonical JSONL of finished spans (finish order).

        Floats round to 9 places (same contract as the sim EventLog) so the
        digest is stable under serialization round-trips.
        """
        h = hashlib.sha256()
        for s in self.finished:
            line = json.dumps(_canonical(s.to_dict()), sort_keys=True, separators=(",", ":"))
            h.update(line.encode())
            h.update(b"\n")
        return h.hexdigest()

    def clear(self) -> None:
        self.finished.clear()
        self._stack.clear()
        self._seq = 0


class NullTracer:
    """No-op tracer: the disabled mode. Never touches the clock."""

    enabled = False
    timed = False
    clock = None

    def span(self, name: str, trace_id: Optional[str] = None, **attrs) -> _NoopSpan:
        return _NOOP_SPAN

    def stage(self, name: str, **attrs) -> _NoopSpan:
        return _NOOP_SPAN

    def event(self, name: str, trace_id: Optional[str] = None, **attrs) -> None:
        return None

    @property
    def finished(self) -> List[Span]:
        return []

    @property
    def open_count(self) -> int:
        return 0

    def spans(self, name: Optional[str] = None) -> List[Span]:
        return []

    def traces(self) -> Dict[str, List[Span]]:
        return {}

    def digest(self) -> str:
        return Tracer.digest(self)  # digest of zero spans

    def clear(self) -> None:
        pass


NULL_TRACER = NullTracer()
