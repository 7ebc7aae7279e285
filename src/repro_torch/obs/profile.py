"""Continuous critical-path profiler over the deterministic span stream.

Answers "where did this cohort's time go" without sampling: every finished
serve trace is folded into a per-stage critical path using the parent/attempt
chains the tracer already stamps (DESIGN.md §11), then aggregated into a
deterministic self-time profile keyed by (serve temperature, modality,
stage).

Stage attribution for a cold serve of one ticket, all derived from the
broker/worker span chain (the same reconstruction the ``--trace`` epilogue
of ``examples/deid_at_scale.py`` prints):

* ``retry``        — first publish → this attempt's entry (publish/redeliver)
* ``queue``        — entry → broker lease
* ``fetch``        — ``worker.fetch`` span (source read + decode)
* ``deid``         — ``worker.deid`` span: its width on a wall clock; under
                     SimClock the span is zero-width, so the modeled
                     ``busy_s`` attribute stands in
* ``entropy_code`` — ``kernel.entropy_code`` spans within the trace
* ``deliver``      — ``worker.deliver`` span
* ``writeback``    — ``worker.writeback`` span
* ``other``        — end-to-end remainder not attributed above

Warm serves have no worker chain; their admission cost is attributed to the
``admit`` stage from the ``service.submit_cohort`` span. Folding is
idempotent per span sequence number — feeding the same tracer again is a
no-op — so the profiler can run continuously at whatever cadence the fleet
reports. The profile, its folded flame export, and the Chrome-trace export
all pass through the PHI-safe :class:`~repro_torch.obs.export.Redactor`, and
:meth:`digest` is bit-stable for a given trace (the sim's ``SloConformance``
checker relies on that).
"""
from __future__ import annotations

import hashlib
import json
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.obs.export import Redactor
from repro_torch.obs.trace import Span, _canonical, trace_id_for

STAGES = (
    "retry",
    "queue",
    "fetch",
    "deid",
    "entropy_code",
    "deliver",
    "writeback",
    "admit",
    "other",
)

_CHILD_STAGES = (
    ("worker.fetch", "fetch"),
    ("worker.deid", "deid"),
    ("worker.deliver", "deliver"),
    ("worker.writeback", "writeback"),
)


class CriticalPathProfiler:
    """Folds finished spans into a (temperature, modality, stage) profile."""

    def __init__(self) -> None:
        # (temperature, modality, stage) -> [total_s, count]
        self._cells: Dict[Tuple[str, str, str], List[float]] = {}
        self._folded: set = set()  # span seqs already attributed
        self.traces_folded = 0
        self.spans_seen = 0

    # ------------------------------------------------------------------ fold
    def fold(self, spans: Iterable[Span]) -> int:
        """Attribute every not-yet-folded completed serve; returns how many
        new traces were folded this call."""
        spans = sorted(spans, key=lambda s: s.seq)
        self.spans_seen = max(self.spans_seen, len(spans))
        # a superseded key is re-published under the same (key, attempt)
        # trace ids, so every per-trace index is a seq-ordered LIST and each
        # ack reads only the window belonging to its own generation — the
        # one opened by the latest attempt-1 publish preceding the ack
        publishes: Dict[str, List[Span]] = {}
        entries: Dict[str, List[Span]] = {}  # publish-or-redeliver per attempt
        leases: Dict[str, List[Span]] = {}
        procs: Dict[str, List[Span]] = {}
        children: Dict[str, List[Span]] = {}
        entropy: Dict[str, List[Span]] = {}
        for s in spans:
            if s.name == "broker.publish":
                publishes.setdefault(s.trace_id, []).append(s)
                entries.setdefault(s.trace_id, []).append(s)
            elif s.name == "broker.redeliver":
                entries.setdefault(s.trace_id, []).append(s)
            elif s.name == "broker.lease":
                leases.setdefault(s.trace_id, []).append(s)
            elif s.name == "worker.process":
                procs.setdefault(s.trace_id, []).append(s)
            elif s.name == "kernel.entropy_code":
                entropy.setdefault(s.trace_id, []).append(s)
            if s.parent_id is not None:
                children.setdefault(s.parent_id, []).append(s)

        new_traces = 0
        for s in spans:
            if s.name == "broker.ack" or s.name == "service.submit_cohort":
                if s.seq in self._folded:
                    continue
                self._folded.add(s.seq)
                if s.name == "broker.ack":
                    if self._fold_cold(s, publishes, entries, leases, procs,
                                       children, entropy):
                        new_traces += 1
                else:
                    self._add("warm", "NA", "admit", s.duration)
                    new_traces += 1
        self.traces_folded += new_traces
        return new_traces

    @staticmethod
    def _in_window(group, lo: int, hi: int, last: bool = False):
        """First (or last) span in a seq-ordered group with lo <= seq <= hi."""
        picked = None
        for s in group or ():
            if s.seq > hi:
                break
            if s.seq >= lo:
                if not last:
                    return s
                picked = s
        return picked

    def _fold_cold(self, ack, publishes, entries, leases, procs, children,
                   entropy) -> bool:
        # this serve's generation: the latest attempt-1 publish before the ack
        first = self._in_window(
            publishes.get(trace_id_for(ack.attrs["key"], 1)),
            0, ack.seq, last=True,
        )
        if first is None:
            return False
        proc = self._in_window(procs.get(ack.trace_id), first.seq, ack.seq,
                               last=True)
        if proc is None or not proc.attrs.get("ok"):
            return False  # dedup ack / fence — no serve completed here
        entry = self._in_window(entries.get(ack.trace_id), first.seq, ack.seq)
        lease = self._in_window(leases.get(ack.trace_id), first.seq, ack.seq)
        if entry is None or lease is None:
            return False
        modality = "NA"
        stage_s: Dict[str, float] = {}
        stage_s["retry"] = max(0.0, entry.t0 - first.t0)
        stage_s["queue"] = max(0.0, lease.t0 - entry.t0)
        for child in children.get(proc.span_id, ()):
            for name, stage in _CHILD_STAGES:
                if child.name == name:
                    # a span with width was timed on a wall clock: its width
                    # is the measurement. Under SimClock child spans are
                    # zero-width and the modeled busy time lives in attrs
                    secs = child.duration
                    if secs <= 0:
                        secs = float(child.attrs.get("busy_s", 0.0) or 0.0)
                    stage_s[stage] = stage_s.get(stage, 0.0) + secs
                    if child.name == "worker.fetch":
                        modality = str(child.attrs.get("modality") or "NA")
        for ks in entropy.get(ack.trace_id, ()):
            if first.seq <= ks.seq <= ack.seq:
                stage_s["entropy_code"] = (
                    stage_s.get("entropy_code", 0.0) + ks.duration
                )
        e2e = ack.t1 - first.t0
        stage_s["other"] = max(0.0, e2e - sum(stage_s.values()))
        for stage, secs in stage_s.items():
            self._add("cold", modality, stage, secs)
        return True

    def _add(self, temperature: str, modality: str, stage: str, secs: float) -> None:
        cell = self._cells.setdefault((temperature, modality, stage), [0.0, 0])
        cell[0] += secs
        cell[1] += 1

    # ------------------------------------------------------------- reporting
    def profile(self) -> Dict[str, Dict[str, Dict[str, Dict[str, float]]]]:
        """temperature -> modality -> stage -> {total_s, count, frac}.

        ``frac`` is the stage's share of that (temperature, modality)'s total
        attributed time — the flame-graph width."""
        out: Dict[str, Dict[str, Dict[str, Dict[str, float]]]] = {}
        totals: Dict[Tuple[str, str], float] = {}
        for (temp, modality, _stage), (secs, _n) in self._cells.items():
            totals[(temp, modality)] = totals.get((temp, modality), 0.0) + secs
        for (temp, modality, stage), (secs, n) in sorted(self._cells.items()):
            denom = totals[(temp, modality)]
            out.setdefault(temp, {}).setdefault(modality, {})[stage] = {
                "total_s": round(secs, 9),
                "count": n,
                "frac": round(secs / denom, 9) if denom > 0 else 0.0,
            }
        return out

    def top_stages(self, n: int = 3) -> List[Tuple[str, float]]:
        """Stages by total attributed self-time, descending — the "top
        regressing stages" line of a HealthReport."""
        agg: Dict[str, float] = {}
        for (_t, _m, stage), (secs, _n) in self._cells.items():
            agg[stage] = agg.get(stage, 0.0) + secs
        ranked = sorted(agg.items(), key=lambda kv: (-kv[1], kv[0]))
        return [(stage, round(secs, 9)) for stage, secs in ranked[:n]]

    def digest(self) -> str:
        """SHA-256 of the canonical profile — bit-stable for a given trace."""
        payload = {"traces": self.traces_folded, "profile": self.profile()}
        line = json.dumps(_canonical(payload), sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(line.encode()).hexdigest()

    # --------------------------------------------------------------- exports
    def export_folded(self, redactor: Optional[Redactor] = None) -> str:
        """Flame-graph "folded" format: ``temp;modality;stage <microseconds>``
        per line. All frame names cross the redactor's value policy."""
        red = redactor if redactor is not None else Redactor()
        lines = []
        for (temp, modality, stage), (secs, _n) in sorted(self._cells.items()):
            frames = ";".join(
                str(red.safe_value(part)) for part in (temp, modality, stage)
            )
            lines.append(f"{frames} {int(round(secs * 1e6))}")
        return "\n".join(lines) + ("\n" if lines else "")

    def to_chrome_trace(self, redactor: Optional[Redactor] = None) -> Dict[str, object]:
        """Aggregate profile as a Chrome trace: one track per (temperature,
        modality), stages laid end-to-end by attributed time. Reuses the
        PHI-safe span exporter rather than emitting attrs directly."""
        from repro_torch.obs.export import to_chrome_trace

        red = redactor if redactor is not None else Redactor()
        synth: List[Span] = []
        seq = 0
        for (temp, modality), group in self._by_track().items():
            # the track label flows into the trace's ``cat`` field, which the
            # span exporter does not re-validate — sanitize it here
            track = red.safe_value(modality)
            cursor = 0.0
            for stage, secs, n in group:
                seq += 1
                synth.append(Span(
                    trace_id=f"profile-{temp}-{track}",
                    span_id=f"p{seq:08d}",
                    parent_id=None,
                    name=f"profile.{stage}",
                    t0=cursor,
                    t1=cursor + secs,
                    seq=seq,
                    attrs={"stage": stage, "modality": modality,
                           "mode": temp, "n": n},
                ))
                cursor += secs
        return to_chrome_trace(synth, red)

    def _by_track(self) -> Dict[Tuple[str, str], List[Tuple[str, float, int]]]:
        out: Dict[Tuple[str, str], List[Tuple[str, float, int]]] = {}
        for (temp, modality, stage), (secs, n) in sorted(self._cells.items()):
            out.setdefault((temp, modality), []).append((stage, secs, n))
        return out
