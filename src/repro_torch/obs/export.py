"""PHI-safe telemetry export: allowlist redaction, JSONL, Chrome trace.

The redaction contract (DESIGN.md §11): telemetry leaves the process only
through these exporters, and every span attribute and metric label crosses
:class:`Redactor` first. The redactor is *allowlist-only* on two axes:

- **Keys**: only keys in ``ALLOWED_ATTR_KEYS`` survive; everything else is
  dropped outright (key and value). All allowed keys are code-controlled
  literals — no call site derives an attribute key from data.
- **Values**: numbers/bools/None pass. Strings pass only when they match the
  identifier charset ``[A-Za-z0-9_./:#@\\-]`` at ≤64 chars. The charset
  deliberately excludes ``^`` and whitespace, so DICOM person names
  (``DOE^JOHN``) and any free text are blocked even if they reach an
  allowlisted key. Blocked values become ``"[redacted]"``.

Span/metric *names* and ids are code-controlled and pass as-is. Everything
here is pure-function over the inputs — exporting never mutates the tracer
or registry, so exporting cannot perturb a deterministic run.
"""
from __future__ import annotations

import json
import re
from typing import Dict, Iterable, List, Optional

from repro_torch.obs.trace import Span, _canonical

# Every attribute key any instrumentation site is allowed to emit. Adding a
# key is a reviewed change to this file, which is the point.
ALLOWED_ATTR_KEYS = frozenset({
    # identity / linkage
    "key", "accession", "cohort_id", "trace_link", "seq", "attempt",
    "deliveries", "msg_id", "worker", "kind", "stage", "error",
    # sizes and counts
    "n", "nbytes", "bytes_in", "bytes_out", "instances", "datasets",
    "rects", "bands", "dispatches", "batch", "rows", "matched",
    "blocks_scanned", "blocks_pruned", "handed", "applied", "deletes",
    "duplicates", "polls", "floor", "backlog",
    # planner partition
    "cold", "warm", "in_flight", "coalesced", "rejected", "lake_hits",
    "journal_hits", "stale_refreshes", "published",
    # kernel dispatch facts
    "shape", "dtype", "bucket", "path", "interpret", "padded",
    # timing facts
    "busy_s", "t_lease", "visibility",
    # device/host pipeline boundary timing (DESIGN.md §12)
    "queue_s", "wait_s",
    # outcome flags
    "ok", "deduped", "fenced", "crashed", "mode",
    # SLO / critical-path profile plane (DESIGN.md §13)
    "modality", "slo", "rule", "action", "severity", "burn_long", "burn_short",
    # audit / provenance plane (DESIGN.md §14). These mirror the ledger's
    # payload fields: lineage handles are digests/ids (hex, charset-safe),
    # never free text, but they still cross the value rule like everything.
    "project", "etag", "lake_key", "ruleset", "detector_sha", "kernel_path",
    "batched", "trace_id", "temp", "reason", "device", "registry_hit",
    "detected", "op", "outcome", "channel", "records", "accessions", "journal",
    "feed_seq",
    "rulesets", "first_t", "last_t", "deid_executions", "lake_writes",
    "lake_evictions", "lake_bytes_in", "lake_bytes_out", "dead_lettered",
    "ledger_records", "ledger_digest",
})

_SAFE_VALUE_RE = re.compile(r"^[A-Za-z0-9_./:#@\-]{1,64}$")

REDACTED = "[redacted]"


class Redactor:
    """Allowlist attribute filter. ``enabled=False`` passes everything
    through — that mode exists solely so the ``TelemetryPhiBoundary``
    negative control can prove the checker is live."""

    def __init__(self, enabled: bool = True, allowed_keys: Optional[frozenset] = None) -> None:
        self.enabled = enabled
        self.allowed_keys = ALLOWED_ATTR_KEYS if allowed_keys is None else allowed_keys

    def safe_value(self, value) -> object:
        if value is None or isinstance(value, (bool, int, float)):
            return value
        if isinstance(value, str):
            return value if _SAFE_VALUE_RE.match(value) else REDACTED
        if isinstance(value, (list, tuple)):
            return [self.safe_value(v) for v in value]
        return REDACTED

    def attrs(self, attrs: Dict[str, object]) -> Dict[str, object]:
        if not self.enabled:
            return dict(attrs)
        return {k: self.safe_value(v) for k, v in attrs.items() if k in self.allowed_keys}


def _audit_export(ledger, channel: str, records: int) -> None:
    """Telemetry leaving the system boundary is itself a PHI-relevant action:
    record it in the audit ledger when the caller passes one (DESIGN.md §14).
    ``ledger=None`` keeps exporters pure functions, as before."""
    if ledger is not None and getattr(ledger, "enabled", False):
        ledger.append("telemetry_export", channel=channel, records=records)


def export_spans_jsonl(spans: Iterable[Span], redactor: Redactor, ledger=None) -> str:
    """One canonical JSON object per line, attrs redacted. '' if no spans."""
    lines: List[str] = []
    for s in spans:
        d = s.to_dict()
        d["attrs"] = redactor.attrs(d["attrs"])
        lines.append(json.dumps(_canonical(d), sort_keys=True, separators=(",", ":")))
    _audit_export(ledger, "spans_jsonl", len(lines))
    return "\n".join(lines) + ("\n" if lines else "")


def export_metrics_jsonl(snapshot: Dict[str, float], redactor: Redactor, ledger=None) -> str:
    """Flat registry snapshot as JSONL; label *values* are redacted too.

    Series keys look like ``repro_lake_hits{modality="CT"}``; the name part
    is code-controlled, but label values may echo data, so each one crosses
    the redactor's value rule.
    """
    lines: List[str] = []
    for key in sorted(snapshot):
        name, labels = _split_series_key(key)
        safe_labels = {k: (redactor.safe_value(v) if redactor.enabled else v)
                       for k, v in labels.items()}
        lines.append(json.dumps(
            _canonical({"metric": name, "labels": safe_labels, "value": snapshot[key]}),
            sort_keys=True, separators=(",", ":")))
    _audit_export(ledger, "metrics_jsonl", len(lines))
    return "\n".join(lines) + ("\n" if lines else "")


_SERIES_RE = re.compile(r'([^,=]+)="([^"]*)"')


def _split_series_key(key: str) -> tuple:
    if "{" not in key:
        return key, {}
    name, _, rest = key.partition("{")
    labels = {m.group(1): m.group(2) for m in _SERIES_RE.finditer(rest[:-1])}
    return name, labels


def to_chrome_trace(spans: Iterable[Span], redactor: Redactor, ledger=None) -> Dict[str, object]:
    """Chrome trace-event JSON (``chrome://tracing`` / Perfetto loadable).

    Each trace id becomes a ``tid`` so one work item's spans stack on one
    track; timestamps convert to microseconds; redacted attrs ride in
    ``args``.
    """
    tids: Dict[str, int] = {}
    events: List[Dict[str, object]] = []
    for s in spans:
        tid = tids.setdefault(s.trace_id, len(tids) + 1)
        t1 = s.t1 if s.t1 is not None else s.t0
        events.append({
            "name": s.name,
            "cat": s.trace_id,
            "ph": "X",
            "pid": 1,
            "tid": tid,
            "ts": round(s.t0 * 1e6, 3),
            "dur": round((t1 - s.t0) * 1e6, 3),
            "args": redactor.attrs(s.attrs),
        })
    thread_names = [
        {"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
         "args": {"name": f"trace {trace_id}"}}
        for trace_id, tid in tids.items()
    ]
    _audit_export(ledger, "chrome_trace", len(events))
    return {"traceEvents": thread_names + events, "displayTimeUnit": "ms"}
