"""Self time of the program's spans inside the measured window.

The de-identification driver hands the readers under ``metrics/`` the
pipeline's spans as ``(name, t0, t1)`` on the harness's clock
(``cell.layer["deid"]["pipeline_spans"]``): the worker's, the service's,
the pipeline's and the executor's, all on the deployment's one tracer.

A span's self time is its time inside the window, less the part of its
interval covered by spans nested strictly inside it. The study path opens
its spans on one host thread, so nesting by interval is parentage. Of two
spans with the same interval the one listed first is the inner one: a
tracer lists a span when it closes, so a child before its parent.

The stage metrics are in milliseconds a GB of source pixels: self time
over the window's pixel GB (``pixel_bytes``, the numerator of
``deid_MB_per_s``). The study path is serial, so the stages and the
unnamed rest add up to ``1e6 / deid_MB_per_s``.
"""
from __future__ import annotations

import bisect
from typing import Iterable, List, Optional, Sequence, Tuple

Span = Tuple[str, float, float]


def union_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _overlapping(spans: Sequence[Span], window: Tuple[float, float]) -> List[Tuple[int, str, float, float]]:
    """(index, name, start, end) of the spans that overlap the window."""
    t0, t1 = window
    return [(k, n, a, b) for k, (n, a, b) in enumerate(spans) if a < t1 and b > t0]


def self_seconds(spans: Sequence[Span], names: Iterable[str],
                 window: Tuple[float, float]) -> Optional[float]:
    """Summed self time, inside ``window``, of the spans named in
    ``names``; None where none of them overlaps the window."""
    names = set(names)
    t0, t1 = window
    inside = _overlapping(spans, window)
    by_start = sorted(inside, key=lambda s: s[2])
    starts = [s[2] for s in by_start]
    total, found = 0.0, False
    for k, n, a, b in inside:
        if n not in names:
            continue
        found = True
        lo, hi = max(a, t0), min(b, t1)
        inner = []
        for j, _, ca, cb in by_start[bisect.bisect_left(starts, a):bisect.bisect_right(starts, b)]:
            if cb > b or j == k or ((ca, cb) == (a, b) and j > k):
                continue
            inner.append((max(ca, lo), min(cb, hi)))
        total += (hi - lo) - union_seconds((x, y) for x, y in inner if y > x)
    return total if found else None


def uncovered_seconds(spans: Sequence[Span], window: Tuple[float, float]) -> float:
    """Time of the window that no span covers."""
    t0, t1 = window
    covered = union_seconds((max(a, t0), min(b, t1)) for _, n, a, b in _overlapping(spans, window))
    return (t1 - t0) - covered


def deid_spans(cell) -> Tuple[Optional[list], float]:
    """The pipeline's spans of a de-identification run and the window's
    source pixel GB (None and 0 where the run kept no spans)."""
    deid = cell.layer.get("deid", {})
    return deid.get("pipeline_spans") or None, deid.get("pixel_bytes", 0) / 1e9


def ms_per_gb(cell, names: Iterable[str]) -> Optional[float]:
    """Self time of the spans named in ``names`` inside the window, in
    milliseconds a GB of the window's source pixels."""
    spans, gb = deid_spans(cell)
    if spans is None or gb <= 0:
        return None
    secs = self_seconds(spans, names, cell.window)
    return None if secs is None else 1e3 * secs / gb
