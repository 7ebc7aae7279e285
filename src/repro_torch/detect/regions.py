"""Band proposal geometry: profiles -> bands -> blank rectangles.

Host half of the burned-in-text detector. Consumes the per-row glyph-hit
counts produced by ``kernels/textdetect`` (CUDA kernel or numpy oracle —
bit-identical, so the rectangles below are too) and turns them into the
rectangles the scrub stage blanks:

* :func:`bands_from_hits` — rows whose hit count clears the width-relative
  threshold, grouped into contiguous bands, filtered by minimum height,
  padded, and re-merged.
* :func:`rects_from_bands` — bands become **full-width** blank rects. The
  column profile could trim a band horizontally, but glyph gaps (the dim
  inter-stroke pixels) carry PHI residue outside the hit columns, so
  trimming would fail *open*; full-width bands fail closed and text banners
  are band-shaped anyway. Column extent stays a report statistic.
* :func:`merge_rects` — exact-union rect normalization, shared with the
  scrub stage's registry+detector union: drops empties and contained rects,
  merges pairs whose union is exactly a rectangle (same column extent with
  overlapping/touching row ranges, or vice versa). The blanked pixel set is
  provably unchanged — only duplicates and double-covered tiles go away.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.dicom.devices import Rect
from repro_torch.kernels.phi_detect.ops import stored_max_value
from repro_torch.kernels.textdetect.ref import row_hits_np

Band = Tuple[int, int]  # [y0, y1) row range


def bands_from_hits(
    hits: np.ndarray,
    width: int,
    *,
    row_frac: float,
    min_rows: int = 2,
    pad_rows: int = 2,
) -> List[Band]:
    """Group hot rows into candidate text bands.

    ``hits`` is the (H,) per-row glyph-hit count; a row is *hot* when it has
    at least ``ceil(row_frac * width)`` hits (integer compare — deterministic
    across platforms). Contiguous hot rows form a band; bands shorter than
    ``min_rows`` are dropped (speckle), survivors are padded by ``pad_rows``
    on both sides, clipped to the frame, and merged where padding made them
    overlap or touch.
    """
    H = int(hits.shape[0])
    need = max(1, int(np.ceil(row_frac * width)))
    hot = np.asarray(hits) >= need
    bands: List[Band] = []
    y = 0
    while y < H:
        if not hot[y]:
            y += 1
            continue
        y0 = y
        while y < H and hot[y]:
            y += 1
        if y - y0 >= min_rows:
            bands.append((max(0, y0 - pad_rows), min(H, y + pad_rows)))
    # padding may have fused neighbours
    merged: List[Band] = []
    for y0, y1 in bands:
        if merged and y0 <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], y1))
        else:
            merged.append((y0, y1))
    return merged


def rects_from_bands(bands: Sequence[Band], width: int) -> List[Rect]:
    """Full-width blank rects, one per band ((x, y, w, h) convention)."""
    return [(0, y0, width, y1 - y0) for y0, y1 in bands]


def _contains(a: Rect, b: Rect) -> bool:
    ax, ay, aw, ah = a
    bx, by, bw, bh = b
    return ax <= bx and ay <= by and bx + bw <= ax + aw and by + bh <= ay + ah


def _exact_union(a: Rect, b: Rect) -> Rect | None:
    """The union of a and b when it is exactly a rectangle, else None.

    Two cases: same column extent with overlapping-or-touching row ranges
    (stacked bands), or same row extent with overlapping-or-touching column
    ranges (side-by-side blocks). Anything else would over-blank, so it is
    left alone — merging here must never change the blanked pixel set.
    """
    ax, ay, aw, ah = a
    bx, by, bw, bh = b
    if ax == bx and aw == bw and not (ay + ah < by or by + bh < ay):
        y0 = min(ay, by)
        return (ax, y0, aw, max(ay + ah, by + bh) - y0)
    if ay == by and ah == bh and not (ax + aw < bx or bx + bw < ax):
        x0 = min(ax, bx)
        return (x0, ay, max(ax + aw, bx + bw) - x0, ah)
    return None


def merge_rects(rects: Sequence[Rect]) -> List[Rect]:
    """Normalize a blank-rect list without changing the blanked pixel set.

    Drops degenerate rects (w <= 0 or h <= 0 — pack_rects padding
    convention), dedupes, drops rects contained in another, and merges pairs
    whose union is exactly a rectangle, to a fixpoint. Registry + detector
    unions routinely produce overlapping and stacked rects; after this pass
    the fused kernel never blanks the same tile twice and the rect-count
    bucket stays small. Output is sorted (y, x, h, w) — deterministic
    regardless of input order.
    """
    work = sorted({(int(x), int(y), int(w), int(h)) for x, y, w, h in rects
                   if w > 0 and h > 0}, key=lambda r: (r[1], r[0], r[3], r[2]))
    changed = True
    while changed:
        changed = False
        out: List[Rect] = []
        for r in work:
            placed = False
            for i, q in enumerate(out):
                if _contains(q, r):
                    placed = True
                    break
                if _contains(r, q):
                    out[i] = r
                    placed = True
                    changed = True
                    break
                u = _exact_union(q, r)
                if u is not None:
                    out[i] = u
                    placed = True
                    changed = True
                    break
            if not placed:
                out.append(r)
        work = sorted(set(out), key=lambda r: (r[1], r[0], r[3], r[2]))
    return list(work)


def detect_bands_np(
    pixels: np.ndarray,
    *,
    thresh: float,
    row_frac: float,
    tile: Tuple[int, int] = (32, 128),
    min_rows: int = 2,
    pad_rows: int = 2,
    row_hits: np.ndarray | None = None,
) -> Tuple[List[Band], List[Rect]]:
    """One-image host detection: (bands, full-width blank rects).

    ``row_hits`` short-circuits the profile computation when a batched
    executor dispatch already produced it (kernel path); otherwise the numpy
    oracle runs — the two are bit-identical, so callers may mix freely.
    """
    H, W = pixels.shape[:2]
    if row_hits is None:
        row_hits = row_hits_np(pixels[None], thresh, tile)[0]
    bands = bands_from_hits(
        row_hits, W, row_frac=row_frac, min_rows=min_rows, pad_rows=pad_rows
    )
    return bands, rects_from_bands(bands, W)


def policy_thresh(ds, policy) -> float:
    """Binarization threshold for one dataset under a policy: the stored
    sample ceiling (BitsStored-aware, ``phi_detect``'s single derivation
    point) times the policy's fraction."""
    return stored_max_value(ds) * policy.binarize_frac


def detect_bands_for(
    ds, policy, row_hits: np.ndarray | None = None, thresh: float | None = None
) -> Tuple[List[Band], List[Rect]]:
    """Dataset-level detection under a :class:`~repro_torch.detect.DetectorPolicy`
    — the ONE place the ceiling -> threshold -> policy-knob forwarding
    lives. The scrub stage, the sim's PHI audit, and the catalog's
    ``burned_in_detected`` ingest column all call this, so their standards
    cannot drift apart."""
    if thresh is None:
        thresh = policy_thresh(ds, policy)
    return detect_bands_np(
        ds.pixels,
        thresh=thresh,
        row_frac=policy.tau_for(str(ds.get("Modality", ""))),
        tile=policy.tile,
        min_rows=policy.min_band_rows,
        pad_rows=policy.pad_rows,
        row_hits=row_hits,
    )
