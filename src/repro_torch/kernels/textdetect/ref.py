"""Oracles for the text-band detector kernel (``csrc/textdetect.cu``): the
numpy host oracle and the plain PyTorch version of the kernel.

Semantics (tile-local by construction, so kernel and oracles agree exactly,
bit for bit — everything below is integer arithmetic after one float32
compare):

* **binarize** — a pixel is a *glyph hit* when ``float32(x) >= float32(t)``.
  The threshold ``t`` is dtype-aware (``phi_detect.ops.full_scale`` /
  ``stored_max_value`` times a fraction): burned-in glyph strokes sit at the
  top of the stored sample range, anatomy tops out well below it.
* **projection profiles** — per (th, tw) tile, the row profile counts hits in
  each tile row and the column profile counts hits in each tile column.
  Full-image row profiles are exact tile-column sums, which is what makes the
  reduction embarrassingly tileable.
* **run-lengths** — per tile, the maximum horizontal run of consecutive hits
  (runs do not span tile boundaries, mirroring ``phi_detect``'s tile-local
  gradient convention). Text is a fence of short dense runs; a saturated
  anatomy patch would produce one tile-wide run, so the statistic separates
  the two and rides into the :class:`~repro_torch.detect.report.DetectionReport`.

The numpy functions are the host path of the detector (the scrub stage's
serial scan and the executor's CPU dispatch). :func:`tile_profiles_torch` is
the kernel's plain version: the ops wrapper runs it on CPU tensors, and on
the card it is the kernel's comparison.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.phi_detect.ref import pad_to_tiles, to_float32

Profiles = Tuple[np.ndarray, np.ndarray, np.ndarray]  # rows, cols, runs


def binarize_np(images: np.ndarray, thresh: float) -> np.ndarray:
    """(N, H, W) -> (N, H, W) int32 glyph-hit mask. The one float compare of
    the whole detector: both sides are cast to float32 first so numpy and the
    kernel see identical values for every integer dtype."""
    return (images.astype(np.float32) >= np.float32(thresh)).astype(np.int32)


def tile_profiles_ref(
    images: np.ndarray, thresh: float, tile: Tuple[int, int]
) -> Profiles:
    """images: (N, H, W), tile-aligned. Returns

    * rows: (N, H/th, W/tw, th) int32 — per-tile row projection profile;
    * cols: (N, H/th, W/tw, tw) int32 — per-tile column projection profile;
    * runs: (N, H/th, W/tw) int32 — per-tile max horizontal hit run.
    """
    N, H, W = images.shape
    th, tw = tile
    assert H % th == 0 and W % tw == 0, (images.shape, tile)
    b = binarize_np(images, thresh).reshape(N, H // th, th, W // tw, tw)
    rows = np.ascontiguousarray(b.sum(axis=4, dtype=np.int32).transpose(0, 1, 3, 2))
    cols = b.sum(axis=2, dtype=np.int32)
    # max-run scan, identical recurrence to the kernel's row scan:
    # run_j = (run_{j-1} + b_j) * b_j
    run = np.zeros((N, H // th, th, W // tw), np.int32)
    best = np.zeros_like(run)
    for j in range(tw):
        run = (run + b[..., j]) * b[..., j]
        best = np.maximum(best, run)
    runs = best.max(axis=2).astype(np.int32)
    return rows, cols, runs


def pad_to_tiles_np(images: np.ndarray, tile: Tuple[int, int]) -> np.ndarray:
    """Zero-pad (N, H, W) up to tile multiples. With a positive threshold the
    padding pixels never binarize to a hit, so profiles over real rows are
    unaffected."""
    N, H, W = images.shape
    th, tw = tile
    Hp, Wp = -(-H // th) * th, -(-W // tw) * tw
    if (Hp, Wp) == (H, W):
        return images
    return np.pad(images, ((0, 0), (0, Hp - H), (0, Wp - W)))


def row_hits_np(
    images: np.ndarray, thresh: float, tile: Tuple[int, int] = (32, 128)
) -> np.ndarray:
    """Full-width per-row hit counts, (N, H) int32 — the band extractor's
    input and the hot host path (every CPU detector scan). A full-width row
    sum IS the sum of per-tile row profiles across tile columns (padding
    binarizes to zero at a positive threshold), so this skips the tiled
    reduction — and the run-length scan whose output it would discard —
    while staying bit-identical to the kernel-path wrapper
    (``ops.row_hit_profile``, parity-tested)."""
    assert images.ndim == 3, images.shape
    return binarize_np(images, thresh).sum(axis=2, dtype=np.int32)


def max_run_np(
    images: np.ndarray, thresh: float, tile: Tuple[int, int] = (32, 128)
) -> np.ndarray:
    """(N,) int32 — max tile-local horizontal run per image (report metric)."""
    padded = pad_to_tiles_np(images, tile)
    _, _, runs = tile_profiles_ref(padded, thresh, tile)
    return runs.max(axis=(1, 2)).astype(np.int32)


def tile_profiles_torch(
    images: torch.Tensor, thresh: float, tile: Tuple[int, int]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel. images: (N, H, W), any size: it
    is zero-padded up to tile multiples first, as the JAX wrapper pads
    before its kernel. Returns int32 (rows (N, Ht, Wt, th), cols
    (N, Ht, Wt, tw), runs (N, Ht, Wt)) on the images' device."""
    th, tw = tile
    x = pad_to_tiles(to_float32(images), tile)
    N, H, W = x.shape
    hit = x >= torch.tensor(thresh, dtype=torch.float32)
    b = hit.to(torch.int32).reshape(N, H // th, th, W // tw, tw)
    rows = b.sum(dim=4, dtype=torch.int32).permute(0, 1, 3, 2).contiguous()
    cols = b.sum(dim=2, dtype=torch.int32)
    # the run ending at column j is j minus the last gap at or before j
    # (-1 when there is none), and 0 on a gap
    j = torch.arange(tw, dtype=torch.int32, device=x.device)
    gaps = torch.where(b.bool(), torch.full_like(b, -1), j.expand_as(b))
    run = j - torch.cummax(gaps, dim=4).values
    runs = run.amax(dim=(2, 4)).to(torch.int32)
    return rows, cols, runs
