"""Public wrapper for the text-band detector kernel (``csrc/textdetect.cu``).

:func:`tile_profiles` launches the CUDA kernel on CUDA tensors and runs the
plain version (``ref.tile_profiles_torch``) on CPU tensors. The CUDA kernel
reads pixels past the frame as zeros, which is the padding to tile
multiples that the plain version (and the JAX wrapper) adds, so a padding
pixel is a hit whenever ``thresh <= 0``. :func:`row_hit_profile` reduces the
tile profiles to the full-width per-row hit counts the band extractor
(``repro_torch.detect.regions``) consumes. The binarization threshold reuses
``phi_detect``'s dtype-aware ceiling logic: ``full_scale`` /
``stored_max_value`` times :data:`BINARIZE_FRAC`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.detect.policy import DEFAULT_BINARIZE_FRAC as BINARIZE_FRAC
from repro_torch.kernels import count_launch
from repro_torch.kernels._launch import (
    PIXEL_CODES,
    check_cuda,
    numpy_dtype,
    raise_on_error,
    require_tensor,
    stream_of,
)
from repro_torch.kernels.build import bind
from repro_torch.kernels.phi_detect.ops import full_scale
from repro_torch.kernels.textdetect.ref import tile_profiles_torch


def binarize_thresh(dtype, max_value: float | None = None) -> float:
    """Dtype-aware glyph threshold (same ceiling logic as ``phi_detect``)."""
    return full_scale(dtype, max_value) * BINARIZE_FRAC


def tile_profiles(
    images,
    *,
    thresh: float | None = None,
    max_value: float | None = None,
    tile: tuple[int, int] = (32, 128),
):
    """Per-tile (rows, cols, runs) int32 profiles for a batch (N, H, W)
    torch tensor, on its device.

    H and W need not be tile multiples: the last tiles see zeros past the
    frame. The default threshold is :func:`binarize_thresh` of the dtype
    (pass ``max_value`` for BitsStored-style narrow ranges held in wide
    words). On CUDA any N, H, W and tile run.
    """
    images = require_tensor("tile_profiles", images)
    if thresh is None:
        thresh = binarize_thresh(numpy_dtype(images.dtype), max_value)
    th, tw = (int(v) for v in tile)
    if images.device.type == "cpu":
        return tile_profiles_torch(images, thresh, (th, tw))
    check_cuda("tile_profiles", images, tuple(PIXEL_CODES))
    N, H, W = images.shape
    Ht, Wt = -(-H // th), -(-W // tw)
    dev = images.device
    rows = torch.empty((N, Ht, Wt, th), dtype=torch.int32, device=dev)
    cols = torch.empty((N, Ht, Wt, tw), dtype=torch.int32, device=dev)
    runs = torch.empty((N, Ht, Wt), dtype=torch.int32, device=dev)
    fn = bind("textdetect", "textdetect_launch", 4, 6, 1)
    rc = fn(images.data_ptr(), rows.data_ptr(), cols.data_ptr(), runs.data_ptr(),
            N, H, W, th, tw, PIXEL_CODES[images.dtype], float(thresh), stream_of(images))
    raise_on_error("textdetect", rc, f"(tile {(th, tw)}, grid {(Wt, Ht, N)})")
    count_launch("textdetect", images, (th, tw))
    return rows, cols, runs


def row_hits(images, *, tile: tuple[int, int] = (32, 128), **kw) -> torch.Tensor:
    """Full-width per-row hit counts (N, H) int32 on the images' device: the
    row profiles summed over the tile columns. The sum stays outside the
    kernel, as it does in the JAX package."""
    images = require_tensor("row_hits", images)
    N, H, _ = images.shape
    rows, _, _ = tile_profiles(images, tile=tile, **kw)
    return rows.sum(dim=2, dtype=torch.int32).reshape(N, -1)[:, :H]


def row_hit_profile(
    images,
    *,
    thresh: float | None = None,
    max_value: float | None = None,
    tile: tuple[int, int] = (32, 128),
) -> np.ndarray:
    """Full-width per-row hit counts, host (N, H) int32 — the kernel-path
    equivalent of ``ref.row_hits_np`` (bit-identical at a positive
    threshold, parity-tested)."""
    return row_hits(images, thresh=thresh, max_value=max_value, tile=tile).cpu().numpy()
