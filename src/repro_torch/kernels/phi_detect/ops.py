"""Public wrapper for the PHI text detector (``csrc/phi_detect.cu``) and the
post-scrub burned-in-text audit built on it.

:func:`full_scale` and :func:`stored_max_value` are the one place the
sample ceiling is derived; the scrub stage's detector threshold
(``detect.regions.policy_thresh``) reads it too. :func:`edge_density`
launches the CUDA kernel on CUDA tensors and runs the plain version
(``ref.edge_density_ref``) on CPU tensors. The entry points that take numpy
pixels (:func:`audit_image`, :func:`audit_dataset`) run on ``device``,
``cuda:0`` unless the caller names another.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
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
from repro_torch.kernels.phi_detect.ref import edge_density_ref

# Default gradient threshold: burned-in glyph strokes are max-contrast
# (value jumps of >50% full scale every ~3 px); anatomy gradients are smooth.
DEFAULT_THRESH_FRAC = 0.25  # fraction of the sample value range
DEFAULT_TAU = 0.08          # tile flagged if >=8% of pixels are strong edges


def full_scale(dtype, max_value: float | None = None) -> float:
    """Maximum sample value for thresholding.

    Derived from the dtype (65535 for full-range uint16 ultrasound captures,
    255 for uint8, 1.0 for floats) unless ``max_value`` overrides it — pass
    the BitsStored-derived ceiling (e.g. 4095 for 12-bit CT) when the stored
    range is narrower than the dtype.
    """
    if max_value is not None:
        return float(max_value)
    dt = np.dtype(dtype)
    return float(np.iinfo(dt).max) if dt.kind in "ui" else 1.0


def stored_max_value(ds) -> float:
    """Sample ceiling for a DICOM dataset: BitsStored when declared (12-bit
    CT in uint16 words). Without a declared depth the ceiling is estimated
    from the observed sample maximum (next power-of-two range): the dtype max
    would put the threshold above every gradient a narrow-range image can
    produce and silently fail the audit *open*. This is the one place the
    ceiling is derived — audit callers must not re-implement it."""
    bits = ds.get("BitsStored")
    if bits is not None:
        return float((1 << int(bits)) - 1)
    pix = ds.pixels
    dt = np.dtype(pix.dtype)
    if dt.kind in "ui" and pix.size:
        bits_est = max(int(pix.max()).bit_length(), 1)
        return float((1 << bits_est) - 1)
    return full_scale(dt)


def edge_density(
    images,
    *,
    thresh: float | None = None,
    max_value: float | None = None,
    tile: tuple[int, int] = (32, 128),
) -> torch.Tensor:
    """Per-tile strong-edge density for a batch of images, an (N, H, W)
    torch tensor: float32 (N, ceil(H/th), ceil(W/tw)) on its device.

    The default threshold is ``DEFAULT_THRESH_FRAC`` of the dtype's full
    scale; pass ``max_value`` (BitsStored-style) when the stored range is
    narrower, e.g. 4095 for 12-bit data held in uint16. The CUDA kernel
    reads pixels past the frame as zeros, the padding the plain version
    adds; it takes any N, H, W and tile but one of 2^31 pixels or more
    (raises ``ValueError``: the reference's float32 hit sum is exact only
    to 2^24).
    """
    images = require_tensor("edge_density", images)
    if thresh is None:
        thresh = full_scale(numpy_dtype(images.dtype), max_value) * DEFAULT_THRESH_FRAC
    th, tw = (int(v) for v in tile)
    if images.device.type == "cpu":
        return edge_density_ref(images, thresh, (th, tw))
    check_cuda("edge_density", images, tuple(PIXEL_CODES))
    N, H, W = images.shape
    Ht, Wt = -(-H // th), -(-W // tw)
    out = torch.empty((N, Ht, Wt), dtype=torch.float32, device=images.device)
    fn = bind("phi_detect", "phi_detect_launch", 2, 6, 1)
    rc = fn(images.data_ptr(), out.data_ptr(), N, H, W, th, tw, PIXEL_CODES[images.dtype],
            float(thresh), stream_of(images))
    raise_on_error("phi_detect", rc, f"(tile {(th, tw)}, grid {(Wt, Ht, N)})")
    count_launch("phi_detect", images, (th, tw))
    return out


def suspicious_tiles(images, *, tau: float = DEFAULT_TAU, **kw) -> np.ndarray:
    """Boolean heat map of tiles likely to contain burned-in text (host)."""
    density = edge_density(images, **kw)
    return (density >= torch.tensor(tau, dtype=torch.float32)).cpu().numpy()


def audit_image(
    pixels: np.ndarray,
    *,
    tile=(32, 128),
    tau: float = DEFAULT_TAU,
    max_value: float | None = None,
    device: DeviceLike = None,
) -> bool:
    """True if any tile of a single image looks like burned-in text.
    Used on *post-scrub* images: a True here means a scrub rule missed a
    region. ``max_value`` is the BitsStored-derived sample ceiling (see
    :func:`edge_density`); ``device`` defaults to ``cuda:0``."""
    img = torch.from_numpy(np.ascontiguousarray(pixels))[None].to(resolve_device(device))
    return bool(suspicious_tiles(img, tau=tau, tile=tile, max_value=max_value).any())


def audit_dataset(ds, device: DeviceLike = None, **kw) -> bool:
    """Audit a DICOM dataset's pixels at its *stored* bit depth — the safe
    entry point for pipeline/audit callers (a raw ``audit_image`` on 12-bit
    data held in uint16 would threshold at the dtype max and fail open)."""
    return audit_image(ds.pixels, max_value=stored_max_value(ds), device=device, **kw)
