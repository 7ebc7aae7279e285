"""Public wrapper for the fused scrub+JLS kernel (``csrc/fused.cu``).

On CUDA tensors it launches the kernel; on CPU tensors it runs the plain
version (``ref.fused_ref``). Unlike the TPU wrapper it pads nothing and
builds no shifted ``above`` input: each CUDA thread reads its own
neighbours and the kernel masks the ragged edge. :func:`fused_encode_batch`
is the fused kernel-assisted encode.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels._launch import check_cuda, raise_on_error, stream_of
from repro_torch.kernels.build import bind
from repro_torch.kernels.fused.ref import fused_ref
from repro_torch.kernels.jls.ops import pack_payloads
from repro_torch.kernels.scrub.ops import pack_rects

_DTYPES = (torch.uint8, torch.uint16)


def fused_scrub_residuals(
    images: torch.Tensor,
    rects: torch.Tensor,
    *,
    sv: int = 1,
    bits: int | None = None,
    bh: int = 64,
) -> torch.Tensor:
    """Blank rectangles and compute predictor residuals in one device pass.

    images: (N, H, W) uint8/uint16; rects: (N, R, 4) int32 (x, y, w, h),
    padding rects have w<=0/h<=0. Returns int32 (N, H, W) residuals of the
    scrubbed image. ``bh`` is the TPU stripe height of the JAX signature and
    is ignored.
    """
    if bits is None:
        bits = images.element_size() * 8
    if not 1 <= sv <= 7:
        raise ValueError(f"selection value must be 1..7, got {sv}")
    if images.device.type == "cpu":
        return fused_ref(images, rects.to(torch.int32), sv, bits)
    check_cuda("fused_scrub_residuals", images, _DTYPES)
    check_cuda("fused_scrub_residuals rects", rects, (torch.int32,))
    N, H, W = images.shape
    if rects.shape[0] != N or rects.shape[2] != 4:
        raise ValueError(f"rects shape {tuple(rects.shape)} does not fit images {tuple(images.shape)}")
    out = torch.empty((N, H, W), dtype=torch.int32, device=images.device)
    fn = bind("fused", "fused_scrub_residuals_launch", 3, 7)
    rc = fn(images.data_ptr(), rects.data_ptr(), out.data_ptr(), N, H, W, rects.shape[1],
            images.element_size(), sv, bits, stream_of(images))
    raise_on_error("fused", rc)
    LAUNCHES["fused"] += 1
    return out


def fused_encode_batch(images: np.ndarray, rect_lists, sv: int = 1,
                       device: DeviceLike = None) -> list[bytes]:
    """Fused-kernel-assisted encode of a uniform batch: blank + residuals on
    ``device`` (default ``cuda:0``) in one pass, Golomb-Rice entropy code on
    the host. Byte-identical to ``codec.encode(numpy_blank(img, rects), sv)``."""
    dev = resolve_device(device)
    imgs = torch.from_numpy(np.ascontiguousarray(images)).to(dev)
    rects = torch.from_numpy(pack_rects([list(r) for r in rect_lists])).to(dev)
    res = fused_scrub_residuals(imgs, rects, sv=sv).cpu().numpy()
    return pack_payloads(res, images.dtype.itemsize * 8, sv)
