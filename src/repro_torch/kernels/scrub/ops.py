"""Public wrapper for the scrub kernel (``csrc/scrub.cu``).

:func:`scrub_images` launches the CUDA kernel on CUDA tensors and runs the
plain version (``ref.scrub_ref``) on CPU tensors. :func:`pack_rects` packs
ragged rect lists, and :func:`make_blank_fn` adapts the op to the
``ScrubStage`` ``blank_fn`` protocol.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import count_launch
from repro_torch.kernels._launch import check_cuda, raise_on_error, stream_of
from repro_torch.kernels.build import bind
from repro_torch.kernels.scrub.ref import scrub_ref


def scrub_images(
    images: torch.Tensor,
    rects: torch.Tensor,
    *,
    block: Optional[tuple] = None,
) -> torch.Tensor:
    """Blank rectangles on a batch of images.

    images: (N, H, W); rects: (N, R, 4) int32 (x, y, w, h); padding rects have
    w<=0/h<=0. Returns a new tensor of the same shape/dtype. ``block`` is the
    TPU tile shape of the JAX signature; the CUDA kernel masks the ragged
    edge itself and ignores it. Any N, H, W and R run: the kernel launches
    images in slabs of 65535, a plane of 2^31 pixels or more in row
    segments, and takes the rects through shared memory 3072 at a time.
    """
    if images.device.type == "cpu":
        return scrub_ref(images, rects.to(torch.int32))
    check_cuda("scrub_images", images)
    check_cuda("scrub_images rects", rects, (torch.int32,))
    N, H, W = images.shape
    if rects.shape[0] != N or rects.shape[2] != 4:
        raise ValueError(f"rects shape {tuple(rects.shape)} does not fit images {tuple(images.shape)}")
    if images.element_size() not in (1, 2, 4, 8):
        raise TypeError(f"scrub_images: unsupported dtype {images.dtype}")
    out = _empty_at_offset_of(images)
    fn = bind("scrub", "scrub_launch", 3, 5)
    rc = fn(images.data_ptr(), out.data_ptr(), rects.data_ptr(), N, H, W, rects.shape[1],
            images.element_size(), stream_of(images))
    raise_on_error("scrub", rc, f"(images {tuple(images.shape)}, {rects.shape[1]} rects)")
    count_launch("scrub", images, rects.shape[1])
    return out


def _empty_at_offset_of(images: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor like ``images`` whose data starts at the same
    offset from a 16-byte boundary: the kernel moves 16-byte chunks on both
    sides. A view such as ``images[1:]`` may start anywhere; a fresh
    allocation starts on a boundary, so it is cut from a buffer 16 bytes
    longer where the offsets differ."""
    offset = images.data_ptr() % 16
    if offset == 0:
        return torch.empty_like(images)
    nbytes = images.numel() * images.element_size()
    buf = torch.empty(nbytes + 16, dtype=torch.uint8, device=images.device)
    start = (offset - buf.data_ptr()) % 16
    return buf[start:start + nbytes].view(images.dtype).view(images.shape)


def pack_rects(rect_lists: Sequence[Sequence[tuple]], R: int | None = None) -> np.ndarray:
    """Pack ragged per-image rect lists into a (N, R, 4) int32 array.

    ``R`` defaults to the longest list (min 1). An explicit ``R`` smaller than
    the longest list raises — silently dropping scrub rectangles would ship
    PHI pixels through un-blanked.
    """
    longest = max((len(r) for r in rect_lists), default=0)
    if R is None:
        R = max(longest, 1)
    elif longest > R:
        raise ValueError(
            f"rect list of length {longest} does not fit R={R}; "
            "refusing to truncate scrub rectangles"
        )
    out = np.zeros((len(rect_lists), R, 4), np.int32)
    for i, rl in enumerate(rect_lists):
        for j, rect in enumerate(rl):
            out[i, j] = rect
    return out


def make_blank_fn(device: DeviceLike = None):
    """A ``ScrubStage(blank_fn=...)`` adapter: single-image host entry point
    backed by :func:`scrub_images` on ``device`` (default ``cuda:0``)."""
    dev = resolve_device(device)

    def blank_fn(pixels: np.ndarray, rects) -> np.ndarray:
        img = torch.from_numpy(np.ascontiguousarray(pixels))[None].to(dev)
        packed = torch.from_numpy(pack_rects([list(rects)])).to(dev)
        return scrub_images(img, packed)[0].cpu().numpy()

    # same observable contract as core.scrub.numpy_blank (zero the
    # rectangles, touch nothing else): the batched executor may substitute
    # the fused kernel
    blank_fn.rect_blank_semantics = True
    return blank_fn
