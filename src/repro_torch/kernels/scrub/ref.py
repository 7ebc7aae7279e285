"""Plain PyTorch version of the scrub kernel (``csrc/scrub.cu``).

Semantics: for each image n, every rectangle (x, y, w, h) in ``rects[n]`` is
blanked to 0. Rectangles with w<=0 or h<=0 are padding no-ops (rect lists are
ragged per device; callers pad to a fixed R). The ops wrapper runs this on
CPU tensors; on the card it is the kernel's comparison.
"""
from __future__ import annotations

import torch

_SAME_WIDTH_INT = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def rect_mask(rects: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(N, H, W) bool coverage of the (N, R, 4) int32 rect lists."""
    rows = torch.arange(H, dtype=torch.int32, device=rects.device)[:, None]
    cols = torch.arange(W, dtype=torch.int32, device=rects.device)[None, :]
    x, y, w, h = (rects[..., c][:, :, None, None] for c in range(4))  # (N, R, 1, 1)
    inside = (cols >= x) & (cols < x + w) & (rows >= y) & (rows < y + h) & (w > 0) & (h > 0)
    return inside.any(dim=1)


def scrub_ref(images: torch.Tensor, rects: torch.Tensor) -> torch.Tensor:
    """images: (N, H, W) of any 1/2/4/8-byte dtype; rects: (N, R, 4) int32.

    Zeroing is done on a same-width integer view (zero bits are zero in
    every dtype), so uint16 never passes through a signed conversion."""
    N, H, W = images.shape
    view = images.view(_SAME_WIDTH_INT[images.element_size()])
    zero = torch.zeros((), dtype=view.dtype, device=images.device)
    return torch.where(rect_mask(rects, H, W), zero, view).view(images.dtype)
