"""Plain PyTorch version of the fused scrub+JLS kernel (``csrc/fused.cu``):
the staged two-pass composition ``scrub_ref -> residuals_ref``. The kernel
must match it bit-exactly, as must the host ``numpy_blank -> codec.residuals``
pair."""
from __future__ import annotations

import torch

from repro_torch.kernels.jls.ref import residuals_ref
from repro_torch.kernels.scrub.ref import scrub_ref


def fused_ref(images: torch.Tensor, rects: torch.Tensor, sv: int, bits: int) -> torch.Tensor:
    """images: (N, H, W) uint8/uint16; rects: (N, R, 4) int32. Staged oracle."""
    return residuals_ref(scrub_ref(images, rects), sv, bits)
