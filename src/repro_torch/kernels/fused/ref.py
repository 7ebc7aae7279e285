"""Plain PyTorch version of the fused scrub+JLS kernel (``csrc/fused.cu``):
the staged two-pass composition ``scrub_ref -> residuals_ref``. The kernel
must match it bit-exactly, as must the host ``numpy_blank -> codec.residuals``
pair."""
from __future__ import annotations

import torch

from repro_torch.kernels.scrub.ref import scrub_ref


def residuals_ref(images: torch.Tensor, sv: int, bits: int) -> torch.Tensor:
    """int32 JPEG-Lossless residuals (N, H, W) of an unsigned-int stack,
    signed modulo 2^bits, with the codec's border convention."""
    if not 1 <= sv <= 7:
        raise ValueError(f"selection value must be 1..7, got {sv}")
    x = images.to(torch.int32)  # by value: uint16 >= 32768 stays positive
    ra = torch.zeros_like(x)
    rb = torch.zeros_like(x)
    rc = torch.zeros_like(x)
    ra[:, :, 1:] = x[:, :, :-1]
    rb[:, 1:, :] = x[:, :-1, :]
    rc[:, 1:, 1:] = x[:, :-1, :-1]
    pred = {
        1: lambda: ra,
        2: lambda: rb,
        3: lambda: rc,
        4: lambda: ra + rb - rc,
        5: lambda: ra + ((rb - rc) >> 1),
        6: lambda: rb + ((ra - rc) >> 1),
        7: lambda: (ra + rb) >> 1,
    }[sv]().clone()
    pred[:, 0, 1:] = ra[:, 0, 1:]
    pred[:, 1:, 0] = rb[:, 1:, 0]
    pred[:, 0, 0] = 1 << (bits - 1)
    r = (x - pred) & ((1 << bits) - 1)
    return torch.where(r >= (1 << (bits - 1)), r - (1 << bits), r)


def fused_ref(images: torch.Tensor, rects: torch.Tensor, sv: int, bits: int) -> torch.Tensor:
    """images: (N, H, W) uint8/uint16; rects: (N, R, 4) int32. Staged oracle."""
    return residuals_ref(scrub_ref(images, rects), sv, bits)
