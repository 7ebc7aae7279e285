"""Shared checks and launch plumbing for the CUDA wrappers."""
from __future__ import annotations

import numpy as np
import torch

# pixel types the detector kernels read, by the code their C entry points
# take (``csrc/pixels.cuh``)
PIXEL_CODES = {torch.uint8: 0, torch.uint16: 1, torch.int16: 2, torch.int32: 3, torch.float32: 4}


def check_cuda(name: str, t: torch.Tensor, dtypes=None, ndim: int = 3) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if dtypes is not None and t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")


def require_tensor(name: str, images) -> torch.Tensor:
    """``images`` itself: the ops take torch tensors only, so that the
    tensor's device decides where they run (a numpy array would run the
    plain version on the host unnoticed)."""
    if not isinstance(images, torch.Tensor):
        raise TypeError(f"{name}: expected a torch tensor, got {type(images).__name__}; "
                        "place it on its device with torch.from_numpy(...).to(device)")
    return images


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return np.dtype(str(dtype).removeprefix("torch."))


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# cudaErrorInvalidValue: what a C entry point returns for a shape, tile or
# pixel type it refuses, checked there against the kernel's own limits
_INVALID_VALUE = 1


def raise_on_error(kernel: str, rc: int, what: str = "") -> None:
    if rc == _INVALID_VALUE:
        raise ValueError(f"CUDA kernel {kernel} refused its launch arguments {what}".rstrip())
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: cudaError {rc}")
