"""Device selection for the port's entry points.

Every entry point runs on the card unless the caller names another device.
There is no probe that falls back to the CPU: without CUDA, asking for the
default device is an error.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda:0`` when ``device`` is None (raises if CUDA is absent);
    otherwise the named device, which must exist."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; "
            "pass device=\"cpu\" to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
