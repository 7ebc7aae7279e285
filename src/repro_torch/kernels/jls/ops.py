"""Public wrapper for the JPEG-Lossless predictor kernel (``csrc/jls.cu``)
and the kernel-assisted encode.

:func:`jls_residuals` launches the CUDA kernel on CUDA tensors and runs the
plain version (``ref.residuals_ref``) on CPU tensors. Unlike the TPU wrapper
it pads nothing and builds no shifted ``above`` input: each CUDA thread
reads its own neighbours and the kernel masks the ragged edge.
:func:`encode_batch` computes the residuals on a device and entropy-codes
them on the host, byte-identical to ``codec.encode``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dicom import codec
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels._launch import check_cuda, raise_on_error, require_tensor, stream_of
from repro_torch.kernels.build import bind
from repro_torch.kernels.jls.ref import residuals_ref

_DTYPES = (torch.uint8, torch.uint16)


def jls_residuals(
    images: torch.Tensor,
    *,
    sv: int = 1,
    bits: int | None = None,
    bh: int = 64,
) -> torch.Tensor:
    """Batched predictor residuals (N, H, W) uint8/uint16 -> int32 (N, H, W).

    ``bh`` is the TPU stripe height of the JAX signature and is ignored."""
    images = require_tensor("jls_residuals", images)
    if bits is None:
        bits = images.element_size() * 8
    if not 1 <= sv <= 7:
        raise ValueError(f"selection value must be 1..7, got {sv}")
    if images.device.type == "cpu":
        return residuals_ref(images, sv, bits)
    check_cuda("jls_residuals", images, _DTYPES)
    N, H, W = images.shape
    out = torch.empty((N, H, W), dtype=torch.int32, device=images.device)
    fn = bind("jls", "jls_residuals_launch", 2, 6)
    rc = fn(images.data_ptr(), out.data_ptr(), N, H, W, images.element_size(), sv, bits,
            stream_of(images))
    raise_on_error("jls", rc, f"(shape {(N, H, W)}, sv {sv}, bits {bits})")
    LAUNCHES["jls"] += 1
    return out


def pack_payloads(res: np.ndarray, bits: int, sv: int) -> list[bytes]:
    """RJLS streams of an (N, H, W) int32 residual stack: host Golomb-Rice
    code behind the shared header, one stream per plane."""
    out = []
    for r in res:
        payload, k = codec.rice_encode(r)
        out.append(codec.pack_header(r.shape[0], r.shape[1], bits, sv, k, len(payload)) + payload)
    return out


def encode_batch(images: np.ndarray, sv: int = 1, device: DeviceLike = None) -> list[bytes]:
    """Kernel-assisted encode: residuals on ``device`` (default ``cuda:0``),
    entropy code on the host. Byte-identical to ``codec.encode``."""
    dev = resolve_device(device)
    imgs = torch.from_numpy(np.ascontiguousarray(images)).to(dev)
    res = jls_residuals(imgs, sv=sv).cpu().numpy()
    return pack_payloads(res, images.dtype.itemsize * 8, sv)
