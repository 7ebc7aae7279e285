"""Golomb-Rice entropy pre-pass: CUDA kernels (``csrc/entropy.cu``) and
their plain PyTorch versions.

The split codec (``repro_torch.dicom.codec``) factors entropy coding into a
*plan* phase (zigzag magnitudes, Rice parameter k, per-symbol code lengths)
and a *pack* phase (the final unary splice). The plan phase is pointwise +
reduction work, so these two ops run it on the device and leave the host
only the splice:

* :func:`rice_prepass` — zigzag + per-row int32 sums. The host folds the row
  sums into the per-instance exact zigzag sum (in int64) and derives k with
  ``codec._rice_k_from_sum``, so the device-assisted plan lands on the same
  k as the host plan.
* :func:`rice_len_rem` — given per-instance k, per-symbol code lengths and
  the k-bit remainder words (``codec.rice_plan_from_prepass`` consumes them).

Each op launches its kernel on CUDA tensors and runs the plain version on
CPU tensors. Both return without waiting for the device; callers choose
when to block.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.dicom.codec import _QMAX
from repro_torch.kernels import count_launch
from repro_torch.kernels._launch import check_cuda, raise_on_error, stream_of
from repro_torch.kernels.build import bind

_ESC_LEN = _QMAX + 2 + 64
_K_MAX = 30  # codec._rice_k_from_sum never returns more


def rice_prepass_plain(res: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`rice_prepass`."""
    r = res.to(torch.int32)
    u = (r << 1) ^ (r >> 31)  # arithmetic >>
    # int64 sum, then the int32 wrap an int32 accumulator would give
    return u, u.sum(dim=2, dtype=torch.int64).to(torch.int32)


def rice_len_rem_plain(u: torch.Tensor, ks: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`rice_len_rem`; ``ks`` is (N,) int32."""
    k = ks.to(torch.int32).reshape(-1, 1, 1)
    # logical shift of the 32-bit pattern, then back to int32
    q = ((u.to(torch.int64) & 0xFFFFFFFF) >> k.to(torch.int64)).to(torch.int32)
    lens = torch.where(q > _QMAX, torch.full_like(q, _ESC_LEN), q + 1 + k)
    return lens, u & ((1 << k) - 1)


def rice_prepass(res: torch.Tensor, *, bh: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """Zigzag magnitudes + per-row sums for an (N, H, W) int32 residual batch.

    Returns (int32 ``u`` (N, H, W), int32 row sums (N, H)). ``bh`` is the TPU
    stripe height of the JAX signature and is ignored.
    """
    if res.device.type == "cpu":
        return rice_prepass_plain(res)
    check_cuda("rice_prepass", res, (torch.int32,))
    N, H, W = res.shape
    u = torch.empty_like(res)
    rs = torch.empty((N, H), dtype=torch.int32, device=res.device)
    fn = bind("entropy", "rice_prepass_launch", 3, 3)
    rc = fn(res.data_ptr(), u.data_ptr(), rs.data_ptr(), N, H, W, stream_of(res))
    raise_on_error("rice_prepass", rc)
    count_launch("rice_prepass", res)
    return u, rs


def rice_len_rem(u: torch.Tensor, ks, *, bh: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-symbol code lengths + k-bit remainder words for a zigzag batch.

    ``ks`` is the per-instance Rice parameter, (N,) or (N, 1), each in
    [0, 30]: a host array is checked here, a CUDA tensor is trusted. Returns
    int32 (lens, rem), both (N, H, W).
    """
    if not (isinstance(ks, torch.Tensor) and ks.is_cuda):
        host = np.asarray(ks.cpu() if isinstance(ks, torch.Tensor) else ks).reshape(-1)
        if host.size and (host.min() < 0 or host.max() > _K_MAX):
            raise ValueError(f"Rice parameters must lie in [0, {_K_MAX}], got {host.tolist()}")
    ks = torch.as_tensor(ks, dtype=torch.int32, device=u.device).reshape(-1)
    if ks.numel() != u.shape[0]:
        raise ValueError(f"{ks.numel()} Rice parameters for {u.shape[0]} instances")
    if u.device.type == "cpu":
        return rice_len_rem_plain(u, ks)
    check_cuda("rice_len_rem", u, (torch.int32,))
    ks = ks.contiguous()
    N, H, W = u.shape
    lens = torch.empty_like(u)
    rem = torch.empty_like(u)
    fn = bind("entropy", "rice_len_rem_launch", 4, 4)
    rc = fn(u.data_ptr(), ks.data_ptr(), lens.data_ptr(), rem.data_ptr(), N, H, W, _QMAX,
            stream_of(u))
    raise_on_error("rice_len_rem", rc)
    count_launch("rice_len_rem", u)
    return lens, rem
