"""The attention of one new token against the K/V cache: the CUDA kernel of
``csrc/decode_attn.cu`` on CUDA tensors, the plain version
``models/attention.py::_decode_core`` off the card."""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple, Union

import torch

from repro_torch.kernels import count_launch
from repro_torch.kernels._launch import raise_on_error, stream_of
from repro_torch.kernels.build import bind

# cache types by the code the C entry points take
DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
# the C entry points' arguments: (pointers, ints, floats), then the stream
PLAN_ARGS = (1, 6, 0)
LAUNCH_ARGS = (6, 10, 1)

# (device, B, S, KV, G, hd, type code) -> (cluster size, score columns, scratch floats)
_plans: Dict[tuple, Tuple[int, int, int]] = {}


def _plan(key: tuple) -> Tuple[int, int, int]:
    plan = _plans.get(key)
    if plan is None:
        out = (ctypes.c_longlong * 3)()
        rc = bind("decode_attn", "decode_attn_plan", *PLAN_ARGS)(ctypes.addressof(out), *key[1:], None)
        raise_on_error("decode_attn", rc, f"(B, S, KV, G, hd {key[1:6]})")
        plan = _plans[key] = tuple(int(x) for x in out)
    return plan


def _check(qg: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           pos: Union[int, torch.Tensor], window: int) -> None:
    """Raises, with the reason, on what the kernel does not take."""
    if k_cache.dim() != 4 or qg.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attn: expected q (B, KV, G, hd) and caches (B, S, KV, hd), got "
                         f"{tuple(qg.shape)}, {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, S, KV, hd = k_cache.shape
    if (qg.shape[0], qg.shape[1], qg.shape[3]) != (B, KV, hd):
        raise ValueError(f"decode_attn: q {tuple(qg.shape)} does not fit the cache {tuple(k_cache.shape)}")
    if not (qg.dtype == k_cache.dtype == v_cache.dtype) or k_cache.dtype not in DTYPE_CODES:
        raise TypeError(f"decode_attn: q and caches must share one type of {tuple(DTYPE_CODES)}, "
                        f"got {qg.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if hd % 16 or not 16 <= hd <= 256:
        raise ValueError(f"decode_attn: head dim {hd} is not a multiple of 16 in 16..256")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("decode_attn: expected contiguous (B, S, KV, hd) caches")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode_attn: the caches must start on a 16-byte boundary")
    if window < 0:
        raise ValueError(f"decode_attn: window {window} < 0")
    if isinstance(pos, torch.Tensor):
        if pos.dim() != 0 or pos.dtype != torch.int64 or pos.device != k_cache.device:
            raise ValueError(f"decode_attn: a tensor pos must be a 0-d int64 on {k_cache.device}, got "
                             f"{tuple(pos.shape)} {pos.dtype} on {pos.device}")
    elif not 0 <= pos < S:
        raise ValueError(f"decode_attn: pos {pos} outside the cache's {S} positions")
    if not (qg.device == k_cache.device == v_cache.device) or k_cache.device.type != "cuda":
        raise ValueError(f"decode_attn: expected q and caches on one CUDA device, got "
                         f"{qg.device}, {k_cache.device}, {v_cache.device}")


def decode_attn(qg: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                pos: Union[int, torch.Tensor], *, window: int, scale: float) -> torch.Tensor:
    """(B, KV, G, hd) attention of one new token's grouped query heads ``qg``
    against the (B, S, KV, hd) caches at positions ``<= pos`` (and ``> pos -
    window`` when ``window`` > 0), in ``qg``'s type. ``pos`` is an int or a
    0-d int64 tensor on the caches' device, read there (a captured step's).
    Off the card (CPU or meta tensors): ``_decode_core``, the plain version.
    Where any of them is on the card, the kernel, which takes bf16 or float32
    throughout, contiguous caches and a head dim that is a multiple of 16 in
    16..256, and raises on anything else; it launches on the current stream
    and never synchronises."""
    if all(t.device.type != "cuda" for t in (qg, k_cache, v_cache)):
        from repro_torch.models.attention import _decode_core

        return _decode_core(qg, k_cache, v_cache, pos, window, scale).to(qg.dtype)
    _check(qg, k_cache, v_cache, pos, window)
    B, S, KV, hd = k_cache.shape
    G = qg.shape[2]
    qg = qg.contiguous()
    code = DTYPE_CODES[k_cache.dtype]
    with torch.cuda.device(k_cache.device):
        c, per_pos, scratch_floats = _plan((k_cache.device.index, B, S, KV, G, hd, code))
        out = torch.empty_like(qg)
        scratch = (torch.empty(scratch_floats, dtype=torch.float32, device=k_cache.device)
                   if scratch_floats else None)
        tensor_pos = isinstance(pos, torch.Tensor)
        rc = bind("decode_attn", "decode_attn_launch", *LAUNCH_ARGS)(
            qg.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, pos.data_ptr() if tensor_pos else None,
            B, S, KV, G, hd, code, 0 if tensor_pos else int(pos), int(window), c, per_pos, float(scale),
            stream_of(k_cache))
    raise_on_error("decode_attn", rc, f"(q {tuple(qg.shape)}, cache {tuple(k_cache.shape)}, cluster {c})")
    count_launch("decode_attn", k_cache, (G, window))
    return out
