"""Public wrapper for the bitmap combine kernel (``csrc/bitmap.cu``).

Bitmaps at this surface are int32 tensors holding the uint32 bit pattern:
torch refuses shifts and ``~`` on ``torch.uint32`` and has no popcount, so
the kernel reads the int32 words as ``const uint32_t*`` and only host numpy
views them as uint32 (:func:`unpack_mask`). Bit ``b`` of word ``w`` is row
``32 * w + b``, the layout of ``ref.pack_mask_np``.

:func:`combine_bitmaps` launches the CUDA kernel on a CUDA tensor (or
raises) and runs the plain version (:func:`combine_bitmaps_torch`) on a CPU
tensor. The program limits (ops, stack depth) live in the C entry point,
which refuses a program it does not take; the wrapper raises ``ValueError``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import count_launch
from repro_torch.kernels._launch import check_cuda, raise_on_error, require_tensor, stream_of
from repro_torch.kernels.bitmap.ref import Program, run_program, unpack_mask_np
from repro_torch.kernels.build import bind, library

# opcodes of csrc/bitmap.cu; a name outside this table reaches the entry
# point as -1, which it refuses
OPCODES = {"leaf": 0, "and": 1, "or": 2, "not": 3}


def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """(n,) bool tensor -> (max(ceil(n/32), 1),) int32 words on its device.

    The weighted sum is taken in int64 (a word's value is below 2^32) and
    wrapped to int32 explicitly, so no out-of-range cast is relied on."""
    mask = require_tensor("pack_mask", mask)
    n = mask.shape[0]
    words = max((n + 31) // 32, 1)
    padded = torch.zeros(words * 32, dtype=torch.int64, device=mask.device)
    padded[:n] = mask.to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=mask.device) << torch.arange(
        32, dtype=torch.int64, device=mask.device)
    value = (padded.view(words, 32) * weights).sum(dim=1)
    return torch.where(value >= 1 << 31, value - (1 << 32), value).to(torch.int32)


def unpack_mask(bitmap: torch.Tensor, n: int) -> np.ndarray:
    """(W,) int32 words -> host (n,) bool."""
    return unpack_mask_np(bitmap.cpu().numpy().view(np.uint32), n)


def popcount_torch(words: torch.Tensor) -> torch.Tensor:
    """Set bits of int32 words as a 0-dim int64 tensor on their device: a
    32-step ``(x >> b) & 1`` sum, right for int32 under the arithmetic shift
    (bit b is read before the sign bits)."""
    total = torch.zeros((), dtype=torch.int64, device=words.device)
    for b in range(32):
        total += ((words >> b) & 1).sum(dtype=torch.int64)
    return total


def combine_bitmaps_torch(leaves: torch.Tensor, program: Program) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``ref.run_program`` over the int32 leaf rows, and the
    popcount of the result as a 0-dim int64 tensor."""
    out = run_program(leaves, program).clone()
    return out, popcount_torch(out)


def program_limits() -> tuple[int, int]:
    """(max ops, max stack depth) of the CUDA kernel, read from its library."""
    lib = library("bitmap")
    limits = []
    for fn in (lib.bitmap_max_ops, lib.bitmap_max_depth):
        fn.argtypes, fn.restype = [], ctypes.c_int
        limits.append(fn())
    return limits[0], limits[1]


def combine_bitmaps_launch(leaves: torch.Tensor, program: Program) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/bitmap.cu`` on a CUDA (K, W) int32 tensor without
    waiting for it: ((W,) int32 bitmap, (1,) int64 count), both on the card."""
    check_cuda("combine_bitmaps", leaves, (torch.int32,), ndim=2)
    K, W = leaves.shape
    n = len(program)
    ops = (ctypes.c_int * max(n, 1))(*[OPCODES.get(op[0], -1) for op in program])
    args = (ctypes.c_int * max(n, 1))(*[int(op[1]) if op[0] == "leaf" else 0 for op in program])
    out = torch.empty(W, dtype=torch.int32, device=leaves.device)
    count = torch.zeros(1, dtype=torch.int64, device=leaves.device)
    fn = bind("bitmap", "bitmap_combine_launch", 5, 3)
    rc = fn(leaves.data_ptr(), out.data_ptr(), count.data_ptr(), ops, args, K, W, n,
            stream_of(leaves))
    raise_on_error("bitmap", rc, f"(K {K}, W {W}, {n} ops)")
    count_launch("bitmap", leaves, n)
    return out, count


def combine_bitmaps(leaves: torch.Tensor, program: Program) -> tuple[torch.Tensor, int]:
    """Evaluate a compiled predicate program over K leaf bitmaps.

    leaves: (K, W) int32 tensor; program: tuple of stack ops (``ref.py``).
    Returns ((W,) int32 combined bitmap on the leaves' device, total
    popcount as a Python int). The program's terminal validity AND clears
    the tail bits of the last word, so counts never include them under NOT.
    """
    leaves = require_tensor("combine_bitmaps", leaves)
    if leaves.device.type == "cpu":
        out, count = combine_bitmaps_torch(leaves, program)
    else:
        out, count = combine_bitmaps_launch(leaves, program)
    return out, int(count.item())
