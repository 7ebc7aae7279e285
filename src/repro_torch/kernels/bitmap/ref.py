"""Numpy oracle for the bitmap combine kernel.

Same bit layout and the same stack program as the CUDA kernel
(``csrc/bitmap.cu``): bit ``b`` of word ``w`` is row ``w*32 + b``
(little-endian within the word). The kernel and its plain PyTorch version
are held bit for bit against this module.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

# stack program opcodes: ("leaf", i) pushes leaf row i; ("and",)/("or",) pop
# two and push the combination; ("not",) inverts the top of the stack.
Program = Tuple[tuple, ...]

_BIT_WEIGHTS = (np.uint32(1) << np.arange(32, dtype=np.uint32))


def pack_mask_np(mask: np.ndarray) -> np.ndarray:
    """(n,) bool -> (ceil(n/32),) uint32, little-endian bit order. Padding
    bits are zero."""
    mask = np.asarray(mask, bool)
    n = mask.shape[0]
    words = (n + 31) // 32
    padded = np.zeros(max(words, 1) * 32, np.uint32)
    padded[:n] = mask.astype(np.uint32)
    return (padded.reshape(-1, 32) * _BIT_WEIGHTS).sum(axis=1, dtype=np.uint32)


def unpack_mask_np(bitmap: np.ndarray, n: int) -> np.ndarray:
    """(W,) uint32 -> (n,) bool, inverse of :func:`pack_mask_np`."""
    bitmap = np.asarray(bitmap, np.uint32)
    bits = (bitmap[:, None] >> np.arange(32, dtype=np.uint32)) & np.uint32(1)
    return bits.reshape(-1)[:n].astype(bool)


def run_program(leaves: np.ndarray, program: Program, xp=np) -> np.ndarray:
    """Evaluate the stack program over leaf bitmaps (K, W). Works for numpy
    uint32 arrays and int32 torch tensors alike (the plain version of the
    CUDA kernel runs it on the latter)."""
    stack = []
    for op in program:
        if op[0] == "leaf":
            stack.append(leaves[op[1]])
        elif op[0] == "and":
            b, a = stack.pop(), stack.pop()
            stack.append(a & b)
        elif op[0] == "or":
            b, a = stack.pop(), stack.pop()
            stack.append(a | b)
        elif op[0] == "not":
            stack.append(~stack.pop())
        else:  # pragma: no cover - compile_query never emits anything else
            raise ValueError(f"unknown opcode {op!r}")
    if len(stack) != 1:
        raise ValueError(f"unbalanced program: {len(stack)} values left on stack")
    return stack.pop()


def combine_bitmaps_ref(leaves: np.ndarray, program: Program) -> Tuple[np.ndarray, int]:
    """Oracle: (bitmap (W,) uint32, popcount). The caller is responsible for
    masking padding bits (the query compiler always ANDs a validity leaf as
    the final program step, which clears anything a NOT resurrected)."""
    leaves = np.asarray(leaves, np.uint32)
    out = run_program(leaves, program)
    count = int(unpack_mask_np(out, out.shape[0] * 32).sum())
    return out, count
