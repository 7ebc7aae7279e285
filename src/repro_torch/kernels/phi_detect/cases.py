"""The layouts the phi_detect kernel's 16-byte chunks and right-neighbour
shuffles meet, one table for every comparison of the kernel with its plain
version (the card's tests, the CPU parity tests against the JAX package,
``chip_smoke.py``'s phase 2).

The audit's one-image shapes (320x512 CT, 520x648 DX: ragged right and
bottom edges at the (32, 128) tile) and a 32-image batch; a batch is cut as
``[offset:offset + N]`` from ``N + 1`` planes, so offset 1 of the 70x301
planes starts off a 16-byte boundary. Tiles (16, 64) and (24, 100) (no
vector multiple: short chunks, tile rows across warps); every pixel type;
the float32 threshold straddle 2457.0001 and thresh 0 (hits in the zero
padding).
"""
from __future__ import annotations

import numpy as np

DTYPES = (np.uint8, np.uint16, np.int16, np.int32, np.float32)
SHAPES = ((1, 320, 512), (1, 520, 648), (4, 70, 301), (32, 64, 130))
OFFSETS = (0, 1)
TILES = ((32, 128), (16, 64), (24, 100))


def top(dtype) -> int:
    return 255 if dtype == np.uint8 else 4095


def threshes(dtype) -> tuple:
    return (2457.0001, 0.0, top(dtype) * 0.25)


def planes(rng: np.random.Generator, dtype, shape) -> np.ndarray:
    """``N + 1`` planes for a batch of ``shape`` = (N, H, W), to be cut at an
    offset: random values (negative ones in the signed types), a band of
    strokes at full value every third column, and a bright last column
    (whose pair with the first padding column is a strong edge)."""
    N, H, W = shape
    hi = top(dtype)
    lo = -hi if dtype in (np.int16, np.int32) else 0
    base = rng.integers(lo, hi + 1, size=(N + 1, H, W)).astype(dtype)
    base[:, 8:30, 40::3] = hi
    base[:, :, -1] = hi
    return base
