"""The layouts the scrub kernel's 16-byte chunks meet, one table for every
comparison of the kernel with its plain version (the card's tests, the CPU
parity tests against the JAX package, ``chip_smoke.py``'s phase 2).

A batch is cut as ``[offset:offset + N]`` from ``N + 1`` planes, so offset 1
starts off a 16-byte boundary wherever a plane is no 16-byte multiple (the
kernel's scalar head). Rows that are no 16-byte multiple (2022 uint16, 70
and 90 uint8) put chunks across row ends, planes that are no chunk multiple
leave a scalar tail, and (3, 2, 5) is a plane smaller than one chunk.
"""
from __future__ import annotations

import numpy as np
import torch

DTYPES = (np.uint8, np.uint16, np.float32, np.int64)  # item sizes 1, 2, 4, 8
SHAPES = ((3, 70, 90), (3, 6, 2022), (3, 70, 70), (3, 2, 5), (33, 37, 91))
OFFSETS = (0, 1)
# an integer type of each item size: results are compared bit for bit
SAME_WIDTH_INT = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def edge_rects(H: int, W: int) -> list:
    """Rect x-edges at vector offsets 7/8/9 and 15/16/17 (16-byte chunks of
    uint8) and at 8-pixel chunk ends (uint16), negative origins, an end
    that wraps int32, one that wraps to -1, one past the right edge."""
    return [(7, 0, 2, H), (9, 1, 6, 2), (15, 2, 2, 3), (16, 3, 1, 1), (17, 0, W, 1),
            (8, 4, 8, 2), (-5, -5, 12, 12), (2**31 - 5, 0, 10, H), (-2**31, 1, 2**31 - 1, 2),
            (W - 9, 5, 100, 3)]


RECT_SETS = {
    "none": lambda H, W: [],
    "edges": edge_rects,
    "R=1 padding": lambda H, W: [(3, 3, 0, 5)],
    "full frame": lambda H, W: [(0, 0, W, H)],
}


def planes(rng: np.random.Generator, dtype, shape) -> np.ndarray:
    """``N + 1`` planes of random 16-bit values in ``dtype`` for a batch of
    ``shape`` = (N, H, W), to be cut at an offset."""
    N, H, W = shape
    return rng.integers(0, 1 << 16, size=(N + 1, H, W)).astype(dtype)
