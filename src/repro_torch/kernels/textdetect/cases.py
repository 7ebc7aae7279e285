"""The layouts the textdetect kernel's 16-byte chunks, chunk words and
row folds meet, one table for every comparison of the kernel with its
plain version (the card's tests, the CPU parity tests against the JAX
package, ``chip_smoke.py``'s phase 2).

A batch is cut as ``[offset:offset + N]`` from ``N + 1`` planes, so offset 1
starts off a 16-byte boundary wherever a plane is no 16-byte multiple; 90-
and 257-pixel rows are no 16-byte multiple in any pixel type. H = 1, W = 1
and W = 257 are the edges; 2100 columns take the (32, 2048) tile past one
group of 32 chunks. Tiles (24, 100) (no chunk multiple: short chunks, tiles
off a 16-byte boundary), (32, 128) (the detector's default), (32, 2048)
and (1, 1) (128 tiles a block). Every plane has a tile row of hits, runs
of hits across chunks, lanes and groups of lanes, and 1-px strokes; the
ragged frame also runs at thresh 0 and below (hits in the zero padding).
"""
from __future__ import annotations

import numpy as np

DTYPES = (np.uint8, np.uint16, np.int16, np.int32, np.float32)
SHAPES = ((2, 70, 90), (1, 1, 300), (2, 70, 1), (2, 9, 257), (1, 40, 2100))
OFFSETS = (0, 1)
TILES = ((24, 100), (32, 128), (32, 2048), (1, 1))
RAGGED = (2, 70, 90)


def top(dtype) -> int:
    return 255 if dtype == np.uint8 else 4095


def threshes(dtype, shape) -> tuple:
    """The straddle (2457.0001 is 2457.0f in float32; 153 for uint8), and on
    the ragged frame thresh 0 and -3.5 as well."""
    t = 153.0 if dtype == np.uint8 else 2457.0001
    return (t, 0.0, -3.5) if tuple(shape) == RAGGED else (t,)


def planes(rng: np.random.Generator, dtype, shape) -> np.ndarray:
    """``N + 1`` planes for a batch of ``shape`` = (N, H, W), to be cut at an
    offset: random values (negative ones in the signed types), row 3 all at
    full value, a run of 65 full values in row 5, one of 100 across column
    1024 in row 36 (where a (32, 2048) tile row passes from one group of 32
    words to the next, in a tile row of no full row) and strokes every
    third column in rows 8-29."""
    N, H, W = shape
    hi = top(dtype)
    lo = -hi if dtype in (np.int16, np.int32) else 0
    base = rng.integers(lo, hi + 1, size=(N + 1, H, W)).astype(dtype)
    base[:, 3:4, :] = hi
    base[:, 5:6, 5:70] = hi
    base[:, 36:37, 1000:1100] = hi
    base[:, 8:30, 40::3] = hi
    return base
