"""The layouts the fused kernel's strips of 16-byte chunks meet, one table
for every comparison of the kernel with its plain version (the card's
tests, the CPU parity tests against the JAX package, ``chip_smoke.py``'s
phase 2).

A batch is cut as ``[offset:offset + N]`` from ``N + 1`` planes, so offset 1
starts off a 16-byte boundary wherever a plane is no 16-byte multiple.
Rows that are no 16-byte multiple (70 and 90 uint8, 2022 uint16, 257)
take the kernel's pixel-load path; 128- and 648-pixel rows its vector path
(648 is the unknown DX's width). H = 1 has no row above, W = 1 no left
neighbour, and 37 rows end inside a thread's strip of 8. Image i takes rect
set i in turn: rect x-edges at chunk boundaries +-1 and ends that wrap
int32 (``scrub/cases.py::edge_rects``), a padding rect, the full frame.
Every selection value runs on every layout.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.scrub.cases import RECT_SETS

DTYPES = (np.uint8, np.uint16)
SHAPES = ((3, 70, 90), (3, 6, 2022), (4, 37, 128), (2, 20, 648), (3, 1, 300), (3, 70, 1),
          (2, 9, 257))
OFFSETS = (0, 1)
SVS = tuple(range(1, 8))


def planes(rng: np.random.Generator, dtype, shape) -> np.ndarray:
    """``N + 1`` full-range planes for a batch of ``shape`` = (N, H, W), to
    be cut at an offset (uint16 samples >= 32768 included)."""
    N, H, W = shape
    return rng.integers(0, np.iinfo(dtype).max + 1, size=(N + 1, H, W)).astype(dtype)


def rect_lists(N: int, H: int, W: int) -> list:
    """Image i's rects: the i-th rect set of ``scrub/cases.py`` in turn."""
    sets = list(RECT_SETS.values())
    return [sets[i % len(sets)](H, W) for i in range(N)]
