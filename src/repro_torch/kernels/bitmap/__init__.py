"""Packed-bitmap predicate combine + popcount kernel (catalog query engine).

The catalog's vectorized query path evaluates leaf predicates into packed
bitmaps (one bit per row, int32 words holding the uint32 pattern) and hands
the boolean combine to ``csrc/bitmap.cu``, which runs the compiled stack
program and popcounts the result in one pass. ``ref.py`` is the numpy
oracle; ``ops.combine_bitmaps_torch`` the plain PyTorch version.
"""
from repro_torch.kernels.bitmap.ops import (
    combine_bitmaps,
    combine_bitmaps_torch,
    pack_mask,
    unpack_mask,
)
from repro_torch.kernels.bitmap.ref import combine_bitmaps_ref, pack_mask_np, unpack_mask_np

__all__ = [
    "combine_bitmaps",
    "combine_bitmaps_ref",
    "combine_bitmaps_torch",
    "pack_mask",
    "pack_mask_np",
    "unpack_mask",
    "unpack_mask_np",
]
