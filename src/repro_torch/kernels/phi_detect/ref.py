"""Plain PyTorch version of the burned-in-text edge-density kernel
(``csrc/phi_detect.cu``).

Semantics (tile-local by construction, so kernel and plain version agree
exactly): the image is zero-padded up to (th, tw) tile multiples and
partitioned into tiles; within each tile we count strong horizontal
gradients — ``|x[i, j+1] - x[i, j]| >= thresh`` in float32, only for in-tile
neighbour pairs — and return the count over the tile area th * tw (one
float32 division). The padding pixels are pixels: the pair (last real
column, first padding column) is a strong edge when the last column is
bright, as in the JAX package, which pads before its kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch


def to_float32(images: torch.Tensor) -> torch.Tensor:
    """float32 by value: integers go through int64 first, so uint16 values
    of 32768 and up never pass through a signed 16-bit view."""
    if images.dtype.is_floating_point:
        return images.to(torch.float32)
    return images.to(torch.int64).to(torch.float32)


def pad_to_tiles(images: torch.Tensor, tile: Tuple[int, int]) -> torch.Tensor:
    """Zero-pad (N, H, W) up to tile multiples (any dtype)."""
    N, H, W = images.shape
    th, tw = tile
    Hp, Wp = -(-H // th) * th, -(-W // tw) * tw
    if (Hp, Wp) == (H, W):
        return images
    out = images.new_zeros((N, Hp, Wp))
    out[:, :H, :W] = images
    return out


def edge_density_ref(images: torch.Tensor, thresh: float, tile: Tuple[int, int]) -> torch.Tensor:
    """images: (N, H, W); returns (N, ceil(H/th), ceil(W/tw)) float32
    densities in [0, 1]."""
    th, tw = tile
    x = pad_to_tiles(to_float32(images), tile)
    N, H, W = x.shape
    t = x.reshape(N, H // th, th, W // tw, tw)  # tile-local view
    grad = (t[..., 1:] - t[..., :-1]).abs()     # in-tile horizontal gradient
    hits = (grad >= torch.tensor(thresh, dtype=torch.float32)).sum(dim=(2, 4), dtype=torch.int32)
    # the area as a tensor on the hits' device: PyTorch's CUDA division by a
    # CPU scalar multiplies by its reciprocal, one ulp off the quotient
    area = torch.tensor(float(th * tw), dtype=torch.float32, device=hits.device)
    return hits.to(torch.float32) / area


def phi_flags_ref(images: torch.Tensor, thresh: float, tile: Tuple[int, int], tau: float) -> torch.Tensor:
    return edge_density_ref(images, thresh, tile) >= torch.tensor(tau, dtype=torch.float32)
