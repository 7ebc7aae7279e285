"""Gradient compression for data-parallel training, with error feedback.

Two standard compressors, both with **error feedback**: the compression
error of a step is carried in a residual and added to the next step's
gradient instead of being lost (Seide et al. / Karimireddy et al.):

* ``int8`` — per-tensor symmetric quantization: 4x fewer bytes on the wire;
* ``topk`` — magnitude sparsification to a ``k_frac`` of the entries.

Plain tensor ops on the gradient's device; they compose with any optimizer.
The wire format is (payload, scale or indices) pairs. ``torch.round``
rounds half to even, as ``jnp.round`` does, so int8 payloads are those of
the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class CompressionState(NamedTuple):
    """Error-feedback residual, one per compressed tensor."""

    residual: torch.Tensor

    @staticmethod
    def init(shape, dtype=torch.float32, device=None) -> "CompressionState":
        return CompressionState(torch.zeros(shape, dtype=dtype, device=device))


# ------------------------------------------------------------------- int8
def int8_compress(
    grad: torch.Tensor, state: CompressionState
) -> Tuple[torch.Tensor, torch.Tensor, CompressionState]:
    """-> (int8 payload, f32 scale, new state). Wire bytes: n + 4."""
    g = grad + state.residual
    scale = torch.clamp_min(torch.amax(torch.abs(g)), 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return q, scale, CompressionState(g - deq)


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


# ------------------------------------------------------------------- top-k
def topk_compress(
    grad: torch.Tensor, state: CompressionState, k_frac: float = 0.01
) -> Tuple[torch.Tensor, torch.Tensor, CompressionState]:
    """-> (values, flat indices, new state). Wire bytes: k*(4+4). Ties in
    magnitude may be ordered differently from ``jax.lax.top_k``."""
    g = grad + state.residual
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * k_frac))
    _, idx = torch.topk(torch.abs(flat), k)
    sel = flat[idx]
    kept = torch.zeros_like(flat).index_put_((idx,), sel).reshape(g.shape)
    return sel, idx, CompressionState(g - kept)


def topk_decompress(vals: torch.Tensor, idx: torch.Tensor, shape, size: int) -> torch.Tensor:
    return torch.zeros((size,), dtype=vals.dtype, device=vals.device).index_put_((idx,), vals).reshape(shape)


# ------------------------------------------------- all-reduce composition
def _group(group_or_mesh_axis):
    """A process group from a group, a 1-D ``DeviceMesh`` or a
    ``(DeviceMesh, axis name)`` pair; None is the default group."""
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(group_or_mesh_axis, tuple):
        mesh, axis = group_or_mesh_axis
        return mesh.get_group(axis)
    if isinstance(group_or_mesh_axis, DeviceMesh):
        return group_or_mesh_axis.get_group()
    return group_or_mesh_axis


def compressed_psum_int8(grad: torch.Tensor, state: CompressionState, group_or_mesh_axis=None):
    """int8-compress locally, all-reduce the dequantized payload over the
    group (a mesh axis), return (mean, new state). The sum is taken with
    ``ReduceOp.SUM`` and divided by the group's size (gloo has no ``AVG``).
    The collective moves the dequantized float32 payload, as the
    reference's does under XLA on the CPU."""
    import torch.distributed as dist

    q, scale, new_state = int8_compress(grad, state)
    deq = int8_decompress(q, scale)
    group = _group(group_or_mesh_axis)
    dist.all_reduce(deq, op=dist.ReduceOp.SUM, group=group)
    return deq / dist.get_world_size(group), new_state
