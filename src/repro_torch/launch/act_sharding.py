"""Activation-sharding constraints threaded into model code.

Model code calls ``constrain(x, "residual")`` at block boundaries. Outside
an :func:`activation_sharding` context, and on a plain tensor, this is a
no-op. Inside one, a DTensor is redistributed to the rule's placements:
the residual stream pinned to the Megatron-SP layout (sequence sharded
over 'model' between blocks), heads sharded inside attention, and so on
(``launch/shardings.activation_rules``).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

_RULES: contextvars.ContextVar[Optional[Dict[str, object]]] = contextvars.ContextVar(
    "act_sharding_rules", default=None
)


@contextlib.contextmanager
def activation_sharding(rules: Dict[str, object]):
    token = _RULES.set(rules)
    try:
        yield
    finally:
        _RULES.reset(token)


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    rules = _RULES.get()
    if not rules or name not in rules or rules[name] is None or not isinstance(x, DTensor):
        return x
    sharding = rules[name]
    if len(sharding.spec) != x.ndim:
        # rank mismatch (e.g. decode-path rank-2 activations vs the rank-3
        # train/prefill rule): constraints are layout hints, skip quietly
        return x
    placements = sharding.placements()
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(sharding.mesh, placements)


# ------------------------------------------------------ reshapes of heads
def _gather_unaligned(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` with every mesh axis that shards ``dim`` and does not divide
    ``n`` gathered. DTensor cannot split a sharded dim into pieces that
    straddle ranks (GSPMD reshards the same reshape)."""
    if not isinstance(x, DTensor):
        return x
    mesh, placements = x.device_mesh, list(x.placements)
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim and n % mesh.size(i):
            placements[i] = Replicate()
    return x.redistribute(mesh, placements) if placements != list(x.placements) else x


def split_dim(x: torch.Tensor, dim: int, sizes: Sequence[int]) -> torch.Tensor:
    """``x`` with ``dim`` split into ``sizes`` (heads x head dim, KV x G)."""
    dim %= x.ndim
    x = _gather_unaligned(x, dim, sizes[0])
    return x.reshape(tuple(x.shape[:dim]) + tuple(sizes) + tuple(x.shape[dim + 1:]))


def merge_dims(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with ``dim`` and the dim after it merged into one."""
    dim %= x.ndim
    x = _gather_unaligned(x, dim, x.shape[dim])
    x = _gather_unaligned(x, dim + 1, 1)
    return x.reshape(tuple(x.shape[:dim]) + (-1,) + tuple(x.shape[dim + 2:]))


# ------------------------------------------ explicit TP on local shards
def row_layout(x: DTensor) -> tuple:
    """x's layout with each row whole on its ranks: the batch sharding
    (dim 0) kept, every other mesh axis replicated."""
    return tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in x.placements)


class ModelAxis:
    """Tensor parallelism over the mesh's ``model`` axis written out, for
    code that DTensor cannot run (depthwise convolutions, selective scans,
    and batched einsums whose views it refuses on a sharded dim): it runs on
    local shards, each rank holding whole rows of its batch shard (batch at
    dim 0) and its own slice of the channels, and the collectives are the
    calls below. ``x`` gives the mesh and the batch layout."""

    def __init__(self, x: DTensor) -> None:
        self.mesh = x.device_mesh
        self.rows = row_layout(x)
        self.batch = x.shape[0]
        self.m = list(self.mesh.mesh_dim_names).index("model")

    def layout(self, dim: Optional[int]) -> tuple:
        """The row layout with ``dim`` sharded over ``model`` (None: whole)."""
        out = list(self.rows)
        if dim is not None:
            out[self.m] = Shard(dim)
        return tuple(out)

    def whole_rows(self, t: DTensor) -> torch.Tensor:
        """This rank's rows of ``t``, every column (gathers over ``model``)."""
        if tuple(t.placements) != self.rows:
            t = t.redistribute(self.mesh, self.rows)
        return t.to_local()

    def local(self, t: DTensor, dim: int) -> torch.Tensor:
        """This rank's shard of an activation or cache laid out by
        ``layout(dim)`` (brought to it if it is not)."""
        want = self.layout(dim)
        if tuple(t.placements) != want:
            t = t.redistribute(self.mesh, want)
        return t.to_local()

    def param(self, t: torch.Tensor, dim: Optional[int]) -> Tuple[torch.Tensor, int, int]:
        """(local shard, start, stop along ``dim``) of a parameter sharded
        over ``model`` alone at ``dim`` (None: replicated). Any other layout
        is refused: it would take a gather of the parameter."""
        want = tuple(Replicate() if i != self.m or dim is None else Shard(dim)
                     for i in range(self.mesh.ndim))
        if tuple(t.placements) != want:
            raise ValueError(f"parameter laid out as {t.placements}, expected {want} "
                             "(place the model with fsdp=False)")
        if dim is None:
            return t.to_local(), 0, 0
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        local, offset = compute_local_shape_and_global_offset(t.shape, self.mesh, want)
        return t.to_local(), offset[dim], offset[dim] + local[dim]

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t`` over ``model`` (an all-reduce)."""
        return self.whole_rows(self.wrap(t, partial=True))

    def batch_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks that hold other rows of the batch
        (an all-reduce over the batch's axes)."""
        part = [Partial() if isinstance(p, Shard) else Replicate() for p in self.rows]
        whole = [Replicate()] * len(part)
        return DTensor.from_local(t, self.mesh, part, run_check=False).redistribute(self.mesh, whole).to_local()

    def gather(self, t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
        """Every rank's ``t`` (sharded over ``model`` at ``dim``, ``size``
        in all) joined along ``dim`` (an all-gather)."""
        return self.whole_rows(self.wrap(t, dim, size))

    def wrap(self, t: torch.Tensor, dim: Optional[int] = None, size: Optional[int] = None,
             partial: bool = False) -> DTensor:
        """A local result (batch at dim 0) as a DTensor: sharded over
        ``model`` at ``dim`` (``size`` the global extent there), or pending a
        sum over ``model`` (``partial``), or whole."""
        placements = list(self.layout(dim))
        if partial:
            placements[self.m] = Partial()
        shape = [self.batch] + list(t.shape[1:])
        if dim is not None:
            shape[dim] = size
        stride, n = [], 1
        for extent in reversed(shape):
            stride.insert(0, n)
            n *= extent
        return DTensor.from_local(t, self.mesh, placements, run_check=False, shape=torch.Size(shape),
                                  stride=tuple(stride))
