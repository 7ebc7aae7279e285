"""Activation-sharding constraints threaded into model code.

Model code calls ``constrain(x, "residual")`` at block boundaries. Outside
an :func:`activation_sharding` context, and on a plain tensor, this is a
no-op. Inside one, a DTensor is redistributed to the rule's placements:
the residual stream pinned to the Megatron-SP layout (sequence sharded
over 'model' between blocks), heads sharded inside attention, and so on
(``launch/shardings.activation_rules``).

Also here: the layout arithmetic of a rank's block (``local_block``, which
needs no tensor), the residual add that takes a block output's pending sum
once (``add_residual``), the FSDP gather at a weight's use
(``gather_batch_axes``), the contexts a checkpointed body carries into its
recompute (``captured``), and ``ModelAxis`` for code run on local shards.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

_RULES: contextvars.ContextVar[Optional[Dict[str, object]]] = contextvars.ContextVar(
    "act_sharding_rules", default=None
)


@contextlib.contextmanager
def activation_sharding(rules: Optional[Dict[str, object]]):
    token = _RULES.set(rules)
    try:
        yield
    finally:
        _RULES.reset(token)


@contextlib.contextmanager
def implicitly_replicated(on: bool = True):
    """DTensor's implicit replication of plain tensors (``implicit_replication``)
    set to ``on``, and restored on exit to what it was, so that it nests."""
    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = on or before
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def captured(fn: Callable, *, placed: bool) -> Callable:
    """``fn`` run, whenever it is called, under the activation rules in force
    now and (``placed``) DTensor's implicit replication: for a checkpointed
    body, whose recompute runs in the backward pass, outside the contexts
    of the forward and perhaps on the autograd engine's device thread."""
    rules = _RULES.get()

    def run(*args):
        with activation_sharding(rules), implicitly_replicated(placed):
            return fn(*args)

    return run


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


def add_residual(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x + y`` for a block's output ``y`` that may be pending a sum over a
    mesh axis (a row-sharded projection's): the sum is taken once, into the
    residual stream's layout on that axis (an all-reduce, or under sequence
    parallelism a reduce-scatter), where GSPMD takes it, and not left
    pending for each later use to reduce again."""
    if isinstance(y, DTensor) and any(p.is_partial() for p in y.placements):
        like = x.placements if isinstance(x, DTensor) and x.ndim == y.ndim else [Replicate()] * y.device_mesh.ndim
        want = []
        for p, q in zip(y.placements, like):
            if p.is_partial():
                p = Replicate() if q.is_partial() else q
            want.append(p)
        y = y.redistribute(y.device_mesh, tuple(want))
    return x + y


# ---------------------------------------------------------- shard blocks
def contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape`` (no tensor made)."""
    stride, n = [], 1
    for extent in reversed(tuple(shape)):
        stride.insert(0, n)
        n *= extent
    return tuple(stride)


def local_block(shape: Sequence[int], mesh, placements) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(local shape, global offset) of this rank's block of a tensor of
    ``shape`` laid out by ``placements`` on ``mesh``: torch's chunk rule
    (chunks of ceil(n / k), the last ones short or empty; an empty block's
    offset is the dim's extent), the mesh dims applied in order. Integer
    arithmetic on the rank's mesh coordinate, so it runs under fake tensors,
    where ``compute_local_shape_and_global_offset`` reads a tensor."""
    coord = mesh.get_coordinate()
    local, offset = list(shape), [0] * len(shape)
    for i, p in enumerate(placements):
        if not isinstance(p, Shard):
            continue
        d, n = p.dim, local[p.dim]
        full = -(-n // mesh.size(i))
        start = full * coord[i]
        size = max(0, min(n, start + full) - start)
        local[d] = size
        offset[d] = offset[d] + start if size else shape[d]
    return tuple(local), tuple(offset)


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
def gather_batch_axes(t: torch.Tensor) -> torch.Tensor:
    """A parameter with every mesh axis but ``model`` that shards it gathered
    (an all-gather; in backward, the reduce-scatter of its gradient): the
    gather GSPMD inserts at the use of an FSDP-sharded weight. A plain
    tensor, or one sharded over ``model`` alone, is returned as it is."""
    if not isinstance(t, DTensor):
        return t
    names = t.device_mesh.mesh_dim_names
    want = tuple(Replicate() if isinstance(p, Shard) and names[i] != "model" else p
                 for i, p in enumerate(t.placements))
    return t.redistribute(t.device_mesh, want) if want != tuple(t.placements) else t


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

    def whole_rows(self, t: DTensor, partial_grad: bool = False) -> torch.Tensor:
        """This rank's rows of ``t``, every column (gathers over ``model``).
        ``partial_grad``: the rank uses them in its own way (its slice of
        the channels or heads), so the local result's gradient is pending a
        sum over ``model`` (the backward all-reduces or reduce-scatters it);
        without, every rank uses them alike and its gradient is whole."""
        if tuple(t.placements) != self.rows:
            t = t.redistribute(self.mesh, self.rows)
        if not partial_grad:
            return t.to_local()
        grad = list(self.rows)
        grad[self.m] = Partial()
        return t.to_local(grad_placements=tuple(grad))

    def local(self, t: DTensor, dim: int) -> torch.Tensor:
        """This rank's shard of an activation or cache laid out by
        ``layout(dim)`` (brought to it if it is not)."""
        want = self.layout(dim)
        if tuple(t.placements) != want:
            t = t.redistribute(self.mesh, want)
        return t.to_local()

    def param(self, t: torch.Tensor, dim: Optional[int]) -> Tuple[torch.Tensor, int, int]:
        """(local shard, start, stop along ``dim``) of a parameter sharded
        over ``model`` at ``dim`` (None: replicated). An FSDP shard over the
        batch axes is gathered first (``gather_batch_axes``); any other
        layout over ``model`` is refused: it would take a gather of the
        parameter over ``model``."""
        t = gather_batch_axes(t)
        want = tuple(Replicate() if i != self.m or dim is None else Shard(dim)
                     for i in range(self.mesh.ndim))
        if tuple(t.placements) != want:
            raise ValueError(f"parameter laid out as {t.placements}, expected {want}")
        # each rank applies it to its own rows: its gradient is pending a
        # sum over the batch's axes
        grad = tuple(Partial() if isinstance(r, Shard) else w for r, w in zip(self.rows, want))
        local = t.to_local(grad_placements=grad)
        if dim is None:
            return local, 0, 0
        size, offset = local_block(t.shape, self.mesh, want)
        return local, offset[dim], offset[dim] + size[dim]

    def psum(self, t: torch.Tensor, partial_grad: bool = False) -> torch.Tensor:
        """The sum of every rank's ``t`` over ``model`` (an all-reduce);
        ``partial_grad`` as in ``whole_rows``."""
        return self.whole_rows(self.wrap(t, partial=True), partial_grad)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """The largest of every rank's ``t`` over ``model`` (an all-reduce)."""
        return self.whole_rows(self.wrap(t, partial="max"))

    def batch_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks that hold other rows of the batch
        (an all-reduce over the batch's axes)."""
        part = [Partial() if isinstance(p, Shard) else Replicate() for p in self.rows]
        whole = [Replicate()] * len(part)
        return DTensor.from_local(t, self.mesh, part, run_check=False).redistribute(self.mesh, whole).to_local()

    def gather(self, t: torch.Tensor, dim: int, size: int, partial_grad: bool = False) -> torch.Tensor:
        """Every rank's ``t`` (sharded over ``model`` at ``dim``, ``size``
        in all) joined along ``dim`` (an all-gather); ``partial_grad`` as in
        ``whole_rows``."""
        return self.whole_rows(self.wrap(t, dim, size), partial_grad)

    def wrap(self, t: torch.Tensor, dim: Optional[int] = None, size: Optional[int] = None,
             partial=False) -> DTensor:
        """A local result (batch at dim 0) as a DTensor: sharded over
        ``model`` at ``dim`` (``size`` the global extent there), or pending a
        reduction over ``model`` (``partial``: True for a sum, or the
        reduction's name), or whole."""
        placements = list(self.layout(dim))
        if partial:
            placements[self.m] = Partial() if partial is True else Partial(partial)
        shape = [self.batch] + list(t.shape[1:])
        if dim is not None:
            shape[dim] = size
        return DTensor.from_local(t, self.mesh, placements, run_check=False, shape=torch.Size(shape),
                                  stride=contiguous_stride(shape))
