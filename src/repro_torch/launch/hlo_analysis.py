"""The cost of one traced step, read from its op stream.

The reference's counterpart parses a compiled program's partitioned HLO and
multiplies ``while`` bodies by their trip counts. Eager PyTorch has no HLO
and no loops to multiply: every layer, attention tile and scan chunk is run,
so the op stream of one step already holds all of its work. ``OpTrace`` is a
``TorchDispatchMode`` that sits below DTensor (it returns ``NotImplemented``
for DTensor ops, as ``shardings.CollectiveLog`` does, so it sees the local
ops DTensor lowers each op to) and records, for this rank:

  * flops       — ``torch.utils.flop_counter``'s formulas (matmuls,
                  convolutions, attention kernels; elementwise ops count 0,
                  as the reference counts only dot and convolution);
  * bytes       — operand + output bytes of every op but views, dtype
                  converts (the reference's ``_BYTE_SKIP`` skips
                  ``convert``), allocations and collectives;
  * collectives — input bytes by kind, and the bytes of a collective whose
                  group holds ranks both below and at or above 256 (the
                  reference's ``_group_spans_pods``) as cross-pod;
  * live bytes  — storage made by the traced ops, minus storage freed (a
                  ``weakref.finalize`` on each new output storage): its
                  peak is the step's temporaries at their most.

``analyze_trace`` returns the keys of the reference's ``analyze_hlo`` and
``top_collectives`` its rows, the repeat count of an identical collective
standing where the trip multiplier stood. The trace runs the step, so its
tensors may be meta tensors on a fake process group (``launch/dryrun.py``)
or real ones.
"""
from __future__ import annotations

import gc
import weakref
from typing import Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

POD_RANKS = 256  # ranks of one pod: a group spanning rank 255 and 256 crosses pods

_COLL_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
# allocations touch no memory; a dtype convert is fused or native on the target
_BYTE_SKIP = {"empty", "empty_like", "empty_strided", "_to_copy"}
_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16", torch.float64: "f64",
                torch.int64: "s64", torch.int32: "s32", torch.int16: "s16", torch.int8: "s8",
                torch.uint8: "u8", torch.bool: "pred"}


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_ranks(args) -> List[int]:
    """The global ranks of a functional collective's group (its last
    string argument names it)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in reversed(args):
        if isinstance(a, str):
            try:
                return dist.get_process_group_ranks(_resolve_process_group(a))
            except (ValueError, RuntimeError):
                continue
        if isinstance(a, dist.ProcessGroup):
            return dist.get_process_group_ranks(a)
    return []


def shape_name(t: torch.Tensor) -> str:
    return f"{_DTYPE_NAMES.get(t.dtype, str(t.dtype))}[{','.join(map(str, t.shape))}]"


class OpTrace(TorchDispatchMode):
    """Everything ``analyze_trace`` reads, accumulated op by op (no op list
    is kept, so a step of millions of ops traces in constant memory)."""

    _SKIP = ("wait_tensor", "_wrap_tensor_autograd")

    def __init__(self, device: Optional[str] = None) -> None:
        """``device``: record only the ops that touch a tensor of that
        device type (a dry-run's ``"meta"``: DTensor's own index tensors,
        made on the host while it plans a redistribution, are no work of
        the rank); None records every op."""
        super().__init__()
        self.device = device
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.coll: Dict[str, float] = {}
        self.coll_cross = 0.0
        self.collectives: Dict[Tuple[str, str], List[float]] = {}  # (kind, shape) -> [count, bytes each]
        self.live = 0
        self.peak = 0
        self._live_ids: set = set()

    def __enter__(self):
        # storage held by reference cycles is freed when the cyclic collector
        # happens to run: off while tracing, the peak is the same at every
        # run and what reference counting alone frees
        self._gc_was_on = gc.isenabled()
        gc.disable()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if self._gc_was_on:
                gc.enable()

    def _free(self, key: int, n: int) -> None:
        self._live_ids.discard(key)
        self.live -= n

    def _made(self, outs) -> None:
        for t in outs:
            s = t.untyped_storage()
            key = id(s)
            if key in self._live_ids:
                continue
            n = s.nbytes()
            self._live_ids.add(key)
            self.live += n
            weakref.finalize(s, self._free, key, n)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor lower the op to local ops first
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, name = func.namespace, func._overloadpacket.__name__
        tensors = _tensors(out) + _tensors(args) + _tensors(kwargs)
        if name in self._SKIP or any(isinstance(t, FakeTensor) for t in tensors):
            # DTensor's sharding propagation runs the op on fake tensors of
            # the global shape to learn its output's: no work of this rank
            return out
        if self.device is not None and not any(t.device.type == self.device for t in tensors):
            return out
        self.ops += 1
        if ns in ("_c10d_functional", "c10d"):
            t = _tensors(args[0])
            b = sum(_nbytes(x) for x in t)
            kind = _COLL_KINDS.get(name.rstrip("_"), "collective-permute")
            self.coll[kind] = self.coll.get(kind, 0.0) + b
            ranks = _group_ranks(args)
            if ranks and min(ranks) < POD_RANKS <= max(ranks):
                self.coll_cross += b
            row = self.collectives.setdefault((kind, shape_name(t[0]) if t else "?"), [0, b])
            row[0] += 1
            self._made(_tensors(out))
            return out
        from torch.utils.flop_counter import flop_registry

        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += float(formula(*args, **kwargs, out_val=out))
        aliases = [r.alias_info for r in func._schema.returns if r.alias_info is not None]
        if not aliases:  # new storage (a view or an in-place op returns an input's)
            self._made(_tensors(out))
        view = any(not a.is_write for a in aliases)
        if not view and name not in _BYTE_SKIP:
            self.bytes += sum(_nbytes(t) for t in _tensors(args) + _tensors(kwargs) + _tensors(out))
        return out


def analyze_trace(trace: OpTrace) -> Dict[str, object]:
    """The keys of the reference's ``analyze_hlo``: flops, bytes, coll (bytes
    by kind), coll_cross, coll_total, coll_intra."""
    out: Dict[str, object] = {"flops": trace.flops, "bytes": trace.bytes, "coll": dict(trace.coll),
                              "coll_cross": trace.coll_cross}
    out["coll_total"] = float(sum(trace.coll.values()))
    out["coll_intra"] = out["coll_total"] - out["coll_cross"]
    return out


def top_collectives(trace: OpTrace, n: int = 12) -> List[Tuple[float, str, str, int, int]]:
    """Largest collective contributors: [(total_bytes, kind, shape,
    per_op_bytes, count), ...], as the reference's rows with the repeat
    count of an identical (kind, shape) collective for its trip multiplier."""
    rows = [(count * b, kind, shape, int(b), int(count))
            for (kind, shape), (count, b) in trace.collectives.items()]
    return sorted(rows, reverse=True)[:n]
