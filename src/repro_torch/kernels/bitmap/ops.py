"""Public wrapper for the bitmap combine kernel (``csrc/bitmap.cu``).

Bitmaps at this surface are int32 tensors holding the uint32 bit pattern:
torch refuses shifts and ``~`` on ``torch.uint32`` and has no popcount, so
the kernel reads the int32 words as ``const uint32_t*`` and only host numpy
views them as uint32 (:func:`unpack_mask`). Bit ``b`` of word ``w`` is row
``32 * w + b``, the layout of ``ref.pack_mask_np``.

:func:`combine_bitmaps` launches the CUDA kernel on a CUDA tensor (or
raises) and runs the plain version (:func:`combine_bitmaps_torch`) on a CPU
tensor. The kernel takes a program of at most ``program_limits()`` ops and
stack depth, read from its library; :func:`schedule_program` fits any
well-formed program into launches of that size, so the card takes every
program the reference takes. A malformed program (an unknown opcode, a pop
from an empty stack, more than one value left, a leaf index past K) raises
``ValueError``, as the C entry point refuses it too.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import count_launch
from repro_torch.kernels._launch import check_cuda, raise_on_error, require_tensor, stream_of
from repro_torch.kernels.bitmap.ref import Program, run_program, unpack_mask_np
from repro_torch.kernels.build import bind, library

# opcodes of csrc/bitmap.cu; a name outside this table reaches the entry
# point as -1, which it refuses
OPCODES = {"leaf": 0, "and": 1, "or": 2, "not": 3}


def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """(n,) bool tensor -> (max(ceil(n/32), 1),) int32 words on its device.

    The weighted sum is taken in int64 (a word's value is below 2^32) and
    wrapped to int32 explicitly, so no out-of-range cast is relied on."""
    mask = require_tensor("pack_mask", mask)
    n = mask.shape[0]
    words = max((n + 31) // 32, 1)
    padded = torch.zeros(words * 32, dtype=torch.int64, device=mask.device)
    padded[:n] = mask.to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=mask.device) << torch.arange(
        32, dtype=torch.int64, device=mask.device)
    value = (padded.view(words, 32) * weights).sum(dim=1)
    return torch.where(value >= 1 << 31, value - (1 << 32), value).to(torch.int32)


def unpack_mask(bitmap: torch.Tensor, n: int) -> np.ndarray:
    """(W,) int32 words -> host (n,) bool."""
    return unpack_mask_np(bitmap.cpu().numpy().view(np.uint32), n)


def popcount_torch(words: torch.Tensor) -> torch.Tensor:
    """Set bits of int32 words as a 0-dim int64 tensor on their device: a
    32-step ``(x >> b) & 1`` sum, right for int32 under the arithmetic shift
    (bit b is read before the sign bits)."""
    total = torch.zeros((), dtype=torch.int64, device=words.device)
    for b in range(32):
        total += ((words >> b) & 1).sum(dtype=torch.int64)
    return total


def combine_bitmaps_torch(leaves: torch.Tensor, program: Program) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``ref.run_program`` over the int32 leaf rows, and the
    popcount of the result as a 0-dim int64 tensor."""
    out = run_program(leaves, program).clone()
    return out, popcount_torch(out)


class _Node:
    """A node of a program's tree: its ops once emitted (``size``) and the
    stack depth its Sethi-Ullman order needs (``label``)."""

    __slots__ = ("op", "leaf", "kids", "size", "label")

    def __init__(self, op: str, leaf: int = 0, kids: tuple = ()):
        self.op, self.leaf, self.kids = op, leaf, kids
        self.size = 1 + sum(k.size for k in kids)
        if not kids:
            self.label = 1
        elif len(kids) == 1:
            self.label = kids[0].label
        else:
            a, b = kids[0].label, kids[1].label
            self.label = a + 1 if a == b else max(a, b)


def _emit(root: _Node) -> Program:
    """The stack program of a tree, each AND/OR's deeper operand first (the
    left one on a tie): its stack depth is the root's label. Iterative, as a
    chain of thousands of ops nests as deep."""
    out, todo = [], [(root, False)]
    while todo:
        node, done = todo.pop()
        if node.op == "leaf":
            out.append(("leaf", node.leaf))
        elif done:
            out.append((node.op,))
        else:
            kids = node.kids
            if len(kids) == 2 and kids[1].label > kids[0].label:
                kids = kids[::-1]
            todo.append((node, True))
            todo.extend((k, False) for k in reversed(kids))
    return tuple(out)


def schedule_program(program: Program, max_ops: int, k: int) -> list[Program]:
    """Fit a stack program over leaf rows ``0 .. k - 1`` into launches of at
    most ``max_ops`` ops each (``max_ops >= 3``).

    The program is parsed into its tree and each launch is emitted in
    Sethi-Ullman order: every AND/OR's deeper operand first, which AND and OR
    allow, being commutative on bits, and NOT where it stands. A launch of L
    leaf ops then needs a stack depth of at most floor(log2 L) + 1. A tree
    larger than ``max_ops`` is cut into subtrees, bottom up, each cut taking
    the larger operand: launch ``j`` before the last computes its subtree
    into scratch row ``k + j``, which later launches read as a leaf. The last
    launch holds the root, so the terminal validity AND stays its last op.
    Raises ``ValueError`` on a malformed program."""
    if max_ops < 3:
        raise ValueError(f"bitmap program: a launch must take at least 3 ops, not {max_ops}")
    launches: list[Program] = []
    stack: list[_Node] = []
    for pos, op in enumerate(program):
        name = op[0] if op else None
        if name == "leaf":
            if not 0 <= op[1] < k:
                raise ValueError(f"bitmap program: leaf {op[1]} at op {pos} is not one of {k} rows")
            stack.append(_Node("leaf", int(op[1])))
            continue
        arity = {"and": 2, "or": 2, "not": 1}.get(name)
        if arity is None:
            raise ValueError(f"bitmap program: unknown opcode {op!r} at op {pos}")
        if len(stack) < arity:
            raise ValueError(f"bitmap program: {name!r} at op {pos} pops an empty stack")
        kids = stack[-arity:]
        del stack[-arity:]
        node = _Node(name, kids=tuple(kids))
        while node.size > max_ops:
            big = max(range(arity), key=lambda c: kids[c].size)
            launches.append(_emit(kids[big]))
            kids[big] = _Node("leaf", k + len(launches) - 1)
            node = _Node(name, kids=tuple(kids))
        stack.append(node)
    if len(stack) != 1:
        raise ValueError(f"bitmap program: {len(stack)} values left on the stack, not 1")
    launches.append(_emit(stack[0]))
    return launches


def program_depth(program: Program) -> int:
    """The most values a well-formed program holds on its stack at once."""
    depth = most = 0
    for op in program:
        depth += {"leaf": 1, "and": -1, "or": -1}.get(op[0], 0)
        most = max(most, depth)
    return most


def run_schedule(leaves: torch.Tensor, schedule,
                 launch) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the launches of :func:`schedule_program` over (K, W) leaves.

    ``launch(table, entry, out, final)`` evaluates the schedule's ``entry``
    over the rows of ``table`` into the (W,) tensor ``out`` and, when
    ``final``, returns the count. With more than one launch the rows live in
    a (K + launches - 1, W) table that starts as a copy of the leaves; launch
    j before the last fills its row K + j. Returns (bitmap, count)."""
    K, W = leaves.shape
    table = leaves
    if len(schedule) > 1:
        table = torch.empty((K + len(schedule) - 1, W), dtype=leaves.dtype, device=leaves.device)
        table[:K] = leaves
    for j, entry in enumerate(schedule[:-1]):
        launch(table[:K + j], entry, table[K + j], False)
    out = torch.empty(W, dtype=leaves.dtype, device=leaves.device)
    return out, launch(table, schedule[-1], out, True)


def combine_scheduled_torch(leaves: torch.Tensor,
                            schedule: list[Program]) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of a scheduled program: each launch through
    ``ref.run_program``; (bitmap, 0-dim int64 count)."""
    def launch(table, prog, out, final):
        out.copy_(run_program(table, prog))
        return popcount_torch(out) if final else None

    return run_schedule(leaves, schedule, launch)


_LIMITS: dict = {}


def program_limits() -> tuple[int, int]:
    """(max ops, max stack depth) of one launch of the CUDA kernel, read
    from its library (once a library)."""
    lib = library("bitmap")
    if lib._name not in _LIMITS:
        limits = []
        for fn in (lib.bitmap_max_ops, lib.bitmap_max_depth):
            fn.argtypes, fn.restype = [], ctypes.c_int
            limits.append(fn())
        _LIMITS[lib._name] = (limits[0], limits[1])
    return _LIMITS[lib._name]


@functools.lru_cache(maxsize=256)
def _plan(program: Program, max_ops: int, k: int) -> tuple:
    """The launches of ``schedule_program``, each as (program, opcodes,
    leaf rows), the two as C int arrays. Cached: on the card's host this
    work took longer than the kernel it feeds (PERF.md §6), and a repeated
    query does it once."""
    plan = []
    for prog in schedule_program(program, max_ops, k):
        n = len(prog)
        ops = (ctypes.c_int * n)(*[OPCODES.get(op[0], -1) for op in prog])
        args = (ctypes.c_int * n)(*[int(op[1]) if op[0] == "leaf" else 0 for op in prog])
        plan.append((prog, ops, args))
    return tuple(plan)


def _launch(table: torch.Tensor, launch: tuple, out: torch.Tensor, final: bool):
    """One launch of ``csrc/bitmap.cu``, a (program, opcodes, leaf rows)
    entry of :func:`_plan`, over the rows of ``table`` into ``out``; the (1,)
    int64 count on the card when ``final``."""
    K, W = table.shape
    prog, ops, args = launch
    count = torch.zeros(1, dtype=torch.int64, device=table.device) if final else None
    fn = bind("bitmap", "bitmap_combine_launch", 5, 3)
    rc = fn(table.data_ptr(), out.data_ptr(), None if count is None else count.data_ptr(), ops,
            args, K, W, len(prog), stream_of(table))
    raise_on_error("bitmap", rc, f"(K {K}, W {W}, {len(prog)} ops)")
    count_launch("bitmap", table, len(prog))
    return count


def combine_bitmaps_launch(leaves: torch.Tensor, program: Program) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/bitmap.cu`` on a CUDA (K, W) int32 tensor without
    waiting for it: ((W,) int32 bitmap, (1,) int64 count), both on the card.
    One launch for a program within :func:`program_limits` (every program
    ``compile_query`` emits for a product path), else one for each launch of
    its schedule."""
    check_cuda("combine_bitmaps", leaves, (torch.int32,), ndim=2)
    plan = _plan(tuple(map(tuple, program)), program_limits()[0], leaves.shape[0])
    return run_schedule(leaves, plan, _launch)


def combine_bitmaps(leaves: torch.Tensor, program: Program) -> tuple[torch.Tensor, int]:
    """Evaluate a compiled predicate program over K leaf bitmaps.

    leaves: (K, W) int32 tensor; program: tuple of stack ops (``ref.py``).
    Returns ((W,) int32 combined bitmap on the leaves' device, total
    popcount as a Python int). The program's terminal validity AND clears
    the tail bits of the last word, so counts never include them under NOT.
    """
    leaves = require_tensor("combine_bitmaps", leaves)
    if leaves.device.type == "cpu":
        out, count = combine_bitmaps_torch(leaves, program)
    else:
        out, count = combine_bitmaps_launch(leaves, program)
    return out, int(count.item())
