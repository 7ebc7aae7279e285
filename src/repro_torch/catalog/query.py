"""Typed predicate AST + compilation to vectorized columnar evaluation.

Three evaluation paths, all required to agree bit-for-bit:

* :func:`matches_row` — python truth, one row at a time. The brute-force
  oracle the fleet simulator's query-consistency invariant replays; it never
  touches dictionaries, bitmaps, or pruning.
* :func:`eval_oracle` — numpy over resolved int32 columns, no bitmaps. The
  reference scan the vectorized path is parity-tested against (and the
  catalogbench baseline).
* :func:`eval_vectorized` — torch leaf compares on the catalog's device,
  packed into bitmaps (int32 words holding the uint32 bit pattern) and
  combined by the bitmap kernel (``csrc/bitmap.cu`` on the card, its plain
  PyTorch version on the CPU). The production path.

Compilation resolves string literals to dictionary codes once (``Eq`` on a
never-ingested value becomes a statically-false leaf; ``Contains`` becomes an
``In`` over the matching codes) and flattens the tree into a static stack
program terminated by a validity-AND, so NOT can never resurrect tombstoned
or padding rows.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.catalog.columns import COLUMN_KINDS, Dictionary, ZoneMap, bloom_bit
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dicom.dataset import normalize_cs
from repro_torch.kernels.bitmap.ops import combine_bitmaps, pack_mask, unpack_mask
from repro_torch.kernels.bitmap.ref import Program


# ------------------------------------------------------------------------ AST
class Predicate:
    """Marker base. Predicates are frozen (hashable) — traffic models treat
    them as data, exactly like accession tuples."""


@dataclass(frozen=True)
class Eq(Predicate):
    col: str
    value: Any


@dataclass(frozen=True)
class In(Predicate):
    col: str
    values: Tuple[Any, ...]


@dataclass(frozen=True)
class Range(Predicate):
    """Inclusive [lo, hi] over an int column (StudyDate is yyyymmdd)."""

    col: str
    lo: int
    hi: int


@dataclass(frozen=True)
class Contains(Predicate):
    """Free-text substring over a dictionary column's decoded values."""

    col: str
    needle: str


@dataclass(frozen=True, init=False)
class And(Predicate):
    preds: Tuple[Predicate, ...]

    def __init__(self, *preds: Predicate) -> None:
        object.__setattr__(self, "preds", tuple(preds))


@dataclass(frozen=True, init=False)
class Or(Predicate):
    preds: Tuple[Predicate, ...]

    def __init__(self, *preds: Predicate) -> None:
        object.__setattr__(self, "preds", tuple(preds))


@dataclass(frozen=True)
class Not(Predicate):
    pred: Predicate


def describe(pred: Predicate) -> str:
    """Canonical string form — feeds selection digests and the sim event
    log, so it must be deterministic (values normalized, order preserved)."""
    if isinstance(pred, Eq):
        v = normalize_cs(pred.value) if COLUMN_KINDS.get(pred.col) == "dict" else int(pred.value)
        return f"Eq({pred.col},{v})"
    if isinstance(pred, In):
        if COLUMN_KINDS.get(pred.col) == "dict":
            vals = ",".join(normalize_cs(v) for v in pred.values)
        else:
            vals = ",".join(str(int(v)) for v in pred.values)
        return f"In({pred.col},[{vals}])"
    if isinstance(pred, Range):
        return f"Range({pred.col},{int(pred.lo)},{int(pred.hi)})"
    if isinstance(pred, Contains):
        return f"Contains({pred.col},{normalize_cs(pred.needle)})"
    if isinstance(pred, And):
        return f"And({','.join(describe(p) for p in pred.preds)})"
    if isinstance(pred, Or):
        return f"Or({','.join(describe(p) for p in pred.preds)})"
    if isinstance(pred, Not):
        return f"Not({describe(pred.pred)})"
    raise TypeError(f"not a predicate: {pred!r}")


# ----------------------------------------------------------- row-level oracle
def matches_row(pred: Predicate, row: Dict[str, Any]) -> bool:
    """Ground truth for one raw row dict (`columns.row_from_dataset` output).
    Pure python semantics — no dictionaries, no vectorization. Missing
    columns read as ""/0, the same defaults ``ingest_rows`` encodes."""
    if isinstance(pred, Eq):
        if COLUMN_KINDS[pred.col] == "dict":
            return normalize_cs(row.get(pred.col, "")) == normalize_cs(pred.value)
        return int(row.get(pred.col, 0)) == int(pred.value)
    if isinstance(pred, In):
        return any(matches_row(Eq(pred.col, v), row) for v in pred.values)
    if isinstance(pred, Range):
        _require_int(pred.col, "Range")
        return int(pred.lo) <= int(row.get(pred.col, 0)) <= int(pred.hi)
    if isinstance(pred, Contains):
        _require_dict(pred.col, "Contains")
        return normalize_cs(pred.needle) in normalize_cs(row.get(pred.col, ""))
    if isinstance(pred, And):
        return all(matches_row(p, row) for p in pred.preds)
    if isinstance(pred, Or):
        return any(matches_row(p, row) for p in pred.preds)
    if isinstance(pred, Not):
        return not matches_row(pred.pred, row)
    raise TypeError(f"not a predicate: {pred!r}")


def _require_int(col: str, what: str) -> None:
    if COLUMN_KINDS.get(col) != "int":
        raise ValueError(f"{what} requires an int column, got {col!r}")


def _require_dict(col: str, what: str) -> None:
    if COLUMN_KINDS.get(col) != "dict":
        raise ValueError(f"{what} requires a dictionary column, got {col!r}")


def _check_col(col: str) -> None:
    if col not in COLUMN_KINDS:
        raise KeyError(f"unknown catalog column {col!r}; schema: {sorted(COLUMN_KINDS)}")


# ---------------------------------------------------------------- compilation
@dataclass(frozen=True)
class ResolvedLeaf:
    """A leaf after literal resolution: string literals became dictionary
    codes. ``test`` is ("in", codes_or_values_tuple) or ("range", lo, hi);
    Eq resolves to a one-element "in", unknown dict literals to an empty one
    (statically false)."""

    col: str
    test: Tuple


@dataclass(frozen=True)
class ResolvedNode:
    """Tree mirror of the predicate with leaves resolved — the oracle and the
    zone-map pruner walk this; the vectorized path uses the flat program."""

    op: str  # "leaf" | "and" | "or" | "not"
    leaf: Optional[int] = None               # leaf index for op == "leaf"
    children: Tuple["ResolvedNode", ...] = ()


@dataclass
class CompiledQuery:
    leaves: List[ResolvedLeaf]
    tree: ResolvedNode
    program: Program       # stack program over leaves + terminal validity AND
    cols: Tuple[str, ...]  # columns the leaves touch


def _resolve_leaf(pred: Predicate, dicts: Dict[str, Dictionary]) -> ResolvedLeaf:
    if isinstance(pred, Eq):
        _check_col(pred.col)
        if COLUMN_KINDS[pred.col] == "dict":
            code = dicts[pred.col].code_of(pred.value)
            return ResolvedLeaf(pred.col, ("in", () if code is None else (code,)))
        return ResolvedLeaf(pred.col, ("in", (int(pred.value),)))
    if isinstance(pred, In):
        _check_col(pred.col)
        if COLUMN_KINDS[pred.col] == "dict":
            codes = tuple(
                c for c in (dicts[pred.col].code_of(v) for v in pred.values) if c is not None
            )
            return ResolvedLeaf(pred.col, ("in", codes))
        return ResolvedLeaf(pred.col, ("in", tuple(int(v) for v in pred.values)))
    if isinstance(pred, Range):
        _check_col(pred.col)
        _require_int(pred.col, "Range")
        return ResolvedLeaf(pred.col, ("range", int(pred.lo), int(pred.hi)))
    if isinstance(pred, Contains):
        _check_col(pred.col)
        _require_dict(pred.col, "Contains")
        return ResolvedLeaf(pred.col, ("in", dicts[pred.col].codes_containing(pred.needle)))
    raise TypeError(f"not a leaf predicate: {pred!r}")


def compile_query(pred: Predicate, dicts: Dict[str, Dictionary]) -> CompiledQuery:
    leaves: List[ResolvedLeaf] = []
    ops: List[tuple] = []

    def emit(p: Predicate) -> ResolvedNode:
        if isinstance(p, (And, Or)):
            if not p.preds:
                raise ValueError(f"{type(p).__name__} needs at least one child")
            kind = "and" if isinstance(p, And) else "or"
            children = []
            for i, c in enumerate(p.preds):
                children.append(emit(c))
                if i:
                    ops.append((kind,))
            return ResolvedNode(kind, children=tuple(children))
        if isinstance(p, Not):
            node = emit(p.pred)
            ops.append(("not",))
            return ResolvedNode("not", children=(node,))
        leaf = _resolve_leaf(p, dicts)
        idx = len(leaves)
        leaves.append(leaf)
        ops.append(("leaf", idx))
        return ResolvedNode("leaf", leaf=idx)

    tree = emit(pred)
    # terminal validity AND: leaf index len(leaves) is reserved for the valid
    # bitmap the evaluator appends (tombstones + padding)
    program = tuple(ops) + (("leaf", len(leaves)), ("and",))
    cols = tuple(dict.fromkeys(leaf.col for leaf in leaves))
    return CompiledQuery(leaves=leaves, tree=tree, program=program, cols=cols)


# ------------------------------------------------------------------- pruning
def zone_may_match(
    node: ResolvedNode, leaves: List[ResolvedLeaf], zmaps: Dict[str, ZoneMap]
) -> bool:
    """Conservative block test: False only when the zone maps PROVE no row in
    the block can satisfy the predicate. NOT is always conservative-True
    (zone maps witness presence, not absence)."""
    if node.op == "leaf":
        leaf = leaves[node.leaf]
        zm = zmaps[leaf.col]
        if leaf.test[0] == "range":
            _, lo, hi = leaf.test
            return hi >= zm.lo and lo <= zm.hi
        values = leaf.test[1]
        if not values:
            return False  # statically-false leaf (unknown literal)
        if COLUMN_KINDS[leaf.col] == "dict":
            return any(zm.bloom >> bloom_bit(v) & 1 for v in values)
        return any(zm.lo <= v <= zm.hi for v in values)
    if node.op == "and":
        return all(zone_may_match(c, leaves, zmaps) for c in node.children)
    if node.op == "or":
        return any(zone_may_match(c, leaves, zmaps) for c in node.children)
    return True  # not


# ----------------------------------------------------------------- evaluation
def _leaf_mask_np(leaf: ResolvedLeaf, arrays: Dict[str, np.ndarray]) -> np.ndarray:
    arr = arrays[leaf.col]
    if leaf.test[0] == "range":
        _, lo, hi = leaf.test
        return (arr >= lo) & (arr <= hi)
    mask = np.zeros(arr.shape[0], bool)
    for v in leaf.test[1]:
        mask |= arr == v
    return mask


def _leaf_mask_torch(leaf: ResolvedLeaf, arrays: Dict[str, torch.Tensor]) -> torch.Tensor:
    arr = arrays[leaf.col]
    if leaf.test[0] == "range":
        _, lo, hi = leaf.test
        return (arr >= lo) & (arr <= hi)
    mask = torch.zeros(arr.shape[0], dtype=torch.bool, device=arr.device)
    for v in leaf.test[1]:
        mask |= arr == v
    return mask


def _eval_tree_np(
    node: ResolvedNode, leaves: List[ResolvedLeaf], arrays: Dict[str, np.ndarray]
) -> np.ndarray:
    if node.op == "leaf":
        return _leaf_mask_np(leaves[node.leaf], arrays)
    masks = [_eval_tree_np(c, leaves, arrays) for c in node.children]
    if node.op == "and":
        out = masks[0]
        for m in masks[1:]:
            out = out & m
        return out
    if node.op == "or":
        out = masks[0]
        for m in masks[1:]:
            out = out | m
        return out
    return ~masks[0]  # not


def eval_oracle(
    compiled: CompiledQuery, arrays: Dict[str, np.ndarray], valid: np.ndarray
) -> np.ndarray:
    """Numpy reference scan: resolved tree over int32 columns, validity AND
    at the end. No bitmaps, no torch."""
    if valid.shape[0] == 0:
        return np.zeros(0, bool)
    return _eval_tree_np(compiled.tree, compiled.leaves, arrays) & valid


def eval_vectorized(
    compiled: CompiledQuery,
    arrays: Dict[str, np.ndarray],
    valid: np.ndarray,
    device: DeviceLike = None,
) -> np.ndarray:
    """Production path: torch leaf compares on ``device`` (default
    ``cuda:0``) -> packed bitmaps -> bitmap combine+popcount kernel. The
    scanned columns are uploaded once per query. Bit-identical to
    :func:`eval_oracle`."""
    n = int(valid.shape[0])
    if n == 0:
        return np.zeros(0, bool)
    dev = resolve_device(device)
    tarrays = {
        c: torch.from_numpy(np.ascontiguousarray(arrays[c], np.int32)).to(dev)
        for c in compiled.cols
    }
    packed = [pack_mask(_leaf_mask_torch(leaf, tarrays)) for leaf in compiled.leaves]
    # the reserved validity leaf
    packed.append(pack_mask(torch.from_numpy(np.ascontiguousarray(valid, bool)).to(dev)))
    bitmap, _count = combine_bitmaps(torch.stack(packed), compiled.program)
    return unpack_mask(bitmap, n)
