"""The port's bitmap combine (``repro_torch.kernels.bitmap``) against the JAX
package's ``combine_bitmaps`` (the Pallas kernel in interpret mode) and the
numpy oracle ``combine_bitmaps_ref``, bit for bit, with equal counts.

Programs come from ``compile_query`` over seeded random predicate trees
(both packages compile the same program); leaves are seeded random masks
with up to 8 leaves plus the validity leaf. On the CPU the port runs the
plain PyTorch version, which is what ``combine_bitmaps`` does for a CPU
tensor; the CUDA kernel is held against it in ``test_torch_gpu.py``.
``schedule_program``, which fits any program into the kernel's launches, is
held against both on long, deep and Not-rooted programs (``TestSchedule``)."""
import math

import numpy as np
import pytest
import torch

from repro.catalog import query as jax_query
from repro.catalog.columns import Dictionary as JaxDictionary
from repro.kernels.bitmap.ops import combine_bitmaps as jax_combine
from repro.kernels.bitmap.ops import pack_mask as jax_pack
from repro.kernels.bitmap.ref import combine_bitmaps_ref, pack_mask_np, unpack_mask_np

from repro_torch.catalog import query as port_query
from repro_torch.catalog.columns import DICT_COLUMNS, Dictionary
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.bitmap import cases as bitmap_cases
from repro_torch.kernels.bitmap.ops import (
    combine_bitmaps,
    combine_bitmaps_torch,
    combine_scheduled_torch,
    pack_mask,
    popcount_torch,
    program_depth,
    schedule_program,
    unpack_mask,
)

SIZES = (1, 31, 32, 33, 1000, 32 * 1024 + 5)
_MODALITIES = ["CT", "MR", "DX", "US", "CR", "PT"]
_MODELS = ["Optima CT660", "MAGNETOM Aera", "Epiq 7", "DRX-1"]


def random_spec(rng, depth=3, budget=None):
    """A predicate tree as nested tuples, at most ``budget[0]`` leaves."""
    budget = budget if budget is not None else [8]
    kind = int(rng.integers(0, 4 if depth <= 0 or budget[0] <= 2 else 7))
    if kind < 4:
        budget[0] -= 1
    if kind == 0:
        return ("Eq", "modality", str(rng.choice(_MODALITIES + ["XX"])))
    if kind == 1:
        lo = 20150101 + int(rng.integers(0, 4)) * 10000
        return ("Range", "study_date", lo, lo + 1130)
    if kind == 2:
        return ("In", "modality", tuple(str(v) for v in rng.choice(_MODALITIES, 2)))
    if kind == 3:
        return ("Contains", "model", str(rng.choice(["ct", "MAG", "7", "zzz"])))
    if kind == 4:
        return ("Not", random_spec(rng, depth - 1, budget))
    n = int(rng.integers(2, 4))
    subs = []
    for _ in range(n):
        if budget[0] <= 0:
            break
        subs.append(random_spec(rng, depth - 1, budget))
    if len(subs) == 1:
        return subs[0]
    return ("And" if kind == 5 else "Or", *subs)


def build(spec, q):
    """The predicate of ``spec`` in the query module ``q`` of either package."""
    op = spec[0]
    if op in ("And", "Or"):
        return getattr(q, op)(*(build(s, q) for s in spec[1:]))
    if op == "Not":
        return q.Not(build(spec[1], q))
    return getattr(q, op)(*spec[1:])


def dicts_for(cls):
    dicts = {c: cls() for c in DICT_COLUMNS}
    for v in _MODALITIES:
        dicts["modality"].encode(v)
    for v in _MODELS:
        dicts["model"].encode(v)
    return dicts


def programs(n_programs=12, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n_programs:
        spec = random_spec(rng)
        port = port_query.compile_query(build(spec, port_query), dicts_for(Dictionary))
        jax = jax_query.compile_query(build(spec, jax_query), dicts_for(JaxDictionary))
        assert port.program == jax.program
        out.append((len(port.leaves), port.program))
    return out


PROGRAMS = programs()


def leaves_for(rng, n, k):
    masks = [rng.random(n) < rng.random() for _ in range(k)]
    valid = rng.random(n) < 0.9
    return np.stack([pack_mask_np(m) for m in masks + [valid]])


def as_port(leaves_np):
    return torch.from_numpy(leaves_np.view(np.int32).copy())


class TestCombineParity:
    def test_programs_use_up_to_eight_leaves(self):
        ks = [k for k, _ in PROGRAMS]
        assert max(ks) <= 8 and min(ks) >= 1 and len(set(ks)) > 2
        assert any(op == ("not",) for _, p in PROGRAMS for op in p)

    @pytest.mark.parametrize("n", SIZES)
    @pytest.mark.parametrize("p", range(len(PROGRAMS)))
    def test_port_equals_jax_and_ref(self, n, p):
        k, program = PROGRAMS[p]
        rng = np.random.default_rng(1000 * p + n)
        leaves = leaves_for(rng, n, k)
        want, want_count = combine_bitmaps_ref(leaves, program)
        jax_bm, jax_count = jax_combine(leaves, program)
        launches = LAUNCHES["bitmap"]
        got, count = combine_bitmaps(as_port(leaves), program)
        assert LAUNCHES["bitmap"] == launches  # a CPU tensor runs the plain version
        assert got.dtype == torch.int32 and got.shape == (leaves.shape[1],)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        np.testing.assert_array_equal(np.asarray(jax_bm), want)
        assert count == want_count == jax_count
        assert isinstance(count, int)

    @pytest.mark.parametrize("n", SIZES)
    def test_not_rooted_program_never_counts_padding(self, n):
        """All-false leaf under NOT: only the validity AND keeps the tail bits
        of the last word out (mirrors the JAX package's padding test)."""
        leaves = np.stack([pack_mask_np(np.zeros(n, bool)), pack_mask_np(np.ones(n, bool))])
        prog = (("leaf", 0), ("not",), ("leaf", 1), ("and",))
        got, count = combine_bitmaps(as_port(leaves), prog)
        _, jax_count = jax_combine(leaves, prog)
        assert count == jax_count == n
        assert np.array_equal(unpack_mask(got, n), np.ones(n, bool))
        # without the validity AND the tail bits would count
        _, raw = combine_bitmaps(as_port(leaves[:1]), (("leaf", 0), ("not",)))
        assert raw == 32 * leaves.shape[1]

    def test_single_leaf_program_returns_a_copy(self):
        leaves = as_port(leaves_for(np.random.default_rng(3), 70, 1))
        got, _ = combine_bitmaps(leaves, (("leaf", 0),))
        got[:] = 0
        assert leaves.abs().sum() > 0

    @pytest.mark.parametrize("program,error", [
        ((("leaf", 0), ("and",)), IndexError),            # and on one value: stack underflow
        ((("leaf", 0), ("leaf", 1)), ValueError),          # two values left
        ((("leaf", 0), ("xor",)), ValueError),             # unknown opcode
        ((("leaf", 5),), IndexError),                      # leaf index past K
    ])
    def test_plain_version_refuses_bad_programs(self, program, error):
        leaves = as_port(leaves_for(np.random.default_rng(4), 40, 1))
        with pytest.raises(error):
            combine_bitmaps(leaves, program)

    def test_numpy_input_is_refused(self):
        with pytest.raises(TypeError, match="torch tensor"):
            combine_bitmaps(leaves_for(np.random.default_rng(0), 40, 1), (("leaf", 0),))

    def test_plain_function_is_the_cpu_path(self):
        leaves = as_port(leaves_for(np.random.default_rng(6), 500, 3))
        prog = (("leaf", 0), ("leaf", 1), ("or",), ("not",), ("leaf", 2), ("and",),
                ("leaf", 3), ("and",))
        a, ca = combine_bitmaps(leaves, prog)
        b, cb = combine_bitmaps_torch(leaves, prog)
        assert torch.equal(a, b) and ca == int(cb) and cb.dtype == torch.int64


class TestPackMask:
    @pytest.mark.parametrize("n", SIZES + (257,))
    def test_pack_parity_and_roundtrip(self, n):
        mask = np.random.default_rng(n).random(n) < 0.5
        want = pack_mask_np(mask)
        got = pack_mask(torch.from_numpy(mask))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        np.testing.assert_array_equal(np.asarray(jax_pack(mask)), want)
        np.testing.assert_array_equal(unpack_mask(got, n), mask)
        np.testing.assert_array_equal(unpack_mask_np(want, n), mask)

    def test_bit_31_wraps_to_a_negative_word(self):
        mask = np.zeros(64, bool)
        mask[31] = True                 # word 0 = 2^31
        mask[32:] = True                # word 1 = 2^32 - 1
        got = pack_mask(torch.from_numpy(mask))
        assert got.tolist() == [-(1 << 31), -1]
        assert got.numpy().view(np.uint32).tolist() == [1 << 31, (1 << 32) - 1]
        np.testing.assert_array_equal(unpack_mask(got, 64), mask)

    def test_empty_mask_packs_one_zero_word(self):
        got = pack_mask(torch.zeros(0, dtype=torch.bool))
        assert got.tolist() == [0] and pack_mask_np(np.zeros(0, bool)).tolist() == [0]

    @pytest.mark.parametrize("words", [[0], [-1], [-(1 << 31)], [5, -7, 1 << 30]])
    def test_popcount_of_int32_words(self, words):
        want = sum(bin(w & 0xFFFFFFFF).count("1") for w in words)
        assert int(popcount_torch(torch.tensor(words, dtype=torch.int32))) == want


# ------------------------------------------------------------------ scheduler
def wide_spec(kind, n, seed):
    """An And/Or of ``n`` Range and In children, as ``compile_query`` gets a
    cohort query with many predicates."""
    rng = np.random.default_rng(seed)
    kids = []
    for i in range(n):
        if i % 2:
            lo = 20150101 + int(rng.integers(0, 4)) * 10000
            kids.append(("Range", "study_date", lo - 20000, lo + 20000))
        else:
            kids.append(("In", "modality", tuple(str(v) for v in rng.choice(_MODALITIES, 4))))
    return (kind, *kids)


def nested_spec(depth):
    """``depth`` nested levels, And and Or in turn, each a leaf beside the
    next level: the stack program is right-deep, ``depth + 1`` values deep."""
    spec = ("Range", "study_date", 20150101, 20181231)
    for d in range(depth):
        leaf = ("In", "modality", (_MODALITIES[d % 6], _MODALITIES[(d + 2) % 6]))
        spec = ("And" if d % 2 else "Or", leaf, spec)
    return spec


def compiled(spec):
    """(leaf count, program): both packages compile the same program."""
    port = port_query.compile_query(build(spec, port_query), dicts_for(Dictionary))
    jax = jax_query.compile_query(build(spec, jax_query), dicts_for(JaxDictionary))
    assert port.program == jax.program
    return len(port.leaves), port.program


LONG_PROGRAMS = {
    "and_40": lambda: compiled(wide_spec("And", 40, 1)),
    "or_40": lambda: compiled(wide_spec("Or", 40, 2)),
    "and_200": lambda: compiled(wide_spec("And", 200, 3)),
    "or_200": lambda: compiled(wide_spec("Or", 200, 4)),
    "nested_40": lambda: compiled(nested_spec(40)),
    "not_rooted": lambda: compiled(("Not", wide_spec("Or", 40, 5))),
    "random_5000": lambda: (8, bitmap_cases.random_program(np.random.default_rng(6), 5000, 8)),
}


class TestSchedule:
    """``schedule_program`` against the JAX package: every schedule, run
    through the plain version launch by launch, gives the reference's bitmap
    and count, and no launch is longer than ``max_ops`` or deeper than
    floor(log2 L) + 1 for its L leaf ops."""

    @pytest.mark.parametrize("max_ops", [16, 128])
    @pytest.mark.parametrize("name", list(LONG_PROGRAMS))
    def test_schedule_equals_jax_and_ref(self, name, max_ops):
        k, program = LONG_PROGRAMS[name]()
        leaves = leaves_for(np.random.default_rng(len(program)), 1000, k)
        schedule = schedule_program(program, max_ops, k + 1)
        # each cut subtree becomes one leaf op of a later launch
        assert sum(len(p) for p in schedule) == len(program) + len(schedule) - 1
        for launch in schedule:
            n_leaves = sum(op[0] == "leaf" for op in launch)
            assert len(launch) <= max_ops
            assert program_depth(launch) <= math.floor(math.log2(n_leaves)) + 1
        assert schedule[-1][-2:] == (("leaf", k), ("and",))  # the validity AND stays last
        if len(program) <= max_ops:
            assert len(schedule) == 1
        want, want_count = combine_bitmaps_ref(leaves, program)
        jax_bm, jax_count = jax_combine(leaves, program)
        got, count = combine_scheduled_torch(as_port(leaves), schedule)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        np.testing.assert_array_equal(np.asarray(jax_bm), want)
        assert int(count) == want_count == jax_count

    @pytest.mark.parametrize("p", range(len(PROGRAMS)))
    def test_short_programs_keep_one_launch_and_their_leaf_order(self, p):
        """``compile_query``'s And/Or chains are left-deep: Sethi-Ullman
        order leaves them as they are, one launch, the same leaf order."""
        k, program = PROGRAMS[p]
        schedule = schedule_program(program, 128, k + 1)
        assert len(schedule) == 1 and len(schedule[0]) == len(program)
        leaf_order = [op for op in program if op[0] == "leaf"]
        if program_depth(program) <= 2:
            assert schedule[0] == program
        assert sorted(op for op in schedule[0] if op[0] == "leaf") == sorted(leaf_order)

    def test_nested_program_depth_falls_to_two(self):
        k, program = compiled(nested_spec(40))
        assert program_depth(program) == 41
        assert [program_depth(p) for p in schedule_program(program, 1 << 20, k + 1)] == [2]

    @pytest.mark.parametrize("program,match", [
        ((("leaf", 0), ("and",)), "empty stack"),
        ((("leaf", 0), ("leaf", 1)), "2 values left"),
        ((("leaf", 0), ("xor",)), "unknown opcode"),
        ((("leaf", 5),), "not one of 2 rows"),
        ((), "0 values left"),
    ])
    def test_malformed_programs_raise(self, program, match):
        with pytest.raises(ValueError, match=match):
            schedule_program(program, 128, 2)

    def test_a_launch_takes_at_least_three_ops(self):
        with pytest.raises(ValueError, match="at least 3"):
            schedule_program((("leaf", 0),), 2, 1)
