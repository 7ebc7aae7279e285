"""Programs for every comparison of the bitmap kernel with its plain version
(the card's tests, the CPU parity tests against the JAX package,
``chip_smoke.py`` and ``kernel_ab.py``).

Each program is a stack program over leaf rows ``0 .. k - 1`` ending in the
validity AND of leaf ``k``, as ``compile_query`` ends them: ``chain`` is
the shape ``compile_query`` gives a predicate (left-deep, 2 deep), ``nested``
a right-deep one past one launch's stack depth, ``random_program`` one of any
length, past one launch's ops.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.bitmap.ref import Program


def chain(k: int) -> Program:
    """k leaves joined by AND and OR in turn with a NOT on every other one,
    then the validity AND."""
    prog = [("leaf", 0)]
    for i in range(1, k):
        prog += [("leaf", i)] + ([("not",)] if i % 2 else []) + [("and",) if i % 3 else ("or",)]
    return tuple(prog) + (("leaf", k), ("and",))


def nested(depth: int, k: int) -> Program:
    """``depth`` levels, OR and AND in turn, each a leaf beside the next
    level: ``depth + 1`` values deep as written."""
    prog: Program = (("leaf", 0),)
    for d in range(depth):
        prog = (("leaf", 1 + d % (k - 1)),) + prog + (("and",) if d % 2 else ("or",),)
    return prog + (("leaf", k), ("and",))


def random_program(rng: np.random.Generator, n_ops: int, k: int) -> Program:
    """A random well-formed program of at least ``n_ops`` ops (ANDs, ORs,
    NOTs), then the validity AND."""
    ops, depth = [], 0
    while len(ops) < n_ops - 2 or depth > 1:
        x = rng.random()
        if len(ops) < n_ops - 2 and (depth < 2 or x < 0.45):
            ops.append(("leaf", int(rng.integers(0, k))))
            depth += 1
        elif depth >= 2 and x < 0.9:
            ops.append(("and",) if rng.random() < 0.5 else ("or",))
            depth -= 1
        else:
            ops.append(("not",))
    return tuple(ops) + (("leaf", k), ("and",))
