"""Milliseconds a GB of source pixels in ``kernel.collect``, opened by
``BatchedDeidExecutor._collect_chunk`` on the scrub-only path: the copy
back into pageable memory (its wait on the card included) and into each
dataset; self time inside the window."""
from portbench import spans


def read(cell):
    return spans.ms_per_gb(cell, ("kernel.collect",))
