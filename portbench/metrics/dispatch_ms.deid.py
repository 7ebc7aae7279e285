"""Milliseconds a GB of source pixels in ``kernel.dispatch``, opened by
``BatchedDeidExecutor._submit_chunk``: a chunk's pinned staging, its
upload and the kernel's launch; self time inside the window."""
from portbench import spans


def read(cell):
    return spans.ms_per_gb(cell, ("kernel.dispatch",))
