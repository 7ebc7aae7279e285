"""Milliseconds a GB of source pixels in ``worker.deliver``, opened by
``DeidWorker._process_traced``: ``put_output`` (pickle and hash) of every
delivered instance; self time inside the window."""
from portbench import spans


def read(cell):
    return spans.ms_per_gb(cell, ("worker.deliver",))
