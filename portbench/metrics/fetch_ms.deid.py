"""Milliseconds a GB of source pixels in ``worker.fetch`` (the source
store's etag read and the study's read and unpickle), opened by
``DeidWorker._process_traced``; self time inside the window."""
from portbench import spans


def read(cell):
    return spans.ms_per_gb(cell, ("worker.fetch",))
