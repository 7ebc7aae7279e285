"""Milliseconds a GB of source pixels in ``pipeline.lake``, opened by
``DeidPipeline._run_study_traced``: the result lake's key derivation
(``instance_digest`` over every slice's pixels, ``cache_key``) and gets,
and the puts of the fresh results; self time inside the window."""
from portbench import spans


def read(cell):
    return spans.ms_per_gb(cell, ("pipeline.lake",))
