"""Milliseconds a GB of source pixels in ``pipeline.scrub`` outside its
``kernel.*`` children: ``ScrubStage.scrub_study``'s host work (rects per
instance, the datasets' copies, bucketing, the results' bookkeeping);
self time inside the window."""
from portbench import spans


def read(cell):
    return spans.ms_per_gb(cell, ("pipeline.scrub",))
