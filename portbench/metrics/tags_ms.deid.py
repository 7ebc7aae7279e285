"""Milliseconds a GB of source pixels in the tag rules: ``pipeline.filter``
(the filter script over every instance) and ``pipeline.anonymize`` (the
anonymizer and the manifest entries), opened by
``DeidPipeline._deid_datasets``; self time inside the window."""
from portbench import spans


def read(cell):
    return spans.ms_per_gb(cell, ("pipeline.filter", "pipeline.anonymize"))
