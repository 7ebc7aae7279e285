"""Milliseconds a GB of source pixels in the worker's durable records:
``worker.writeback`` (the study record into the result lake) and
``worker.commit`` (the source-fetch ledger record, the journal's done
record and the delivery and provenance records), opened by
``DeidWorker._process_traced``; self time inside the window."""
from portbench import spans


def read(cell):
    return spans.ms_per_gb(cell, ("worker.writeback", "worker.commit"))
