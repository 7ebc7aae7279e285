"""Mean milliseconds of ``service.select`` (the catalog's select on the
card), opened by ``DeidService.submit_query``, over the queries that
started in the window: ``submit_ms.deid`` from inside the service."""
from portbench import spans


def read(cell):
    sp, _ = spans.deid_spans(cell)
    t0, t1 = cell.window
    calls = [b - a for n, a, b in sp or () if n == "service.select" and t0 <= a <= t1]
    return 1e3 * sum(calls) / len(calls) if calls else None
