"""Share of the window that no stage names: the time no program span
covers, plus the self time of ``worker.process``, ``pipeline.run_study``
and ``service.submit_query`` (their work outside every child span). None
where no ``worker.process`` span overlaps the window."""
from portbench import spans

ROOTS = ("worker.process", "pipeline.run_study", "service.submit_query")


def read(cell):
    sp, _ = spans.deid_spans(cell)
    t0, t1 = cell.window
    if sp is None or not any(n == "worker.process" and a < t1 and b > t0 for n, a, b in sp):
        return None
    rest = spans.uncovered_seconds(sp, cell.window) + spans.self_seconds(sp, ROOTS, cell.window)
    return 100.0 * rest / (t1 - t0)
