"""Share of ``pipeline.run_study`` time spent in the executor's
``kernel.entropy_code`` spans (the host Golomb-Rice tail), both on the
pipeline's wall-clock tracer, clipped to the window."""


def _inside(spans, name, t0, t1):
    return sum(max(0.0, min(b, t1) - max(a, t0)) for n, a, b in spans if n == name)


def read(cell):
    deid = cell.layer.get("deid", {})
    spans = deid.get("pipeline_spans")
    if not spans or not deid.get("recompress"):
        return None
    t0, t1 = cell.window
    study = _inside(spans, "pipeline.run_study", t0, t1)
    entropy = _inside(spans, "kernel.entropy_code", t0, t1)
    return 100.0 * entropy / study if study > 0 and entropy > 0 else None
