"""The span readers of the de-identification cells, on the CPU: self time
and its clipping to the window on fabricated runs, and every reader on a
traced run of the driver at a tiny size."""
import json
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from portbench import harness, spans  # noqa: E402

STAGES = ("fetch_ms.deid", "lake_ms.deid", "tags_ms.deid", "scrub_host_ms.deid",
          "dispatch_ms.deid", "collect_ms.deid", "deliver_ms.deid", "commit_ms.deid",
          "materialize_ms.deid")
READERS = STAGES + ("select_ms.deid", "unnamed_pct.deid")
TINY_CT = {"config": {"slices_per_study": 24,
                      "catalog": {"accessions": 4, "instances_per_accession": 512, "block_rows": 512,
                                  "columns": 11}},
           "traffic": {"payload_sample_block": 8}}


def reader(name):
    return harness.load_module(ROOT / "portbench" / "metrics" / f"{name}.py", "portbench_metric")


def cell(spans_, window, pixel_bytes=2e9):
    deid = {"pixel_bytes": pixel_bytes}
    if spans_ is not None:
        deid["pipeline_spans"] = spans_
    return types.SimpleNamespace(layer={"deid": deid}, window=window)


# one query and one study on one thread, in the order a tracer closes them
# (a child before its parent); the window is (1, 19)
RUN = [
    ("service.select", 0.5, 1.5),
    ("planner.partition", 1.6, 1.8),
    ("service.submit_cohort", 1.55, 1.9),
    ("service.submit_query", 0.0, 2.0),
    ("worker.fetch", 3.0, 4.0),
    ("worker.commit", 4.0, 4.25),
    ("pipeline.lake", 4.5, 5.0),
    ("pipeline.filter", 5.0, 5.5),
    ("kernel.dispatch", 6.0, 6.5),
    ("kernel.collect", 6.5, 7.5),
    ("kernel.dispatch", 7.5, 8.0),
    ("kernel.collect", 8.0, 9.0),
    ("pipeline.scrub", 5.5, 10.0),
    ("pipeline.anonymize", 10.0, 11.0),
    ("pipeline.lake", 11.0, 11.5),
    ("pipeline.run_study", 4.4, 12.0),
    ("worker.deid", 4.3, 12.1),
    ("worker.deliver", 12.1, 14.0),
    ("worker.writeback", 14.0, 14.5),
    ("worker.commit", 14.5, 15.0),
    ("worker.process", 2.5, 15.5),
    ("service.select", 16.0, 16.4),
    ("planner.materialize", 16.5, 17.3),
    ("service.submit_cohort", 16.45, 17.35),
    ("service.submit_query", 15.9, 17.4),
    ("planner.resolve", 19.5, 19.5),
]
WINDOW = (1.0, 19.0)
# self seconds inside the window, per span name
SELF = {"service.select": 0.5 + 0.4, "planner.partition": 0.2, "planner.materialize": 0.8,
        "service.submit_cohort": 0.15 + 0.1,
        "service.submit_query": 0.15 + 0.2, "worker.fetch": 1.0, "worker.commit": 0.75,
        "pipeline.lake": 1.0, "pipeline.filter": 0.5, "kernel.dispatch": 1.0,
        "kernel.collect": 2.0, "pipeline.scrub": 1.5, "pipeline.anonymize": 1.0,
        "pipeline.run_study": 0.6, "worker.deid": 0.2, "worker.deliver": 1.9,
        "worker.writeback": 0.5, "worker.process": 0.5 + 0.05 + 0.5}
# window time no span covers: 2.0-2.5, 15.5-15.9, 17.4-19.0
GAP = 0.5 + 0.4 + 1.6


@pytest.mark.parametrize("name", sorted(SELF))
def test_self_seconds_clip_to_the_window(name):
    assert spans.self_seconds(RUN, [name], WINDOW) == pytest.approx(SELF[name])


def test_self_times_and_the_gap_fill_the_window():
    names = {n for n, _, _ in RUN}
    total = spans.self_seconds(RUN, names, WINDOW) + spans.uncovered_seconds(RUN, WINDOW)
    assert total == pytest.approx(WINDOW[1] - WINDOW[0])
    assert spans.uncovered_seconds(RUN, WINDOW) == pytest.approx(GAP)


def test_identical_intervals_count_once():
    run = [("worker.deid", 1.0, 2.0), ("pipeline.run_study", 1.0, 2.0)]
    # a tracer closes the inner one first: it lists first
    assert spans.self_seconds(run, ["worker.deid"], (0.0, 3.0)) == pytest.approx(1.0)
    assert spans.self_seconds(run, ["pipeline.run_study"], (0.0, 3.0)) == pytest.approx(0.0)


def test_a_span_outside_the_window_is_absent():
    assert spans.self_seconds(RUN, ["planner.resolve"], WINDOW) is None
    assert spans.self_seconds(RUN, ["worker.fetch"], (20.0, 21.0)) is None


STAGE_NAMES = {"fetch_ms.deid": ["worker.fetch"], "lake_ms.deid": ["pipeline.lake"],
               "tags_ms.deid": ["pipeline.filter", "pipeline.anonymize"],
               "scrub_host_ms.deid": ["pipeline.scrub"], "dispatch_ms.deid": ["kernel.dispatch"],
               "collect_ms.deid": ["kernel.collect"], "deliver_ms.deid": ["worker.deliver"],
               "commit_ms.deid": ["worker.writeback", "worker.commit"],
               "materialize_ms.deid": ["planner.materialize"]}


@pytest.mark.parametrize("name", STAGES)
def test_stage_reader_is_self_time_per_gb(name):
    want = sum(SELF[n] for n in STAGE_NAMES[name]) * 1e3 / 2.0
    assert reader(name).read(cell(RUN, WINDOW)) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_its_spans(name):
    r = reader(name)
    assert r.read(cell(None, WINDOW)) is None
    assert r.read(cell([("planner.resolve", 2.0, 2.0)], WINDOW)) is None
    assert r.read(types.SimpleNamespace(layer={}, window=(0.0, 0.0))) is None


def test_select_reader_is_the_mean_call_of_the_window():
    # the first select started before the window
    assert reader("select_ms.deid").read(cell(RUN, WINDOW)) == pytest.approx(400.0)
    assert reader("select_ms.deid").read(cell(RUN, (0.0, 19.0))) == pytest.approx(700.0)


def test_unnamed_share_reads_a_known_gap():
    roots = SELF["worker.process"] + SELF["pipeline.run_study"] + SELF["service.submit_query"]
    got = reader("unnamed_pct.deid").read(cell(RUN, WINDOW))
    assert got == pytest.approx(100.0 * (GAP + roots) / 18.0)
    # a run of one study with a one-second gap before it and none after
    study = [("worker.fetch", 1.0, 2.0), ("worker.process", 1.0, 4.0)]
    assert reader("unnamed_pct.deid").read(cell(study, (0.0, 4.0))) == pytest.approx(
        100.0 * (1.0 + 2.0) / 4.0)


def test_stages_and_the_unnamed_rest_reconcile():
    """The stage readers times the window's GB, the selects, the unnamed
    share and the spans no reader names add up to the window."""
    c = cell(RUN, WINDOW)
    stage_s = sum(reader(n).read(c) for n in STAGES) * 2.0 / 1e3
    selects = SELF["service.select"]
    unnamed_s = reader("unnamed_pct.deid").read(c) / 100.0 * 18.0
    unread = SELF["planner.partition"] + SELF["service.submit_cohort"] + SELF["worker.deid"]
    assert stage_s + selects + unnamed_s + unread == pytest.approx(18.0)


def test_traced_driver_run_feeds_every_reader():
    """The de-identification driver, traced on the CPU at a tiny size: the
    worker's and the service's spans reach the pipeline's tracer, every
    reader reads a number, and self times and the gap fill the window."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    harness.setup_environment()
    wl, config, traffic = harness.resolve(bench, "ct_request.scrub", TINY_CT)
    c = harness.Cell(wl, config, traffic, 2**31 + 17, 1.0, True, "cpu")
    driver = harness.load_module(ROOT / "portbench" / "drivers" / "deid_service.py", "x_deid")
    state = driver.setup(c)
    driver.measure(c, state)
    state = driver.release(c, state)
    driver.check(c, state)
    assert all(v <= lim for _, v, lim in c.checks), c.checks
    sp = c.layer["deid"]["pipeline_spans"]
    names = {n for n, _, _ in sp}
    assert {"worker.process", "worker.fetch", "worker.commit", "service.submit_query",
            "service.select", "pipeline.lake", "kernel.collect"} <= names
    values = {n: reader(n).read(c) for n in READERS}
    assert all(v is not None and v >= 0 for v in values.values()), values
    assert 0 < values["unnamed_pct.deid"] < 100
    window = c.window[1] - c.window[0]
    total = spans.self_seconds(sp, names, c.window) + spans.uncovered_seconds(sp, c.window)
    assert total == pytest.approx(window, rel=1e-9)
