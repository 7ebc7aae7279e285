"""Wall-clock stage spans on the de-identification path of ``repro_torch``.

A deployment whose pipeline alone holds a tracer on a wall clock records
the worker's, the service's, the pipeline's and the executor's spans on
that one tracer, nested as a study's path runs. On a ``SimClock`` the
stage spans are not recorded, so replayed traces keep their spans and ids.
"""
from __future__ import annotations

import time
import types
from collections import defaultdict

import numpy as np
import pytest

from repro_torch.audit.ledger import AuditLedger
from repro_torch.catalog import StudyCatalog
from repro_torch.catalog import query as q
from repro_torch.core import DeidPipeline
from repro_torch.core.batch import BatchedDeidExecutor
from repro_torch.dicom.generator import StudyGenerator
from repro_torch.lake import ResultLake
from repro_torch.obs.profile import CriticalPathProfiler
from repro_torch.obs.trace import NULL_TRACER, Span, Tracer, host_path_digest, trace_id_for
from repro_torch.queueing import Autoscaler, AutoscalerConfig, Broker, DeidWorker, Journal
from repro_torch.queueing import WorkerPool
from repro_torch.queueing.server import DeidService
from repro_torch.storage.object_store import StudyStore
from repro_torch.utils.timing import SimClock, WallClock

KEY = b"s" * 32

# (span, its parent) on a study's path, as the deployment opens them
TREE = {
    "service.select": "service.submit_query",
    "service.submit_cohort": "service.submit_query",
    "worker.fetch": "worker.process",
    "worker.commit": "worker.process",
    "worker.deid": "worker.process",
    "pipeline.run_study": "worker.deid",
    "pipeline.lake": "pipeline.run_study",
    "pipeline.filter": "pipeline.run_study",
    "pipeline.scrub": "pipeline.run_study",
    "pipeline.anonymize": "pipeline.run_study",
    "kernel.dispatch": "pipeline.scrub",
    "kernel.collect": "pipeline.scrub",
    "worker.deliver": "worker.process",
    "worker.writeback": "worker.process",
}


# ------------------------------------------------------------------ clocks
def test_wall_clock_never_goes_backwards():
    clock = WallClock()
    reads = [clock.now() for _ in range(10_000)]
    assert all(b >= a for a, b in zip(reads, reads[1:]))
    assert clock.now() == pytest.approx(time.perf_counter(), abs=1.0)


def test_wall_clock_span_has_width_around_a_sleep():
    tracer = Tracer(WallClock())
    with tracer.span("outer"):
        time.sleep(0.01)
    (sp,) = tracer.spans("outer")
    assert sp.t1 - sp.t0 >= 0.009


class StillClock:
    """A clock that runs by itself, stopped: every span is zero-width, so
    a trace's digest is the same on every run."""

    def now(self) -> float:
        return 0.0


@pytest.mark.parametrize("make,timed", [(SimClock, False), (WallClock, True), (StillClock, True)])
def test_stage_spans_record_only_on_a_clock_that_runs(make, timed):
    tracer = Tracer(make())
    assert tracer.timed is timed
    with tracer.stage("pipeline.filter") as sp:
        pass
    assert (sp.span is not None) is timed
    assert len(tracer.spans("pipeline.filter")) == int(timed)
    assert NULL_TRACER.stage("pipeline.filter") is NULL_TRACER.span("pipeline.filter")


# ----------------------------------------------------------------- profile
def _span(seq, name, t0, t1, trace_id, parent=None, **attrs):
    return Span(trace_id=trace_id, span_id=f"s{seq:08d}", parent_id=parent, name=name, t0=t0,
                t1=t1, seq=seq, attrs=attrs)


@pytest.mark.parametrize("width,busy,folded", [(0.2, 3.75, 0.2), (0.0, 3.75, 3.75)])
def test_profile_folds_a_wall_clock_span_by_its_width(width, busy, folded):
    """A ``worker.deid`` span timed on a wall clock folds its width; a
    zero-width one (the SimClock case) folds its modeled ``busy_s``."""
    key = "IRB/ACC1"
    tid = trace_id_for(key, 1)
    t = 10.0
    spans = [
        _span(1, "broker.publish", 1.0, 1.0, tid, key=key),
        _span(2, "broker.lease", 2.0, 2.0, tid, key=key),
        _span(3, "worker.process", t, t + width + 0.5, tid, ok=True),
        _span(4, "worker.deid", t + 0.1, t + 0.1 + width, tid, parent="s00000003", busy_s=busy),
        _span(5, "broker.ack", t + width + 0.6, t + width + 0.6, tid, key=key),
    ]
    prof = CriticalPathProfiler()
    assert prof.fold(spans) == 1
    assert prof.profile()["cold"]["NA"]["deid"]["total_s"] == pytest.approx(folded)


# -------------------------------------------------------------- deployment
def _deployment(tmp_path, name, tracer, *, use_kernel=None, worker_tracer=None):
    gen = StudyGenerator(5)
    study = gen.gen_study("SPAN001", modality="CT", n_images=3)
    clock = SimClock()
    ledger = AuditLedger(tmp_path / f"{name}.audit", clock=clock)
    source = StudyStore("lake")
    source.put_study(study.accession, study)
    catalog = StudyCatalog(device="cpu")
    source.attach_catalog(catalog)
    broker = Broker(clock, visibility_timeout=300.0)
    journal = Journal(tmp_path / f"{name}.jsonl")
    lake = ResultLake(max_bytes=1 << 30, ledger=ledger)
    pipe = DeidPipeline(lake=lake, ledger=ledger, recompress=False, tracer=tracer, device="cpu")
    pipe.executor.use_kernel = use_kernel
    service = DeidService(broker, source, journal, result_lake=lake, pipeline=pipe,
                          catalog=catalog, ledger=ledger)
    service.register_study("IRB-S", key=KEY)
    dest = StudyStore("researcher")
    pool = WorkerPool(broker, Autoscaler(broker, AutoscalerConfig(), clock),
                      lambda wid: DeidWorker(wid, pipe, source, dest, journal, ledger=ledger,
                                             tracer=worker_tracer))
    return types.SimpleNamespace(study=study, service=service, pool=pool, dest=dest,
                                 journal=journal, pipe=pipe)


def _serve(d):
    query = q.And(q.In("modality", ["CT"]), q.Range("study_date", 19000101, 21001231))
    sel, ticket = d.service.submit_query("IRB-S", query, {d.study.accession: d.study.mrn})
    assert list(sel.accessions) == [d.study.accession]
    d.pool.drain()
    d.service.planner.resolve()
    d.journal.close()
    return ticket


@pytest.mark.parametrize("use_kernel", [None, True])
def test_deployment_records_the_study_tree_on_the_pipeline_tracer(tmp_path, use_kernel):
    tracer = Tracer(WallClock())
    d = _deployment(tmp_path, "tree", tracer, use_kernel=use_kernel)
    _serve(d)
    spans = tracer.spans()
    assert tracer.open_count == 0 and all(sp.t1 is not None for sp in spans)
    names = {sp.name for sp in spans}
    assert set(TREE) | set(TREE.values()) <= names
    by_id = {sp.span_id: sp for sp in spans}
    for sp in spans:
        if sp.name in TREE:
            assert by_id[sp.parent_id].name == TREE[sp.name], sp
    children = defaultdict(list)
    for sp in spans:
        if sp.parent_id is not None:
            parent = by_id[sp.parent_id]
            assert parent.t0 <= sp.t0 <= sp.t1 <= parent.t1, (sp, parent)
            children[sp.parent_id].append(sp)
    for kids in children.values():
        kids.sort(key=lambda s: (s.t0, s.seq))
        for a, b in zip(kids, kids[1:]):
            assert a.t1 <= b.t0, (a, b)
    # two lake spans (gets, then puts) and two commits (the source fetch's
    # record, then the journal's and the ledger's)
    assert [sp.attrs["op"] for sp in tracer.spans("pipeline.lake")] == ["get", "put"]
    assert len(tracer.spans("worker.commit")) == 2
    # the planner reads the finished study back out of the result lake
    (mat,) = tracer.spans("planner.materialize")
    assert mat.attrs["instances"] == len(d.study.datasets)
    path = "scrub_only" if use_kernel else "done"
    assert {sp.attrs["path"] for sp in tracer.spans("kernel.collect")} == {path}
    assert all(sp.attrs["wait_s"] >= 0 for sp in tracer.spans("kernel.collect"))


def test_explicit_tracer_wins_over_the_pipeline_s(tmp_path):
    own, piped = Tracer(WallClock()), Tracer(WallClock())
    d = _deployment(tmp_path, "own", piped, worker_tracer=own)
    _serve(d)
    assert own.spans("worker.process") and own.spans("worker.commit")
    assert not piped.spans("worker.process")
    assert piped.spans("pipeline.run_study") and piped.spans("service.select")


def _delivered(d):
    store = d.dest.store
    return {p: store.get(p) for p in store.list("out/")}


def test_tracing_changes_no_output_byte(tmp_path):
    traced = _deployment(tmp_path, "on", Tracer(WallClock()))
    plain = _deployment(tmp_path, "off", NULL_TRACER)
    _serve(traced)
    _serve(plain)
    out_on, out_off = _delivered(traced), _delivered(plain)
    assert len(out_on) == len(traced.study.datasets) and out_on == out_off
    assert (tmp_path / "on.jsonl").read_bytes() == (tmp_path / "off.jsonl").read_bytes()
    assert not NULL_TRACER.spans()


def test_sim_clock_deployment_records_no_stage_span(tmp_path):
    """The sim's clock: the worker's and service's spans as before, no
    stage span, so a replayed trace keeps its ids."""
    tracer = Tracer(SimClock())
    d = _deployment(tmp_path, "sim", tracer)
    _serve(d)
    names = {sp.name for sp in tracer.spans()}
    assert {"worker.process", "worker.fetch", "worker.deid", "pipeline.run_study",
            "kernel.dispatch", "service.submit_query"} <= names
    stages = {"worker.commit", "pipeline.lake", "pipeline.filter", "pipeline.scrub",
              "pipeline.anonymize", "kernel.collect", "service.select", "planner.materialize"}
    assert not names & stages
    assert by_parent_name(tracer, "kernel.dispatch") == {"pipeline.run_study"}


def by_parent_name(tracer, name):
    by_id = {sp.span_id: sp for sp in tracer.spans()}
    return {by_id[sp.parent_id].name for sp in tracer.spans(name)}


# --------------------------------------------------- the path labels' digest
def test_collect_span_digest_matches_across_paths():
    """The scrub-only collect on the device path and on the host path
    differ in their ``path`` label alone, which ``host_path_digest`` reads
    as the host path's."""
    rng = np.random.default_rng(3)
    items = [((rng.random((40, 64)) * 4000).astype(np.uint16), [(0, 0, 16, 8)]) for _ in range(5)]
    digests, outs = [], []
    for use_kernel in (True, False):
        tracer = Tracer(StillClock())
        ex = BatchedDeidExecutor(max_batch=4, use_kernel=use_kernel, tracer=tracer, device="cpu")
        outs.append([o.pixels.tobytes() for o in ex.run([(p.copy(), r) for p, r in items],
                                                      recompress=False)])
        paths = {sp.attrs["path"] for sp in tracer.spans("kernel.collect")}
        assert paths == {"scrub_only" if use_kernel else "done"}
        assert len(tracer.spans("kernel.collect")) == 2
        digests.append(host_path_digest(tracer.spans()))
    assert outs[0] == outs[1]
    assert digests[0] == digests[1]
