"""The port's observability consumers (``obs/{export,slo,profile,health}``)
and the accounting-of-disclosures report (``audit/report.py``) against the
JAX package's.

Both packages drain the same small cohort on the CPU (the port's studies
are the JAX studies carried across) under a ``SimClock``, with chaos, each
with its own ``Tracer``, ``MetricsRegistry`` and ``AuditLedger``. Their span
lists are equal field for field except the message sizes of
``broker.publish`` / ``broker.redeliver``, which are stored (pickled) study
sizes and name their package's module; each is compared through the
accession it names and replaced by the JAX store's size of that accession.
From there every export must be byte-equal: span and metric JSONL, Chrome
traces, folded profiles; the SLO engines fed the same observations give
the same alert sequence, ``digest()`` and ``replay()``; health reports and
pressure are equal. The disclosure report is equal with its ruleset and
ledger digests compared through what they name (each package's own
pipeline digest and ledger digest, ROADMAP §3), as is the redacted ledger
export with etags named by their accession and lake keys by whether they
are set.
"""
import importlib
import json
import types

import pytest

from repro.dicom.generator import StudyGenerator

from repro_torch.carry import study_from_plain, study_to_plain

N_STUDIES = 5
PROJECT = "IRB-O"


def _package(name):
    def mod(path):
        return importlib.import_module(f"{name}.{path}")

    return types.SimpleNamespace(
        name=name, obs=mod("obs"), audit=mod("audit"), core=mod("core"),
        queueing=mod("queueing"), server=mod("queueing.server"),
        store=mod("storage.object_store"), timing=mod("utils.timing"),
        pipeline_kw={"device": "cpu"} if name == "repro_torch" else {},
    )


JAX, PORT = _package("repro"), _package("repro_torch")


def _drain(pkg, studies, tmp):
    """One small cohort drained with crashes and stragglers: the tracer,
    registry, ledger, source store and pipeline it leaves."""
    q = pkg.queueing
    clock = pkg.timing.SimClock()
    tracer, registry = pkg.obs.Tracer(clock), pkg.obs.MetricsRegistry()
    ledger = pkg.audit.AuditLedger(tmp / f"{pkg.name}.audit", clock=clock)
    source = pkg.store.StudyStore("lake", key=b"at-rest-key")
    mrns = {}
    for s in studies:
        source.put_study(s.accession, s)
        mrns[s.accession] = s.mrn
    broker = q.Broker(clock, visibility_timeout=120, tracer=tracer, registry=registry)
    journal = q.Journal(tmp / f"{pkg.name}.jsonl")
    service = pkg.server.DeidService(broker, source, journal, tracer=tracer, registry=registry,
                                     ledger=ledger)
    pipe = pkg.core.DeidPipeline(tracer=tracer, ledger=ledger, **pkg.pipeline_kw)
    service.register_study(PROJECT, pkg.core.TrustMode.POST_IRB)
    service.submit(PROJECT, list(mrns), mrns)
    dest = pkg.store.StudyStore("researcher")
    pool = q.WorkerPool(
        broker, q.Autoscaler(broker, q.AutoscalerConfig(), clock),
        lambda wid: q.DeidWorker(wid, pipe, source, dest, journal, tracer=tracer, ledger=ledger),
        q.FailureInjector(crash_rate=0.3, straggler_rate=0.3),
        registry=registry,
    )
    report = pool.drain()
    journal.close()
    return types.SimpleNamespace(pkg=pkg, tracer=tracer, registry=registry, ledger=ledger,
                                 source=source, pipeline=pipe, clock=clock, report=report)


@pytest.fixture(scope="module")
def drains(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("obs")
    gen = StudyGenerator(5)
    jax_studies = [gen.gen_study(f"O{i:03d}", n_images=1) for i in range(N_STUDIES)]
    port_studies = [study_from_plain(study_to_plain(s)) for s in jax_studies]
    return _drain(JAX, jax_studies, tmp), _drain(PORT, port_studies, tmp)


SIZED_SPANS = ("broker.publish", "broker.redeliver")


def _named_spans(drain, jax_drain):
    """``drain``'s finished spans, each message size checked against the
    stored size of the accession it names in ``drain``'s own store, then
    replaced by the JAX store's size of that accession."""
    spans = []
    for sp in drain.tracer.spans():
        sp = drain.pkg.obs.Span(**{**sp.to_dict(), "attrs": dict(sp.attrs)})
        if sp.name in SIZED_SPANS and "nbytes" in sp.attrs:
            acc = sp.attrs["key"].split("/", 1)[1]
            assert sp.attrs["nbytes"] == drain.source.study_nbytes(acc), sp
            sp.attrs["nbytes"] = jax_drain.source.study_nbytes(acc)
        spans.append(sp)
    return spans


@pytest.fixture(scope="module")
def spans(drains):
    jax, port = drains
    return _named_spans(jax, jax), _named_spans(port, jax)


def test_drains_leave_the_same_spans(drains, spans):
    jax, port = drains
    j, p = spans
    assert len(p) == len(j) > 0
    assert [s.to_dict() for s in p] == [s.to_dict() for s in j]
    names = {s.name for s in p}
    assert {"worker.process", "kernel.dispatch", "broker.redeliver"} <= names
    assert port.report.crashes == jax.report.crashes > 0
    # the renamed sizes are what made the raw spans differ
    raw = [s.to_dict() for s in port.tracer.spans()]
    assert raw != [s.to_dict() for s in j]


def test_span_jsonl_byte_equal(spans):
    j, p = spans
    got = PORT.obs.export_spans_jsonl(p, PORT.obs.Redactor())
    assert got == JAX.obs.export_spans_jsonl(j, JAX.obs.Redactor())
    assert len(got.splitlines()) == len(p)


def test_metric_jsonl_byte_equal(drains):
    jax, port = drains
    got = PORT.obs.export_metrics_jsonl(port.registry.snapshot(), PORT.obs.Redactor())
    want = JAX.obs.export_metrics_jsonl(jax.registry.snapshot(), JAX.obs.Redactor())
    assert got == want and len(got.splitlines()) > 4


def test_chrome_trace_equal(spans):
    j, p = spans
    got = PORT.obs.to_chrome_trace(p, PORT.obs.Redactor())
    assert json.dumps(got, sort_keys=True) == json.dumps(
        JAX.obs.to_chrome_trace(j, JAX.obs.Redactor()), sort_keys=True)
    assert len(got["traceEvents"]) > 0


def test_exports_audit_themselves_equally(spans, drains, tmp_path):
    """The ``telemetry_export`` ledger hook: each export appends one record
    naming its channel and record count."""
    j, p = spans
    recs = {}
    for pkg, sp, drain in ((JAX, j, drains[0]), (PORT, p, drains[1])):
        led = pkg.audit.AuditLedger(tmp_path / f"{pkg.name}.audit", clock=pkg.timing.SimClock())
        red = pkg.obs.Redactor()
        pkg.obs.export_spans_jsonl(sp, red, ledger=led)
        pkg.obs.export_metrics_jsonl(drain.registry.snapshot(), red, ledger=led)
        pkg.obs.to_chrome_trace(sp, red, ledger=led)
        recs[pkg.name] = led.records()
        assert led.verify() == []
    assert recs["repro_torch"] == recs["repro"]
    assert [r["kind"] for r in recs["repro"]] == ["telemetry_export"] * 3


REDACTOR_CASES = [
    {"accession": "O001", "modality": "CT", "nbytes": 5},
    {"patient": "DOE^JOHN", "note": "free text with spaces", "key": "IRB-O/O001"},
    {"modality": "x" * 64, "shape": "x" * 65, "dtype": "", "path": "ü"},
    {"rects": [[1, 2, 3, 4], ["DOE^JANE"]], "t": 1.5, "ok": True, "busy_s": None},
]


@pytest.mark.parametrize("attrs", REDACTOR_CASES)
def test_redactor_equal(attrs):
    assert PORT.obs.Redactor().attrs(attrs) == JAX.obs.Redactor().attrs(attrs)
    for v in attrs.values():
        assert PORT.obs.Redactor().safe_value(v) == JAX.obs.Redactor().safe_value(v)


def _profilers(spans):
    j, p = spans
    jp, pp = JAX.obs.CriticalPathProfiler(), PORT.obs.CriticalPathProfiler()
    assert pp.fold(p) == jp.fold(j) > 0
    assert pp.fold(p) == jp.fold(j) == 0  # folding is idempotent
    return jp, pp


def test_profiles_equal(spans):
    jp, pp = _profilers(spans)
    assert pp.profile() == jp.profile()
    assert pp.top_stages(3) == jp.top_stages(3) and pp.top_stages(3)
    assert pp.digest() == jp.digest()
    got = pp.export_folded(PORT.obs.Redactor())
    assert got == jp.export_folded(JAX.obs.Redactor()) and got
    assert json.dumps(pp.to_chrome_trace(), sort_keys=True) == json.dumps(
        jp.to_chrome_trace(), sort_keys=True)


def _stream(kind):
    """Identical observations for both engines: (t, value or (good, bad))."""
    if kind == "latency_storm":
        # healthy, a storm of slow serves (fires), then recovery (resolves)
        return ([(float(t), 0.5) for t in range(0, 300, 3)]
                + [(float(t), 9.0) for t in range(300, 420, 2)]
                + [(float(t), 0.5) for t in range(420, 900, 3)])
    if kind == "counts":
        return [(float(t), (10, 6 if 200 <= t < 320 else 0)) for t in range(0, 700, 10)]
    return [(float(t), 0.25 + (t % 7) * 0.01) for t in range(0, 400, 5)]


def _engine_run(pkg, kind, serve_obs):
    obs = pkg.obs
    eng = obs.SloEngine([
        obs.SloSpec("cold_serve", objective=0.9, threshold=1.0, kind="latency",
                    rules=obs.default_burn_rules(1.0 / 60.0)),
        obs.SloSpec("dlq_rate", objective=0.99, kind="ratio",
                    rules=obs.default_burn_rules(1.0 / 60.0)),
    ])
    alerts = []
    for t, v in _stream(kind):
        if isinstance(v, tuple):
            eng.observe_counts("dlq_rate", t=t, good=v[0], bad=v[1])
        else:
            eng.observe("cold_serve", t=t, value=v)
        alerts += eng.evaluate(t)
    for t, _key, latency in serve_obs:
        eng.observe("cold_serve", t=1000.0 + t, value=latency)
    alerts += eng.evaluate(2000.0)
    return eng, alerts


@pytest.mark.parametrize("kind", ["latency_storm", "counts", "quiet"])
def test_slo_engines_equal(spans, kind):
    j, p = spans
    serve = PORT.obs.derive_serve_observations(p)
    assert serve == JAX.obs.derive_serve_observations(j) and serve
    je, ja = _engine_run(JAX, kind, serve)
    pe, pa = _engine_run(PORT, kind, serve)
    assert [a.to_dict() for a in pa] == [a.to_dict() for a in ja]
    if kind != "quiet":
        assert {a.action for a in pa} == {"fire", "resolve"}
    assert pe.digest() == je.digest()
    assert pe.replay().digest() == pe.digest() == je.replay().digest()
    assert pe.states() == je.states()
    assert pe.active_alerts() == je.active_alerts()
    for name in ("cold_serve", "dlq_rate"):
        assert pe.budget_remaining(name, 2000.0) == je.budget_remaining(name, 2000.0)


@pytest.mark.parametrize("kind", ["latency_storm", "counts", "quiet"])
@pytest.mark.parametrize("t", [350.0, 2000.0])
def test_health_equal(spans, kind, t):
    jp, pp = _profilers(spans)
    serve = PORT.obs.derive_serve_observations(spans[1])
    ctrl = {}
    for pkg, prof in ((JAX, jp), (PORT, pp)):
        eng, _ = _engine_run(pkg, kind, serve)
        ctrl[pkg.name] = pkg.obs.HealthController(eng, prof)
    jc, pc = ctrl["repro"], ctrl["repro_torch"]
    assert pc.snapshot(t).to_dict() == jc.snapshot(t).to_dict()
    assert pc.snapshot(t).summary() == jc.snapshot(t).summary()
    assert pc.pressure() == jc.pressure() >= 1.0


def _named_report_dict(drain):
    """``DisclosureReport.to_dict()`` with the ruleset and ledger digests
    checked against what they name in ``drain`` and replaced by a label."""
    rep = drain.pkg.audit.DisclosureReport.from_ledger(drain.ledger)
    d = rep.to_dict()
    assert d.pop("ledger_digest") == drain.ledger.digest()
    digest = drain.pipeline.ruleset_fingerprint().digest
    for acct in d["projects"].values():
        assert acct["rulesets"] == [digest]
        acct["rulesets"] = ["ruleset"]
    return rep, d


def test_disclosure_report_equal(drains):
    jax, port = drains
    (jrep, jd), (prep, pd) = _named_report_dict(jax), _named_report_dict(port)
    assert pd == jd
    acct = pd["projects"][PROJECT]
    assert acct["deliveries"] == N_STUDIES and acct["cold"] == N_STUDIES
    assert acct["accessions"] == [f"O{i:03d}" for i in range(N_STUDIES)]
    # the redacted lines: the same, up to the two named digests
    for jl, pl in zip(jrep.to_jsonl(JAX.obs.Redactor()).splitlines(),
                      prep.to_jsonl(PORT.obs.Redactor()).splitlines(), strict=True):
        j, p = json.loads(jl), json.loads(pl)
        for rec, drain in ((j, jax), (p, port)):
            if "totals" in rec:
                assert rec["totals"].pop("ledger_digest") == drain.ledger.digest()
            else:
                assert rec["rulesets"] == [drain.pipeline.ruleset_fingerprint().digest]
                rec.pop("rulesets")
        assert p == j


def _named_ledger_line(drain, line):
    rec = json.loads(line)
    etags = {drain.source.study_etag(a): a for a in drain.source.accessions()}
    for f in ("sha", "prev_sha"):
        rec.pop(f)
    if "ruleset" in rec:
        assert rec.pop("ruleset") == drain.pipeline.ruleset_fingerprint().digest
    if "lake_key" in rec:
        rec["lake_key"] = bool(rec["lake_key"])
    if rec.get("etag") is not None:
        rec["etag"] = ("etag of", etags[rec["etag"]])
    return rec


def test_ledger_export_equal(drains):
    jax, port = drains
    j = JAX.audit.export_ledger_jsonl(jax.ledger, JAX.obs.Redactor()).splitlines()
    p = PORT.audit.export_ledger_jsonl(port.ledger, PORT.obs.Redactor()).splitlines()
    assert len(p) == len(j) == len(port.ledger) > 0
    assert ([_named_ledger_line(port, line) for line in p]
            == [_named_ledger_line(jax, line) for line in j])
