"""The port's fleet on its own (``device="cpu"``): same-seed runs replay bit
for bit (event log, metrics, trace and audit digests), and every invariant
checker of ``repro_torch.sim`` catches the violation ``tests/test_sim.py``
injects into a run of the JAX package's fleet — a checker that cannot fail
is not a check."""
import hashlib
import json
import pickle
from dataclasses import replace

import pytest

from repro_torch.audit.records import INGEST_APPLY, canonical_json
from repro_torch.audit.report import DisclosureReport
from repro_torch.core.pipeline import build_request
from repro_torch.lake.planner import _InFlight
from repro_torch.obs.export import REDACTED, Redactor
from repro_torch.obs.trace import Span
from repro_torch.sim import (
    AuditCompleteness,
    AutoscalerAccounting,
    BurstyTraffic,
    ChaosEvent,
    ChaosSchedule,
    CheckpointMonotonicity,
    CohortArrival,
    ExactlyOnceDelivery,
    FleetConfig,
    FleetSim,
    Freshness,
    JournalDurability,
    LakeConsistency,
    MetricsConservation,
    NoFullReingest,
    NoWedgedSubscribers,
    PhiBoundary,
    QueryConsistency,
    QueryMix,
    ReplayStorm,
    TraceIntegrity,
    WarmReplayIdentity,
)


def _corpus(n):
    return [f"SIM{i:04d}" for i in range(n)]


def _tiny(tmp_path, name, seed=5, n_studies=3, traffic=None, chaos=None, **cfg_kw):
    cfg = FleetConfig(seed=seed, n_studies=n_studies, images_per_study=1, **cfg_kw)
    if traffic is None:
        traffic = [CohortArrival(t=0.0, study_id="IRB-T", accessions=tuple(_corpus(n_studies)))]
    return FleetSim(cfg, traffic, tmp_path / f"{name}.jsonl", chaos, device="cpu")


def _chaos_sim(tmp_path, name, seed=9, **cfg_kw):
    traffic = BurstyTraffic(n_bursts=2, cohorts_per_burst=2, cohort_size=3).schedule(
        _corpus(5), seed=seed)
    chaos = ChaosSchedule.seeded(seed, horizon=400.0, corpus=_corpus(5))
    return _tiny(tmp_path, name, seed=seed, n_studies=5, traffic=traffic, chaos=chaos, **cfg_kw)


def _feed_sim(tmp_path, name, seed=11):
    traffic = BurstyTraffic(n_bursts=2, cohorts_per_burst=2, cohort_size=3).schedule(
        _corpus(6), seed)
    chaos = ChaosSchedule.seeded(seed, 600.0, _corpus(6), crash_events=1, reingests=2,
                                 lease_storms=1, pooler_crashes=2, feed_outages=1,
                                 feed_faults=1)
    return _tiny(tmp_path, name, seed=seed, n_studies=6, traffic=traffic, chaos=chaos,
                 feed_mutations=12)


def _digests(report):
    return (report.log_digest, report.metrics, report.trace_digest, report.audit, report.slo)


# ------------------------------------------------------------- replay
class TestReplayability:
    def test_same_seed_same_digests(self, tmp_path):
        r1 = _chaos_sim(tmp_path, "a").run()
        r2 = _chaos_sim(tmp_path, "b").run()
        assert r1.ok() and r2.ok()
        assert _digests(r1) == _digests(r2)

    def test_feed_chaos_is_bit_replayable(self, tmp_path):
        r1 = _feed_sim(tmp_path, "fa").run()
        r2 = _feed_sim(tmp_path, "fb").run()
        assert r1.ok(), [v.detail for v in r1.violations]
        assert _digests(r1) == _digests(r2)

    def test_query_sim_is_replayable(self, tmp_path):
        traffic = QueryMix(n_queries=4).schedule(_corpus(5), seed=3)

        def run(name):
            return _tiny(tmp_path, name, seed=3, n_studies=5, traffic=traffic,
                         modality=None, delivery_window=3600.0).run()

        assert _digests(run("qa")) == _digests(run("qb"))

    def test_different_seed_different_digests(self, tmp_path):
        r1 = _chaos_sim(tmp_path, "s1", seed=3).run()
        r2 = _chaos_sim(tmp_path, "s2", seed=4).run()
        assert r1.log_digest != r2.log_digest
        assert r1.trace_digest != r2.trace_digest
        assert r1.audit["digest"] != r2.audit["digest"]

    def test_trace_and_audit_off_change_no_behavior(self, tmp_path):
        on = _chaos_sim(tmp_path, "on").run()
        off = _chaos_sim(tmp_path, "off", trace=False, audit=False).run()
        assert (on.log_digest, on.metrics) == (off.log_digest, off.metrics)
        assert off.ok()
        assert off.trace_digest == hashlib.sha256(b"").hexdigest()
        assert off.audit == {"enabled": False}

    def test_event_log_is_json_serializable(self, tmp_path):
        sim = _tiny(tmp_path, "ser")
        sim.run()
        for line in sim.log.to_jsonl().splitlines():
            json.loads(line)


# ------------------------------------------------- negative controls
class TestCheckersCatchInjectedViolations:
    def test_exactly_once_catches_double_count(self, tmp_path):
        sim = _tiny(tmp_path, "eo")
        assert sim.run().ok()
        sim.pool._all_workers[0].processed += 1
        assert any("processed" in v.detail for v in ExactlyOnceDelivery().check(sim))

    def test_exactly_once_catches_missing_bucket_output(self, tmp_path):
        sim = _tiny(tmp_path, "eo2")
        assert sim.run().ok()
        sim.dest.store.delete(sim.dest.store.list("out/")[0])
        assert any("researcher bucket holds" in v.detail
                   for v in ExactlyOnceDelivery().check(sim))

    def test_phi_boundary_catches_planted_phi(self, tmp_path):
        sim = _tiny(tmp_path, "phi")
        assert sim.run().ok()
        leaked = sim.source.get_study("SIM0000").datasets[0]
        sim.dest.store.put("out/IRB-T/LEAK/1", pickle.dumps(leaked))
        assert any("MRN" in v.detail or "patient name" in v.detail
                   for v in PhiBoundary().check(sim))

    def test_phi_boundary_text_band_audit_catches_planted_text(self, tmp_path):
        sim = _tiny(tmp_path, "plant")
        assert sim.run().ok()
        path = sim.dest.store.list("out/")[0]
        ds = pickle.loads(sim.dest.store.get(path))
        H, W = ds.pixels.shape
        ds.pixels[H // 2 : H // 2 + 12, ::3] = 4095
        sim.dest.store.put(path, pickle.dumps(ds))
        assert any("text band" in v.detail for v in PhiBoundary().check(sim))

    def test_warm_replay_catches_tampered_cache(self, tmp_path):
        traffic = [CohortArrival(0.0, "IRB-T", tuple(_corpus(3))),
                   CohortArrival(120.0, "IRB-T", tuple(_corpus(3)))]
        sim = _tiny(tmp_path, "warm", traffic=traffic)
        assert sim.run().ok()
        ticket = next(t for _, t in sim.tickets if t.hits and t.outputs)
        acc = next(a for a in ticket.hits if a in ticket.outputs)
        ticket.outputs[acc][0].elements["StudyID"] = "TAMPERED"
        assert any(acc in v.detail for v in WarmReplayIdentity().check(sim))

    def test_autoscaler_accounting_catches_fudged_integral(self, tmp_path):
        sim = _tiny(tmp_path, "cost")
        assert sim.run().ok()
        sim.pool.autoscaler.instance_seconds += 7.0
        assert any("integral" in v.detail for v in AutoscalerAccounting().check(sim))

    def test_no_wedged_subscribers_catches_ghost_registration(self, tmp_path):
        sim = _tiny(tmp_path, "wedge")
        assert sim.run().ok()
        _, ticket = sim.tickets[0]
        pseudo = sim.service._studies[ticket.study_id]
        req = build_request(pseudo, "SIM0000", sim.mrns["SIM0000"])
        sim.service.planner._inflight["IRB-T/GHOST"] = _InFlight("GHOST", req, [ticket])
        ticket.pending.add("ORPHAN")
        violations = NoWedgedSubscribers().check(sim)
        assert any("IRB-T/GHOST" in v.detail for v in violations)
        assert any("ORPHAN" in v.detail and "wedged" in v.detail for v in violations)

    def test_lake_consistency_catches_lost_backing_blob(self, tmp_path):
        sim = _tiny(tmp_path, "lake")
        assert sim.run().ok()
        sim.lake.backend.delete(sim.lake.keys()[0])
        assert any("no backing blob" in v.detail for v in LakeConsistency().check(sim))

    def test_journal_durability_catches_unsynced_state(self, tmp_path):
        sim = _tiny(tmp_path, "journal")
        assert sim.run().ok()
        sim.journal._fh.write(json.dumps({"kind": "done", "key": "IRB-T/PHANTOM",
                                          "manifest": {"request_id": "x", "entries": []}}) + "\n")
        sim.journal._fh.flush()
        assert any("PHANTOM" in v.detail for v in JournalDurability().check(sim))

    def test_query_consistency_catches_tampered_selection(self, tmp_path):
        traffic = QueryMix(n_queries=3).schedule(_corpus(4), seed=9)
        sim = _tiny(tmp_path, "query", seed=9, n_studies=4, traffic=traffic,
                    modality=None, delivery_window=3600.0)
        assert sim.run().ok()
        qi = next(i for i, (_, sel, _) in enumerate(sim.query_log) if sel.accessions)
        arr, sel, snap = sim.query_log[qi]
        tampered = replace(sel, accessions=sel.accessions[1:],
                           instance_counts={a: sel.instance_counts[a] for a in sel.accessions[1:]})
        sim.query_log[qi] = (arr, tampered, snap)
        assert any("brute-force" in v.detail for v in QueryConsistency().check(sim))

    def test_trace_integrity_catches_open_and_dangling_spans(self, tmp_path):
        sim = _tiny(tmp_path, "trace")
        assert sim.run().ok()
        sim.tracer.span("left.open")
        sim.tracer.finished.append(Span(trace_id="rootdeadbeef", span_id="s99999999",
                                        parent_id="s88888888", name="orphan", t0=1.0, t1=2.0,
                                        seq=99999999))
        violations = TraceIntegrity().check(sim)
        assert any("still open" in v.detail for v in violations)
        assert any("dangling parent" in v.detail for v in violations)

    def test_trace_integrity_catches_untraced_completion(self, tmp_path):
        sim = _tiny(tmp_path, "trace2")
        assert sim.run().ok()
        span = next(s for s in sim.tracer.spans("worker.process") if s.attrs.get("ok"))
        span.attrs["key"] = "IRB-T/FORGED"
        assert any("no worker.process span" in v.detail for v in TraceIntegrity().check(sim))


class TestFeedChaosRuns:
    def test_checkpoint_checker_catches_double_apply_and_phantom(self, tmp_path):
        sim = _feed_sim(tmp_path, "ckpt")
        assert sim.run().ok()
        for seq in (1, 9999):
            sim.pooler.checkpoint._append({"kind": "op", "seq": seq, "accession": "X", "etag": "",
                                           "op": "update", "outcome": "applied", "rows": 0})
        details = [v.detail for v in CheckpointMonotonicity().check(sim)]
        assert any("more than one outcome" in d for d in details)
        assert any("never-committed" in d for d in details)

    def test_freshness_checker_catches_stale_delivery(self, tmp_path):
        sim = _feed_sim(tmp_path, "fresh")
        assert sim.run().ok()
        latest = {m["accession"]: m for m in sim.mutation_log}
        mut = next(m for m in latest.values() if m["etag"])
        sim.delivery_log.append({"seq": sim._order_seq + 1, "t": 999.0, "key": "IRB-X/FORGED",
                                 "accession": mut["accession"], "etag": "0" * 64})
        assert any("stale bytes delivered" in v.detail for v in Freshness().check(sim))

    def test_freshness_checker_catches_post_delete_delivery(self, tmp_path):
        sim = _feed_sim(tmp_path, "freshdel")
        assert sim.run().ok()
        sim.mutation_log.append({"seq": sim._order_seq + 1, "t": 998.0,
                                 "accession": "SIM0000", "etag": None})
        sim.delivery_log.append({"seq": sim._order_seq + 2, "t": 999.0, "key": "IRB-X/GHOST",
                                 "accession": "SIM0000", "etag": "0" * 64})
        assert any("deleted" in v.detail for v in Freshness().check(sim))

    def test_no_full_reingest_catches_catalog_rebuild(self, tmp_path):
        sim = _feed_sim(tmp_path, "rebuild")
        assert sim.run().ok()
        sim.source.attach_catalog(sim.catalog)
        assert any("more work than the changed rows" in v.detail
                   for v in NoFullReingest().check(sim))


class TestTelemetryPhiBoundary:
    def test_redaction_on_passes_with_planted_phi(self, tmp_path):
        report = _tiny(tmp_path, "red_on", plant_telemetry_phi=True).run()
        assert report.ok(), [v.detail for v in report.violations]

    def test_negative_control_redaction_off_fails(self, tmp_path):
        report = _tiny(tmp_path, "red_off", plant_telemetry_phi=True,
                       telemetry_redact=False).run()
        tel = [v for v in report.violations if v.checker == "telemetry_phi_boundary"]
        assert tel and any("MRN" in v.detail or "patient name" in v.detail for v in tel)

    def test_exported_spans_carry_no_free_text(self, tmp_path):
        sim = _tiny(tmp_path, "clean")
        assert sim.run().ok()
        red = Redactor()
        for s in sim.tracer.spans():
            for k, v in red.attrs(s.attrs).items():
                assert v != REDACTED, (s.name, k, s.attrs[k])


class TestMetricsConservation:
    @pytest.mark.parametrize("tamper", ["minted_broker_copy", "lost_planner_admission",
                                        "unhandled_delivery"])
    def test_negative_control(self, tmp_path, tamper):
        sim = _tiny(tmp_path, tamper)
        assert sim.run().ok()
        assert not MetricsConservation().check(sim)
        if tamper == "minted_broker_copy":
            sim.broker.counters.published += 1
            want = "copy conservation"
        elif tamper == "lost_planner_admission":
            sim.service.planner.stats.accessions += 1
            want = "planner admission"
        else:
            sim.pool._all_workers[0].deduped += 1
            want = "delivery accounting"
        assert any(want in v.detail for v in MetricsConservation().check(sim))


class TestAuditLedgerSim:
    def test_audit_completeness_green_under_chaos(self, tmp_path):
        sim = _chaos_sim(tmp_path, "aud")
        report = sim.run()
        assert report.ok(), [v.detail for v in report.violations]
        assert report.audit["by_kind"]["provenance"] >= 1
        assert report.audit["by_kind"]["delivery"] >= 1
        assert sim.ledger.verify() == []

    def test_negative_control_tampered_ledger_fails_verify(self, tmp_path):
        sim = _tiny(tmp_path, "tamper")
        assert sim.run().ok()
        lines = sim.ledger.path.read_text().splitlines()
        mid = len(lines) // 2
        rec = json.loads(lines[mid])
        rec["t"] = float(rec["t"]) + 1.0
        lines[mid] = canonical_json(rec)
        sim.ledger.path.write_text("\n".join(lines) + "\n")
        assert any("sha mismatch" in p for p in sim.ledger.verify())
        assert any(v.detail.startswith("chain:") and "mutated" in v.detail
                   for v in AuditCompleteness().check(sim))

    def test_negative_control_deleted_record_breaks_chain(self, tmp_path):
        sim = _tiny(tmp_path, "del")
        assert sim.run().ok()
        lines = sim.ledger.path.read_text().splitlines()
        del lines[len(lines) // 2]
        sim.ledger.path.write_text("\n".join(lines) + "\n")
        assert any("chain:" in v.detail for v in AuditCompleteness().check(sim))

    def test_negative_control_dropped_provenance_fires(self, tmp_path):
        report = _tiny(tmp_path, "drop", audit_drop_provenance=True).run()
        aud = [v for v in report.violations if v.checker == "audit_completeness"]
        assert any(v.detail.startswith("journal:") for v in aud)
        assert any(v.detail.startswith("event log:") for v in aud)

    def test_negative_control_lake_counter_tamper(self, tmp_path):
        sim = _tiny(tmp_path, "lakec")
        assert sim.run().ok()
        sim.lake.stats.bytes_out += 1
        assert any("lake:" in v.detail and "bytes_out" in v.detail
                   for v in AuditCompleteness().check(sim))

    def test_negative_control_dlq_tamper(self, tmp_path):
        chaos = ChaosSchedule([ChaosEvent(0.0, "crash_keys", {"accessions": ["SIM0001"]})])
        sim = _tiny(tmp_path, "dlq", chaos=chaos, max_deliveries=1)
        report = sim.run()
        assert report.ok() and report.metrics["dead_lettered"] == 1
        sim.broker.dead_letter.pop()
        assert any(v.detail.startswith("dlq:") for v in AuditCompleteness().check(sim))

    def test_negative_control_forged_ingest_record(self, tmp_path):
        sim = _tiny(tmp_path, "ingest", feed_mutations=4)
        assert sim.run().ok()
        sim.ledger.append(INGEST_APPLY, feed_seq=999999, accession="FORGED", etag="e",
                          op="update", outcome="applied", rows=1)
        assert any(v.detail.startswith("ingest:") for v in AuditCompleteness().check(sim))

    def test_disclosure_report_accounts_every_delivery(self, tmp_path):
        sim = _chaos_sim(tmp_path, "disc")
        assert sim.run().ok()
        rep = DisclosureReport.from_ledger(sim.ledger)
        assert sum(a.deliveries for a in rep.projects.values()) == len(sim.delivery_log)
        assert rep.ledger_digest == sim.ledger.digest()


def test_replay_storm_runs_green(tmp_path):
    traffic = ReplayStorm(base_size=3, n_replays=2, cohort_size=3).schedule(_corpus(4), 2)
    report = _tiny(tmp_path, "storm", seed=2, n_studies=4, traffic=traffic).run()
    assert report.ok(), [v.detail for v in report.violations]
    assert report.metrics["planner_lake_hits"] > 0
