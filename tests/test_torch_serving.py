"""The port's serving layer against the JAX package's.

* Broker, journal (torn tail), autoscaler and ``AuditLedger`` chain and
  tamper cases, written once and run against both packages (the ``pkg``
  fixture), mirroring ``tests/test_queueing.py`` and ``tests/test_audit.py``.
* Query-then-de-identify end to end, built as ``tests/test_catalog.py``
  builds it, with a ledger: the JAX stack on the generator's studies and the
  port's stack (``device="cpu"``) on the same studies carried across as
  plain values must give the same selection, the same ticket partition,
  the same delivered tags and pixels, the same merged manifest and the same
  ledger records; the replay of the query is fully warm with no publish.

What differs between the packages, and how it is compared:

* ``RulesetFingerprint.config_sha``, hence the ruleset digest and every lake
  key: the blank function's identity names its module. Pinned below; a
  result lake is not shared between the packages.
* Source etags: a ``StudyStore`` pickles the study object, whose class names
  its module, so the at-rest bytes, their etag and size differ. Etag fields
  are compared as the accession whose stored study they name, and the
  selection digest by re-ingesting the port's studies under the JAX etags.
* Stored sizes: lake records are pickles too (``nbytes`` of the lake
  record kinds), and a drain's ``bytes_in`` sums the stored study blobs.
"""
import dataclasses
import json
import types

import numpy as np
import pytest

import repro.audit.ledger as jax_ledger_mod
import repro.audit.records as jax_records
import repro.core as jax_core
import repro.core.manifest as jax_manifest
import repro.queueing as jax_queueing
import repro.utils.timing as jax_timing
from repro.catalog import StudyCatalog as JaxCatalog
from repro.catalog import query as jax_query
from repro.detect import DetectorPolicy as JaxPolicy
from repro.dicom.generator import StudyGenerator
from repro.lake import ResultLake as JaxLake
from repro.queueing.server import DeidService as JaxService
from repro.storage.object_store import StudyStore as JaxStore

import repro_torch.audit.ledger as port_ledger_mod
import repro_torch.audit.records as port_records
import repro_torch.core as port_core
import repro_torch.core.manifest as port_manifest
import repro_torch.queueing as port_queueing
import repro_torch.utils.timing as port_timing
from repro_torch.carry import study_from_plain, study_to_plain
from repro_torch.catalog import StudyCatalog
from repro_torch.catalog import query as port_query
from repro_torch.detect import DetectorPolicy
from repro_torch.lake import ResultLake
from repro_torch.queueing.server import DeidService
from repro_torch.storage.object_store import StudyStore


def _namespace(ledger_mod, records, queueing, timing, manifest):
    return types.SimpleNamespace(
        AuditLedger=ledger_mod.AuditLedger, NullLedger=ledger_mod.NullLedger,
        NULL_LEDGER=ledger_mod.NULL_LEDGER, GENESIS_SHA=ledger_mod.GENESIS_SHA,
        records=records, Broker=queueing.Broker, Autoscaler=queueing.Autoscaler,
        AutoscalerConfig=queueing.AutoscalerConfig, Journal=queueing.Journal,
        SimClock=timing.SimClock, Manifest=manifest.Manifest,
    )


PACKAGES = {
    "jax": _namespace(jax_ledger_mod, jax_records, jax_queueing, jax_timing, jax_manifest),
    "torch": _namespace(port_ledger_mod, port_records, port_queueing, port_timing, port_manifest),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


# ------------------------------------------------------------------- broker
class TestBroker:
    def test_lease_ack_lifecycle(self, pkg):
        b = pkg.Broker(pkg.SimClock(), visibility_timeout=10)
        b.publish("k1", {"x": 1}, nbytes=100)
        msgs = b.pull("w0")
        assert len(msgs) == 1 and b.stats().leased == 1
        assert b.ack(msgs[0].msg_id)
        assert b.empty()

    def test_lease_expiry_redelivers(self, pkg):
        clock = pkg.SimClock()
        b = pkg.Broker(clock, visibility_timeout=10)
        b.publish("k1", {}, nbytes=1)
        b.pull("w0")
        clock.advance(11)
        msgs = b.pull("w1")
        assert len(msgs) == 1 and msgs[0].deliveries == 2
        assert b.total_redelivered == 1

    def test_dead_letter_after_max_deliveries(self, pkg):
        clock = pkg.SimClock()
        b = pkg.Broker(clock, visibility_timeout=5, max_deliveries=3)
        b.publish("poison", {}, nbytes=1)
        for _ in range(3):
            b.pull("w0")
            clock.advance(6)
        b.pull("w0")
        assert b.stats().dead_lettered == 1
        assert b.empty()

    def test_nack_immediate_redelivery(self, pkg):
        b = pkg.Broker(pkg.SimClock())
        b.publish("k", {}, nbytes=1)
        m = b.pull("w0")[0]
        b.nack(m.msg_id)
        assert b.stats().available == 1

    def test_ack_after_expiry_is_noop(self, pkg):
        clock = pkg.SimClock()
        b = pkg.Broker(clock, visibility_timeout=5)
        b.publish("k", {}, nbytes=1)
        m = b.pull("w0")[0]
        clock.advance(6)
        b.pull("w1")
        assert not b.ack(m.msg_id)

    def test_dead_letter_bytes_leave_backlog_on_expiry(self, pkg):
        clock = pkg.SimClock()
        b = pkg.Broker(clock, visibility_timeout=5, max_deliveries=3)
        b.publish("poison", {}, nbytes=1000)
        for _ in range(3):
            b.pull("w0")
            clock.advance(6)
        b.publish("live", {}, nbytes=10)
        s = b.stats()
        assert s.dead_lettered == 1
        assert s.dead_letter_bytes == 1000
        assert s.backlog_bytes == 10

    def test_dead_letter_bytes_leave_backlog_on_nack(self, pkg):
        b = pkg.Broker(pkg.SimClock(), max_deliveries=1)
        b.publish("poison", {}, nbytes=500)
        m = b.pull("w0")[0]
        b.nack(m.msg_id)
        s = b.stats()
        assert s.dead_lettered == 1 and s.dead_letter_bytes == 500
        assert s.backlog_bytes == 0 and b.empty()

    def test_extend_lease_after_expiry_returns_false(self, pkg):
        clock = pkg.SimClock()
        b = pkg.Broker(clock, visibility_timeout=5)
        b.publish("k", {}, nbytes=1)
        m = b.pull("w0")[0]
        assert b.extend_lease(m.msg_id, 10)
        clock.advance(16)
        assert not b.extend_lease(m.msg_id, 10)


# --------------------------------------------------------------- autoscaler
class TestAutoscaler:
    def test_scales_with_backlog_and_window(self, pkg):
        clock = pkg.SimClock()
        b = pkg.Broker(clock)
        cfg = pkg.AutoscalerConfig(delivery_window=3600, per_instance_throughput=1e6,
                                   max_instances=16)
        a = pkg.Autoscaler(b, cfg, clock)
        b.publish("k", {}, nbytes=10 * 3600 * 1_000_000)
        assert a.tick() == 10

    def test_empty_queue_deletes_pool(self, pkg):
        clock = pkg.SimClock()
        b = pkg.Broker(clock)
        a = pkg.Autoscaler(b, pkg.AutoscalerConfig(min_instances=0), clock)
        b.publish("k", {}, nbytes=10**9)
        assert a.tick() >= 1
        m = b.pull("w0")[0]
        b.ack(m.msg_id)
        assert a.tick() == 0

    def test_window_pressure_increases_target(self, pkg):
        clock = pkg.SimClock()
        b = pkg.Broker(clock, visibility_timeout=10**6)
        cfg = pkg.AutoscalerConfig(delivery_window=1000, per_instance_throughput=1e6,
                                   max_instances=1000)
        a = pkg.Autoscaler(b, cfg, clock)
        b.publish("k", {}, nbytes=500 * 1_000_000)
        t_early = a.tick()
        clock.advance(900)
        assert a.tick() > t_early

    def test_does_not_scale_against_dead_work(self, pkg):
        clock = pkg.SimClock()
        b = pkg.Broker(clock, max_deliveries=1)
        a = pkg.Autoscaler(b, pkg.AutoscalerConfig(min_instances=0, per_instance_throughput=1e6),
                           clock)
        b.publish("poison", {}, nbytes=10**12)
        assert a.tick() > 0
        m = b.pull("w0")[0]
        b.nack(m.msg_id)
        assert b.stats().dead_letter_bytes == 10**12
        assert a.tick() == 0

    def test_cost_accounting(self, pkg):
        clock = pkg.SimClock()
        b = pkg.Broker(clock)
        cfg = pkg.AutoscalerConfig(per_instance_throughput=1e6, instance_cost_per_hour=1.0)
        a = pkg.Autoscaler(b, cfg, clock)
        b.publish("k", {}, nbytes=3600 * 1_000_000)
        a.tick()
        clock.advance(3600)
        a.tick()
        assert a.cost_usd() == pytest.approx(a.instance_seconds / 3600)

    def test_scale_down_hysteresis(self, pkg):
        clock = pkg.SimClock()
        b = pkg.Broker(clock, visibility_timeout=10**6)
        cfg = pkg.AutoscalerConfig(delivery_window=10**6, per_instance_throughput=1.0,
                                   max_instances=100, scale_down_cooldown=120.0)
        a = pkg.Autoscaler(b, cfg, clock)

        def swap_backlog(nbytes):
            msg = b.pull("w0")[0]
            b.publish(f"k{nbytes}", {}, nbytes=nbytes)
            b.ack(msg.msg_id)

        b.publish("big", {}, nbytes=9_500_000)
        assert a.tick() == 10
        swap_backlog(4_500_000)
        clock.advance(10)
        assert a.tick() == 5
        swap_backlog(2_200_000)
        clock.advance(10)
        assert a.tick() == 5
        clock.advance(130)
        assert a.tick() == 3

    def test_empty_queue_bypasses_cooldown(self, pkg):
        clock = pkg.SimClock()
        b = pkg.Broker(clock)
        cfg = pkg.AutoscalerConfig(delivery_window=10**6, per_instance_throughput=1.0,
                                   scale_down_cooldown=10**9, max_instances=8)
        a = pkg.Autoscaler(b, cfg, clock)
        b.publish("k", {}, nbytes=5 * 10**6)
        assert a.tick() == 5
        m = b.pull("w0")[0]
        b.ack(m.msg_id)
        clock.advance(1)
        assert a.tick() == 0

    def test_instance_seconds_irregular_tick_spacing(self, pkg):
        clock = pkg.SimClock()
        b = pkg.Broker(clock, visibility_timeout=10**9)
        cfg = pkg.AutoscalerConfig(delivery_window=10**9, per_instance_throughput=1.0,
                                   max_instances=100, scale_down_cooldown=0.0)
        a = pkg.Autoscaler(b, cfg, clock)
        b.publish("k", {}, nbytes=3_500_000_000)
        a.tick()
        clock.advance(7)
        a.tick()
        clock.advance(11)
        a.tick()
        m = b.pull("w0")[0]
        b.ack(m.msg_id)
        clock.advance(1000)
        a.tick()
        clock.advance(50)
        a.tick()
        assert a.instance_seconds == pytest.approx(4 * (7 + 11 + 1000))
        log = a.tick_log
        integral = sum(n * (log[i + 1][0] - log[i][0]) for i, (_, n) in enumerate(log[:-1]))
        assert integral == pytest.approx(a.instance_seconds)

    def test_first_tick_never_bills(self, pkg):
        clock = pkg.SimClock()
        b = pkg.Broker(clock)
        a = pkg.Autoscaler(b, pkg.AutoscalerConfig(), clock)
        clock.advance(10_000)
        a.tick()
        assert a.instance_seconds == 0.0


# ------------------------------------------------------------------ journal
class TestJournalTornTail:
    def test_truncated_final_record_is_repaired(self, pkg, tmp_path):
        p = tmp_path / "j.jsonl"
        j = pkg.Journal(p)
        j.record_done("IRB-9/K1", pkg.Manifest("IRB-9"), "w0")
        j.close()
        with open(p, "ab") as fh:
            fh.write(b'{"kind": "done", "key": "IRB-9/K2", "manif')
        j2 = pkg.Journal(p)
        assert j2.completed_keys() == {"IRB-9/K1"}
        assert j2.torn_tail == 1
        j2.record_done("IRB-9/K3", pkg.Manifest("IRB-9"), "w0")
        j2.close()
        j3 = pkg.Journal(p)
        assert j3.completed_keys() == {"IRB-9/K1", "IRB-9/K3"}
        assert j3.torn_tail == 0 and j3.corrupt_lines == 0
        j3.close()

    def test_corrupt_mid_file_line_is_skipped_and_counted(self, pkg, tmp_path):
        p = tmp_path / "j.jsonl"
        j = pkg.Journal(p)
        j.record_done("IRB-9/K1", pkg.Manifest("IRB-9"), "w0")
        j.close()
        with open(p, "ab") as fh:
            fh.write(b"garbage not json\n")
        j2 = pkg.Journal(p)
        j2.record_done("IRB-9/K2", pkg.Manifest("IRB-9"), "w0")
        j2.close()
        j3 = pkg.Journal(p)
        assert j3.completed_keys() == {"IRB-9/K1", "IRB-9/K2"}
        assert j3.corrupt_lines == 1 and j3.torn_tail == 0
        j3.close()

    def test_both_packages_write_the_same_journal(self, tmp_path):
        texts = []
        for name in sorted(PACKAGES):
            pkg = PACKAGES[name]
            j = pkg.Journal(tmp_path / f"{name}.jsonl")
            m = pkg.Manifest("IRB-9/ANON1")
            j.record_done("IRB-9/K1", m, "w0", source_etag="e1")
            j.close()
            texts.append((tmp_path / f"{name}.jsonl").read_text())
        assert texts[0] == texts[1]


# ------------------------------------------------------------------- ledger
def _ledger(pkg, tmp_path, name="led"):
    return pkg.AuditLedger(tmp_path / f"{name}.audit")


def _populate(pkg, led, n=6):
    for i in range(n):
        led.append(pkg.records.SOURCE_FETCH, key=f"IRB/A{i:03d}", accession=f"A{i:03d}",
                   etag=f"e{i}", worker="w0", attempt=1, nbytes=100 + i)


def _provenance(pkg, led, i):
    led.append(pkg.records.PROVENANCE, key=f"IRB/A{i}", project="IRB", accession=f"A{i}",
               etag=f"e{i}", temp="cold", lake_key="", ruleset="r", detector_sha="",
               kernel_path="serial", batched=0, trace_id="", instances=1, nbytes=10)


class TestLedgerChain:
    def test_appends_chain_from_genesis(self, pkg, tmp_path):
        led = _ledger(pkg, tmp_path)
        r1 = led.append(pkg.records.SOURCE_FETCH, key="k1", nbytes=1)
        r2 = led.append(pkg.records.DELIVERY, key="k1", etag="e1")
        assert r1["prev_sha"] == pkg.GENESIS_SHA
        assert r2["prev_sha"] == r1["sha"]
        assert (r1["seq"], r2["seq"]) == (1, 2)
        assert led.head() == r2["sha"]
        assert led.verify() == []

    def test_sha_covers_the_whole_record(self, pkg, tmp_path):
        rec = _ledger(pkg, tmp_path).append(pkg.records.DELIVERY, key="k", etag="e")
        assert rec["sha"] == pkg.records.record_sha(rec)
        assert pkg.records.record_sha(dict(rec, etag="forged")) != rec["sha"]

    def test_unknown_kind_rejected(self, pkg, tmp_path):
        with pytest.raises(ValueError, match="unknown audit record kind"):
            _ledger(pkg, tmp_path).append("made_up_kind", key="k")

    def test_payload_cannot_shadow_structural_keys(self, pkg, tmp_path):
        with pytest.raises(ValueError, match="structural keys"):
            _ledger(pkg, tmp_path).append(pkg.records.DELIVERY, seq=99)

    def test_replay_restores_chain_and_digest(self, pkg, tmp_path):
        led = _ledger(pkg, tmp_path)
        _populate(pkg, led, 5)
        led.append(pkg.records.DELIVERY, key="k", etag="e")
        digest, head = led.digest(), led.head()
        led.close()
        back = pkg.AuditLedger(led.path)
        assert back.digest() == digest and back.head() == head
        assert len(back) == 6
        nxt = back.append(pkg.records.DELIVERY, key="k2", etag="e2")
        assert nxt["prev_sha"] == head and nxt["seq"] == 7
        assert back.verify() == []
        back.close()

    def test_digest_commits_to_length_and_head(self, pkg, tmp_path):
        a, b = _ledger(pkg, tmp_path, "a"), _ledger(pkg, tmp_path, "b")
        _populate(pkg, a, 3)
        _populate(pkg, b, 3)
        assert a.digest() == b.digest()
        b.append(pkg.records.DELIVERY, key="k", etag="e")
        assert a.digest() != b.digest()

    def test_nondurable_records_flush_at_next_durable_append(self, pkg, tmp_path):
        led = _ledger(pkg, tmp_path)
        led.append(pkg.records.LAKE_HIT, lake_key="lk", nbytes=4)
        led.append(pkg.records.DELIVERY, key="k", etag="e")
        assert led.path.read_text().count("\n") == 2
        assert led.verify() == []

    def test_batch_group_commits_durable_appends(self, pkg, tmp_path):
        led = _ledger(pkg, tmp_path)
        led.append(pkg.records.DELIVERY, key="k0", etag="e")
        assert led.syncs == 1
        with led.batch():
            led.append(pkg.records.DELIVERY, key="k1", etag="e")
            _provenance(pkg, led, 1)
            assert led.syncs == 1
        assert led.syncs == 2
        assert led.verify() == []
        with led.batch():
            with led.batch():
                led.append(pkg.records.DELIVERY, key="k2", etag="e")
            assert led.syncs == 2
        assert led.syncs == 3
        with led.batch():
            led.append(pkg.records.LAKE_HIT, lake_key="lk", nbytes=1)
        assert led.syncs == 3

    def test_null_ledger_is_inert_and_digest_matches_empty(self, pkg, tmp_path):
        empty = _ledger(pkg, tmp_path, "empty")
        null = pkg.NullLedger()
        assert null.digest() == empty.digest()
        assert null.head() == pkg.GENESIS_SHA
        null.append(pkg.records.DELIVERY, key="k", etag="e")
        assert len(null) == 0 and null.records() == []
        assert null.verify() == []
        assert pkg.NULL_LEDGER.enabled is False

    def test_both_packages_chain_the_same_bytes(self, tmp_path):
        raws = []
        for name in sorted(PACKAGES):
            pkg = PACKAGES[name]
            led = _ledger(pkg, tmp_path, name)
            _populate(pkg, led, 4)
            _provenance(pkg, led, 9)
            led.close()
            raws.append(led.path.read_bytes())
        assert raws[0] == raws[1]


class TestLedgerTamper:
    @staticmethod
    def _flip_byte(path, offset):
        raw = bytearray(path.read_bytes())
        raw[offset] = ord("0") if raw[offset] != ord("0") else ord("1")
        path.write_bytes(bytes(raw))

    def test_byte_flip_fails_verify(self, pkg, tmp_path):
        led = _ledger(pkg, tmp_path)
        _populate(pkg, led, 8)
        led.flush()
        assert led.verify() == []
        raw = led.path.read_text().splitlines()
        idx = sum(len(l) + 1 for l in raw[:3]) + raw[3].index('"etag":"e3"') + 9
        self._flip_byte(led.path, idx)
        assert any("sha mismatch" in p for p in led.verify())

    def test_record_deletion_breaks_chain(self, pkg, tmp_path):
        led = _ledger(pkg, tmp_path)
        _populate(pkg, led, 8)
        led.flush()
        lines = led.path.read_text().splitlines()
        del lines[3]
        led.path.write_text("\n".join(lines) + "\n")
        problems = led.verify()
        assert any("prev_sha break" in p for p in problems), problems
        assert any("seq" in p for p in problems)

    def test_record_reorder_breaks_chain(self, pkg, tmp_path):
        led = _ledger(pkg, tmp_path)
        _populate(pkg, led, 8)
        led.flush()
        lines = led.path.read_text().splitlines()
        lines[2], lines[5] = lines[5], lines[2]
        led.path.write_text("\n".join(lines) + "\n")
        assert any("prev_sha break" in p or "seq" in p for p in led.verify())

    def test_record_insertion_breaks_chain(self, pkg, tmp_path):
        led = _ledger(pkg, tmp_path)
        _populate(pkg, led, 5)
        led.flush()
        lines = led.path.read_text().splitlines()
        forged = {"kind": pkg.records.DELIVERY, "seq": 3, "t": 0.0,
                  "prev_sha": json.loads(lines[1])["sha"], "key": "forged"}
        forged["sha"] = pkg.records.record_sha(forged)
        lines.insert(2, pkg.records.canonical_json(forged))
        led.path.write_text("\n".join(lines) + "\n")
        assert led.verify()

    def test_truncation_caught_by_live_head_comparison(self, pkg, tmp_path):
        led = _ledger(pkg, tmp_path)
        _populate(pkg, led, 8)
        led.flush()
        lines = led.path.read_text().splitlines()
        led.path.write_text("\n".join(lines[:5]) + "\n")
        assert any("truncated" in p for p in led.verify())

    def test_truncation_after_restart_needs_the_cross_check(self, pkg, tmp_path):
        led = _ledger(pkg, tmp_path)
        for i in range(6):
            _provenance(pkg, led, i)
        led.close()
        lines = led.path.read_text().splitlines()
        led.path.write_text("\n".join(lines[:3]) + "\n")
        back = pkg.AuditLedger(led.path)
        assert back.verify() == []
        assert len(back.records(pkg.records.PROVENANCE)) != 6
        back.close()


# --------------------------------------------------------------- end to end
KEY = b"q" * 32
N_STUDIES = 6


def _jax_corpus():
    gen = StudyGenerator(21)
    studies = [gen.gen_study(f"Q{i:03d}", n_images=2) for i in range(N_STUDIES)]
    studies.append(gen.gen_study("QUNK", device=gen.unknown_device("serve", "CT"), n_images=2))
    return studies


def _query(q):
    return q.And(q.In("modality", ["CT", "US"]), q.Range("study_date", 20150101, 20181231))


def _stack(tmp_path, name, studies, *, store_cls, catalog, lake_cls, pipeline, service_cls,
           queueing, timing, ledger_cls):
    clock = timing.SimClock()
    ledger = ledger_cls(tmp_path / f"{name}.audit", clock=clock)
    source = store_cls("lake")
    mrns = {}
    for s in studies:
        source.put_study(s.accession, s)
        mrns[s.accession] = s.mrn
    source.attach_catalog(catalog)
    broker = queueing.Broker(clock, visibility_timeout=300.0)
    journal = queueing.Journal(tmp_path / f"{name}.jsonl")
    lake = lake_cls(max_bytes=1 << 30, ledger=ledger)
    pipe = pipeline(lake, ledger)
    service = service_cls(broker, source, journal, result_lake=lake, pipeline=pipe,
                          catalog=catalog, ledger=ledger)
    service.register_study("IRB-C", key=KEY)
    dest = store_cls("researcher")
    pool = queueing.WorkerPool(
        broker, queueing.Autoscaler(broker, queueing.AutoscalerConfig(), clock),
        lambda wid: queueing.DeidWorker(wid, pipe, source, dest, journal, ledger=ledger),
    )
    return types.SimpleNamespace(source=source, mrns=mrns, broker=broker, journal=journal,
                                 lake=lake, pipeline=pipe, service=service, dest=dest, pool=pool,
                                 ledger=ledger, catalog=catalog)


def _run(stack, query):
    sel, ticket = stack.service.submit_query("IRB-C", query, stack.mrns)
    report = stack.pool.drain()
    stack.service.planner.resolve()
    published = stack.broker.total_published
    sel2, replay = stack.service.submit_query("IRB-C", query, stack.mrns)
    return types.SimpleNamespace(sel=sel, ticket=ticket, report=report, sel2=sel2,
                                 replay=replay, replay_publishes=stack.broker.total_published
                                 - published)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serving")
    jax_studies = _jax_corpus()
    port_studies = [study_from_plain(study_to_plain(s)) for s in jax_studies]
    jax = _stack(
        tmp, "jax", jax_studies, store_cls=JaxStore, catalog=JaxCatalog(), lake_cls=JaxLake,
        pipeline=lambda lake, led: jax_core.DeidPipeline(
            lake=lake, ledger=led, detector_policy=JaxPolicy(mode="registry_first")),
        service_cls=JaxService, queueing=jax_queueing, timing=jax_timing,
        ledger_cls=jax_ledger_mod.AuditLedger)
    port = _stack(
        tmp, "torch", port_studies, store_cls=StudyStore, catalog=StudyCatalog(device="cpu"),
        lake_cls=ResultLake,
        pipeline=lambda lake, led: port_core.DeidPipeline(
            lake=lake, ledger=led, detector_policy=DetectorPolicy(mode="registry_first"),
            device="cpu"),
        service_cls=DeidService, queueing=port_queueing, timing=port_timing,
        ledger_cls=port_ledger_mod.AuditLedger)
    return (jax, _run(jax, _query(jax_query)), jax_studies,
            port, _run(port, _query(port_query)), port_studies)


def _request_ids(stack, accessions):
    pseudo = stack.service._studies["IRB-C"]
    return [f"IRB-C/{pseudo.accession(a)}" for a in accessions]


def _assert_same_datasets(port_list, jax_list):
    assert len(port_list) == len(jax_list) > 0
    for a, b in zip(port_list, jax_list):
        assert a.elements == b.elements and a.private == b.private
        assert a.pixels.dtype == b.pixels.dtype
        np.testing.assert_array_equal(a.pixels, b.pixels)


# ledger fields that differ between the packages by construction (see the
# module docstring): chain hashes over differing contents, lake keys, the
# ruleset digest, and the size of lake blobs
CHAIN_FIELDS = ("sha", "prev_sha")
LAKE_KEY_FIELDS = ("lake_key",)
RULESET_FIELDS = ("ruleset",)
LAKE_BLOB_SIZE = {"lake_write": ("nbytes",), "lake_hit": ("nbytes",), "lake_evict": ("nbytes",)}


def _normalized(stack, rec):
    """A ledger record with its package-specific fields replaced by what they
    name: an etag by the accession whose stored study it is, the ruleset by
    a check that it is this stack's digest, a lake key by whether it is set."""
    etags = {stack.source.study_etag(a): a for a in stack.source.accessions()}
    out = dict(rec)
    for f in CHAIN_FIELDS + LAKE_BLOB_SIZE.get(rec["kind"], ()):
        out.pop(f, None)
    for f in LAKE_KEY_FIELDS:
        if f in out:
            out[f] = bool(out[f])
    for f in RULESET_FIELDS:
        if f in out:
            assert out[f] == stack.pipeline.ruleset_fingerprint().digest
            out[f] = "ruleset"
    if out.get("etag") is not None:
        out["etag"] = ("etag of", etags[out["etag"]])
    return out


class TestQueryThenDeidentify:
    def test_selection_equal(self, served):
        jax, jr, _, port, pr, port_studies = served
        assert 0 < len(pr.sel.accessions) < N_STUDIES + 1
        assert "QUNK" in pr.sel.accessions
        fields = {f.name for f in dataclasses.fields(pr.sel)} - {"digest"}
        for f in fields:
            assert getattr(pr.sel, f) == getattr(jr.sel, f), f
        assert pr.sel2.digest == pr.sel.digest and pr.ticket.selection_digest == pr.sel.digest
        # the digest differs only through the source etags: the port's
        # studies ingested under the JAX store's etags give the JAX digest
        relabelled = StudyCatalog(device="cpu")
        for s in port_studies:
            relabelled.ingest_study(s.accession, s, etag=jax.source.study_etag(s.accession))
        assert relabelled.select(_query(port_query)).digest == jr.sel.digest

    def test_ticket_partition_equal(self, served):
        jax, jr, _, port, pr, _ = served
        for t_port, t_jax in ((pr.ticket, jr.ticket), (pr.replay, jr.replay)):
            assert t_port.done() and t_jax.done()
            for f in ("hits", "coalesced", "cold", "rejected", "failed"):
                assert getattr(t_port, f) == getattr(t_jax, f), f
        assert sorted(pr.ticket.cold) == list(pr.sel.accessions)
        assert not pr.ticket.failed
        # the drain's input bytes are the stored (pickled) study sizes
        p_rep, j_rep = dataclasses.asdict(pr.report), dataclasses.asdict(jr.report)
        for stack, rep, t in ((port, p_rep, pr.ticket), (jax, j_rep, jr.ticket)):
            assert rep.pop("bytes_in") == sum(stack.source.study_nbytes(a) for a in t.cold)
        assert p_rep == j_rep

    def test_delivered_pixels_and_tags_equal(self, served):
        jax, jr, _, port, pr, _ = served
        for rid_p, rid_j in zip(_request_ids(port, pr.sel.accessions),
                                _request_ids(jax, jr.sel.accessions)):
            assert rid_p == rid_j
            _assert_same_datasets(list(port.dest.outputs(rid_p)), list(jax.dest.outputs(rid_j)))
        for acc in pr.sel.accessions:
            _assert_same_datasets(pr.ticket.outputs[acc], jr.ticket.outputs[acc])

    def test_manifests_equal(self, served):
        jax, jr, _, port, pr, _ = served
        assert (port.journal.merged_manifest("IRB-C").to_json()
                == jax.journal.merged_manifest("IRB-C").to_json())
        assert port.journal.completed_keys() == jax.journal.completed_keys()
        for acc in pr.sel.accessions:
            assert pr.ticket.manifests[acc].to_json() == jr.ticket.manifests[acc].to_json()
            assert pr.replay.manifests[acc].to_json() == jr.replay.manifests[acc].to_json()

    def test_ledger_records_equal_and_chains_verify(self, served):
        jax, _, _, port, _, _ = served
        assert port.ledger.verify() == [] and jax.ledger.verify() == []
        assert port.ledger.kind_counts() == jax.ledger.kind_counts()
        p_recs, j_recs = port.ledger.records(), jax.ledger.records()
        assert len(p_recs) == len(j_recs)
        for a, b in zip(p_recs, j_recs):
            assert _normalized(port, a) == _normalized(jax, b)
        kinds = port.ledger.kind_counts()
        for kind in ("source_fetch", "deid_execute", "detector_decision", "lake_write",
                     "lake_hit", "delivery", "provenance"):
            assert kinds.get(kind, 0) > 0, kind

    def test_replay_is_fully_warm(self, served):
        _, jr, _, port, pr, _ = served
        assert pr.replay_publishes == 0 == jr.replay_publishes
        assert sorted(pr.replay.hits) == list(pr.sel.accessions)
        assert not pr.replay.cold and not pr.replay.coalesced
        for acc in pr.sel.accessions:
            _assert_same_datasets(pr.replay.outputs[acc], pr.ticket.outputs[acc])
        assert port.lake.stats.oversize_rejects == 0 and port.lake.stats.evictions == 0

    def test_ruleset_fingerprints_differ_only_in_config_sha(self, served):
        jax, _, _, port, _, _ = served
        p = dataclasses.asdict(port.pipeline.ruleset_fingerprint())
        j = dataclasses.asdict(jax.pipeline.ruleset_fingerprint())
        assert p.pop("config_sha") != j.pop("config_sha")
        assert p == j
        assert (port.pipeline.ruleset_fingerprint().digest
                != jax.pipeline.ruleset_fingerprint().digest)


@pytest.mark.parametrize("detector", [None, "registry_first"])
def test_config_sha_is_the_only_fingerprint_difference(detector):
    jp = jax_core.DeidPipeline(detector_policy=None if detector is None else JaxPolicy(mode=detector))
    pp = port_core.DeidPipeline(device="cpu",
                                detector_policy=None if detector is None
                                else DetectorPolicy(mode=detector))
    j, p = (dataclasses.asdict(x.ruleset_fingerprint()) for x in (jp, pp))
    assert j.pop("config_sha") != p.pop("config_sha")
    assert j == p
