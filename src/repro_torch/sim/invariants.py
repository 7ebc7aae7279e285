"""Invariant checkers: the conformance contract of the fleet simulator.

Each checker inspects the *real* post-run state of a :class:`FleetSim` — the
journal file, the researcher bucket's bytes, the result lake, the autoscaler's
accounting — and returns :class:`Violation`\\ s. Checkers never consult the
event log for truth (the log is evidence for humans; the stores are the
ground truth), and they are read-only except for ``NoWedgedSubscribers``,
which runs a final ``planner.resolve()`` the way any live deployment would.

The contract (DESIGN.md §7):

* a checker returns ``[]`` iff the invariant held for the whole run;
* every violation carries enough detail to reproduce (key / path / numbers);
* checkers must themselves be deterministic — same sim state, same report.
"""
from __future__ import annotations

import pickle
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List

from repro_torch.dicom.devices import DeviceKey, registry

if TYPE_CHECKING:  # pragma: no cover - type-only
    from repro_torch.sim.harness import FleetSim


@dataclass(frozen=True)
class Violation:
    checker: str
    detail: str


class InvariantChecker:
    name = "base"

    def check(self, sim: "FleetSim") -> List[Violation]:
        raise NotImplementedError

    def _v(self, detail: str) -> Violation:
        return Violation(self.name, detail)


class ExactlyOnceDelivery(InvariantChecker):
    """At-least-once transport + journal dedup must net out to exactly-once
    effect: worker `processed` counters equal unique journal completions, and
    every completion maps to a submitted key with its outputs in the bucket."""

    name = "exactly_once"

    def check(self, sim: "FleetSim") -> List[Violation]:
        out: List[Violation] = []
        completed = sim.journal.completed_keys()
        processed = sum(w.processed for w in sim.pool._all_workers)
        # a supersession is a legitimate second completion of the same key —
        # the source mutated and the key was incrementally re-de-identified
        expected = len(completed) + sim.journal.supersessions
        if processed != expected:
            out.append(
                self._v(
                    f"worker processed counters ({processed}) != unique journal "
                    f"completions + supersessions ({expected}): some study was "
                    "processed more than once or a completion was never journaled"
                )
            )
        unknown = completed - sim.submitted_keys()
        if unknown:
            out.append(self._v(f"journal holds never-submitted keys: {sorted(unknown)}"))
        for key in sorted(completed):
            manifest = sim.journal.manifest_for(key)
            if manifest is None:
                out.append(self._v(f"{key}: done-record without a manifest"))
                continue
            rid = manifest.request_id
            n_out = len(sim.dest.store.list(f"out/{rid}/"))
            n_anon = manifest.counts()["anonymized"]
            if n_out != n_anon:
                out.append(
                    self._v(
                        f"{key}: manifest says {n_anon} anonymized instances but the "
                        f"researcher bucket holds {n_out} under out/{rid}/"
                    )
                )
        return out


class PhiBoundary(InvariantChecker):
    """No researcher-visible byte may contain PHI: original MRNs, patient
    names, accessions (of any source version ever ingested) must not appear in
    any bucket blob or warm-served output, and every delivered image must have
    its device's burn-in regions blanked (checked from the output's own kept
    equipment tags, so re-ingested device swaps are covered — the registry
    synthesizes geometry for *any* key, so novel unknown-device variants are
    held to the same standard). On top of the geometry check, every delivered
    frame is scanned by the text-band detector oracle (DESIGN.md §9): a
    detectable band surviving in researcher-visible pixels is a violation
    regardless of what any registry believes — this is what fails when the
    detector is disabled while unknown-device traffic carries burned-in text
    (the subsystem's negative control)."""

    name = "phi_boundary"

    def _scan_text_bands(self, ds, where: str) -> List[Violation]:
        """Detector-oracle audit of delivered pixels (default policy knobs —
        the auditor's own standard, independent of the fleet's config)."""
        if ds.pixels is None or ds.pixels.ndim != 2:
            return []
        from repro_torch.detect import DetectorPolicy, detect_bands_for

        bands, _ = detect_bands_for(ds, DetectorPolicy())
        if not bands:
            return []
        return [
            self._v(
                f"{where}: delivered pixels still contain detectable text "
                f"band(s) {bands} (burned-in PHI survived the scrub)"
            )
        ]

    def _forbidden(self, sim: "FleetSim") -> Dict[bytes, str]:
        bad: Dict[bytes, str] = {}
        for study in sim.study_versions():
            bad[study.mrn.encode()] = f"MRN of {study.accession}"
            bad[study.patient_name.encode()] = f"patient name of {study.accession}"
        return bad

    def _scan_blob(self, blob: bytes, where: str, bad: Dict[bytes, str]) -> List[Violation]:
        return [
            self._v(f"{where}: contains {what} ({token!r})")
            for token, what in bad.items()
            if token in blob
        ]

    def _scan_pixels(self, ds, where: str) -> List[Violation]:
        if ds.pixels is None:
            return []
        key = DeviceKey(
            str(ds.get("Modality", "")),
            str(ds.get("Manufacturer", "")),
            str(ds.get("ManufacturerModelName", "")),
            int(ds.get("Rows", 0) or 0),
            int(ds.get("Columns", 0) or 0),
        )
        if not registry().known(key):
            # unknown variant: registry geometry is synthesized, not a
            # contract — the device never had a scrub rule, so clean slices
            # legitimately keep anatomy in those rows. The pixel-truth
            # standard (_scan_text_bands: no detectable band survives)
            # covers these instances instead.
            return []
        out: List[Violation] = []
        for x, y, w, h in registry().scrub_rects(key):
            region = ds.pixels[y : y + h, x : x + w]
            if region.size and int(region.max()) != 0:
                out.append(
                    self._v(
                        f"{where}: device region ({x},{y},{w},{h}) of "
                        f"{key.id()} not blanked (max={int(region.max())})"
                    )
                )
        return out

    def check(self, sim: "FleetSim") -> List[Violation]:
        bad = self._forbidden(sim)
        out: List[Violation] = []
        for path in sim.dest.store.list("out/"):
            blob = sim.dest.store.get(path)
            ds = pickle.loads(blob)
            out.extend(self._scan_blob(blob, f"bucket:{path}", bad))
            out.extend(self._scan_pixels(ds, f"bucket:{path}"))
            out.extend(self._scan_text_bands(ds, f"bucket:{path}"))
        for _, ticket in sim.tickets:
            for acc, datasets in ticket.outputs.items():
                for i, ds in enumerate(datasets):
                    where = f"ticket{ticket.cohort_id}:{acc}[{i}]"
                    out.extend(self._scan_blob(pickle.dumps(ds), where, bad))
                    out.extend(self._scan_pixels(ds, where))
                    out.extend(self._scan_text_bands(ds, where))
        return out


class WarmReplayIdentity(InvariantChecker):
    """Results served warm from the result lake must be byte-identical to
    what the cold path computes right now — re-runs every warm-served study
    through a lake-less clone of the current pipeline and compares pickles."""

    name = "warm_replay"

    def check(self, sim: "FleetSim") -> List[Violation]:
        from repro_torch.core.pipeline import build_request

        out: List[Violation] = []
        for _, ticket in sim.tickets:
            for acc in ticket.hits:
                if acc not in ticket.outputs:
                    continue  # journal-hit: manifest replayed, no lake bytes
                # replay against the exact source version the hit was served
                # from (a later re-ingest must not shift the oracle)
                study = sim._etag_study[sim._hit_etag[(ticket.cohort_id, acc)]]
                pseudo = sim.service._studies[ticket.study_id]
                request = build_request(pseudo, acc, study.mrn)
                cold = sim.cold_pipeline_for(ticket).run_study(
                    study, request, "oracle"
                )
                warm_bytes = [pickle.dumps(ds) for ds in ticket.outputs[acc]]
                cold_bytes = [pickle.dumps(ds) for ds in cold.delivered]
                if warm_bytes != cold_bytes:
                    out.append(
                        self._v(
                            f"ticket{ticket.cohort_id}:{acc}: warm replay differs "
                            f"from cold path ({len(warm_bytes)} vs "
                            f"{len(cold_bytes)} instances or byte mismatch)"
                        )
                    )
        return out


class AutoscalerAccounting(InvariantChecker):
    """`instance_seconds` must equal the piecewise-constant integral of the
    pool size over the tick log, and the dollar cost must be that integral
    times the configured hourly rate."""

    name = "autoscaler_accounting"

    def check(self, sim: "FleetSim") -> List[Violation]:
        a = sim.pool.autoscaler
        log = a.tick_log
        integral = sum(
            n * (log[i + 1][0] - log[i][0]) for i, (_, n) in enumerate(log[:-1])
        )
        out: List[Violation] = []
        if abs(integral - a.instance_seconds) > 1e-6 * max(1.0, integral):
            out.append(
                self._v(
                    f"instance_seconds={a.instance_seconds:.6f} but tick-log "
                    f"integral={integral:.6f} over {len(log)} ticks"
                )
            )
        want_cost = a.instance_seconds / 3600.0 * a.config.instance_cost_per_hour
        if abs(a.cost_usd() - want_cost) > 1e-9:
            out.append(self._v(f"cost_usd()={a.cost_usd()} != {want_cost}"))
        return out


class NoWedgedSubscribers(InvariantChecker):
    """After a final resolve, no cohort ticket may be waiting on work that no
    longer exists: every pending accession must map to a live in-flight
    registration, and the planner must report no wedged registrations."""

    name = "no_wedged_subscribers"

    def check(self, sim: "FleetSim") -> List[Violation]:
        planner = sim.service.planner
        planner.resolve()
        out = [
            self._v(f"in-flight registration {key} can never resolve")
            for key in planner.audit_wedged()
        ]
        inflight = set(planner.inflight_keys())
        for _, ticket in sim.tickets:
            # match on the full study-scoped key: another IRB's registration
            # for the same accession must not mask this ticket's wedge
            stuck = {
                acc for acc in ticket.pending
                if f"{ticket.study_id}/{acc}" not in inflight
            }
            if stuck:
                out.append(
                    self._v(
                        f"ticket{ticket.cohort_id} pending on {sorted(stuck)} "
                        "with no in-flight registration (subscriber wedged)"
                    )
                )
        return out


class LakeConsistency(InvariantChecker):
    """The result lake's byte accounting must match its index, stay within
    budget, and every indexed key must still have backing bytes."""

    name = "lake_consistency"

    def check(self, sim: "FleetSim") -> List[Violation]:
        lake = sim.lake
        out: List[Violation] = []
        indexed = sum(lake._lru.values())
        if indexed != lake.stored_bytes():
            out.append(
                self._v(f"stored_bytes={lake.stored_bytes()} != index sum {indexed}")
            )
        if lake.stored_bytes() > lake.max_bytes:
            out.append(
                self._v(f"stored {lake.stored_bytes()} bytes > budget {lake.max_bytes}")
            )
        for key in lake.keys():
            if lake.backend.get_bytes(key) is None:
                out.append(self._v(f"indexed key {key} has no backing blob"))
        return out


class JournalDurability(InvariantChecker):
    """A fresh replay of the journal file must reconstruct exactly the
    completions the live journal reports (fsync'd, torn-tail tolerant)."""

    name = "journal_durability"

    def check(self, sim: "FleetSim") -> List[Violation]:
        from repro_torch.queueing.journal import Journal

        replayed = Journal(sim.journal.path)
        try:
            if replayed.completed_keys() != sim.journal.completed_keys():
                missing = sim.journal.completed_keys() - replayed.completed_keys()
                extra = replayed.completed_keys() - sim.journal.completed_keys()
                return [
                    self._v(
                        f"journal replay mismatch: missing={sorted(missing)} "
                        f"extra={sorted(extra)}"
                    )
                ]
            return []
        finally:
            replayed.close()


class QueryConsistency(InvariantChecker):
    """Every query-served selection must equal a brute-force scan: the query
    is re-evaluated row by row in pure python (``catalog.query.matches_row``
    — no dictionary codes, no bitmaps, no zone-map pruning, no tensors) over the
    exact source versions the catalog had indexed at serve time, and the
    selection's accessions, per-accession instance counts, and byte totals
    must all agree."""

    name = "query_consistency"

    def check(self, sim: "FleetSim") -> List[Violation]:
        from repro_torch.catalog.columns import rows_from_study
        from repro_torch.catalog.query import matches_row

        out: List[Violation] = []
        for qi, (arr, selection, snapshot) in enumerate(sim.query_log):
            where = f"query{qi} ({selection.query})"
            counts: Dict[str, int] = {}
            total_bytes = 0
            for acc, etag in snapshot.items():
                study = sim._etag_study.get(etag)
                if study is None:
                    out.append(
                        self._v(f"{where}: no retained source version for "
                                f"{acc} etag={etag}")
                    )
                    continue
                n = 0
                for row in rows_from_study(study):
                    if matches_row(arr.query, row):
                        n += 1
                        total_bytes += row["nbytes"]
                if n:
                    counts[acc] = n
            if list(selection.accessions) != sorted(counts):
                out.append(
                    self._v(
                        f"{where}: selection accessions "
                        f"{list(selection.accessions)} != brute-force "
                        f"{sorted(counts)}"
                    )
                )
                continue
            if dict(selection.instance_counts) != counts:
                out.append(
                    self._v(
                        f"{where}: instance counts {selection.instance_counts} "
                        f"!= brute-force {counts}"
                    )
                )
            if selection.total_instances != sum(counts.values()):
                out.append(
                    self._v(
                        f"{where}: total_instances={selection.total_instances} "
                        f"!= brute-force {sum(counts.values())}"
                    )
                )
            if selection.total_bytes != total_bytes:
                out.append(
                    self._v(
                        f"{where}: total_bytes={selection.total_bytes} "
                        f"!= brute-force {total_bytes}"
                    )
                )
        return out


class CheckpointMonotonicity(InvariantChecker):
    """The pooler checkpoint must account for every committed feed event
    exactly once after the final drain: no event lost across crashes (every
    committed seq was checkpointed as seen AND reached a terminal outcome),
    no event double-applied (two outcome records for one seq), and per
    accession the *applied* outcomes never regress in seq order. Verified
    against a fresh replay of the durable checkpoint file — the same
    durability standard the journal is held to."""

    name = "checkpoint_monotonicity"

    def check(self, sim: "FleetSim") -> List[Violation]:
        if getattr(sim, "feed", None) is None:
            return []
        from repro_torch.ingest.checkpoint import Checkpoint

        ck = Checkpoint(sim.pooler.checkpoint.path)
        try:
            out: List[Violation] = []
            committed = {e.seq for e in sim.feed.events}
            lost = committed - ck.seen
            if lost:
                out.append(
                    self._v(f"feed events never checkpointed as seen: {sorted(lost)}")
                )
            unapplied = committed - set(ck.outcomes)
            if unapplied:
                out.append(
                    self._v(
                        "feed events with no terminal outcome after drain "
                        f"(lost work): {sorted(unapplied)}"
                    )
                )
            phantom = set(ck.outcomes) - committed
            if phantom:
                out.append(
                    self._v(f"outcomes for never-committed seqs: {sorted(phantom)}")
                )
            if ck.double_applied:
                out.append(
                    self._v(
                        f"seqs with more than one outcome record (double-applied "
                        f"after crash): {sorted(set(ck.double_applied))}"
                    )
                )
            last_applied: Dict[str, int] = {}
            for rec in ck.outcome_log:
                if rec.get("outcome") != "applied":
                    continue
                acc = rec.get("accession", "")
                if rec["seq"] < last_applied.get(acc, 0):
                    out.append(
                        self._v(
                            f"{acc}: applied seq {rec['seq']} after newer seq "
                            f"{last_applied[acc]} (out-of-order apply regressed "
                            "the lake)"
                        )
                    )
                last_applied[acc] = max(last_applied.get(acc, 0), rec["seq"])
            return out
        finally:
            ck.close()


class Freshness(InvariantChecker):
    """No delivered frame may be older than its source's last acked mutation:
    for every delivery (worker completion or warm serve), the source etag the
    content was computed from must equal the etag of the newest mutation
    acked *before* that delivery. Ordering is by the sim's global handoff
    sequence, not timestamps — two events at the same sim-time still have a
    definite order."""

    name = "freshness"

    def check(self, sim: "FleetSim") -> List[Violation]:
        out: List[Violation] = []
        mutations = getattr(sim, "mutation_log", [])
        for d in getattr(sim, "delivery_log", []):
            last = None
            for m in mutations:
                if m["accession"] == d["accession"] and m["seq"] < d["seq"]:
                    last = m
            if last is None:
                continue
            if last["etag"] is None:
                out.append(
                    self._v(
                        f"{d['key']}: delivered after the source study was "
                        f"deleted (mutation seq {last['seq']})"
                    )
                )
            elif d["etag"] is not None and d["etag"] != last["etag"]:
                out.append(
                    self._v(
                        f"{d['key']}: delivered content from etag "
                        f"{d['etag'][:12]} but the last acked mutation "
                        f"(seq {last['seq']}) committed {last['etag'][:12]} "
                        "— stale bytes delivered"
                    )
                )
        return out


class NoFullReingest(InvariantChecker):
    """Catalog delta work must be proportional to changed rows, counter-
    asserted: the catalog's cumulative row/tombstone counters must equal
    exactly what the harness's applied mutations account for. A hidden full
    rebuild (re-indexing unchanged studies) inflates the counters past the
    per-mutation budget and fails here."""

    name = "no_full_reingest"

    def check(self, sim: "FleetSim") -> List[Violation]:
        expected_rows = getattr(sim, "_expected_catalog_rows", None)
        if expected_rows is None:
            return []
        out: List[Violation] = []
        if sim.catalog.stats.rows != expected_rows:
            out.append(
                self._v(
                    f"catalog ingested {sim.catalog.stats.rows} rows but the "
                    f"applied mutations account for {expected_rows} — delta "
                    "ingest did more work than the changed rows"
                )
            )
        expected_tombs = sim._expected_tombstones
        if sim.catalog.stats.tombstoned != expected_tombs:
            out.append(
                self._v(
                    f"catalog tombstoned {sim.catalog.stats.tombstoned} rows "
                    f"but the applied mutations account for {expected_tombs}"
                )
            )
        return out


class TraceIntegrity(InvariantChecker):
    """The trace layer must be structurally sound and complete: no span left
    open at end of run, every timestamp within [0, final sim time] with
    ``t1 >= t0``, every ``parent_id`` resolving to an earlier-started span of
    the *same* trace, and every journal-completed key carrying at least one
    ``worker.process`` span (a completion that left no trace is untraceable
    work). Skipped when the run was configured with ``trace=False`` — the
    NULL_TRACER records nothing by design."""

    name = "trace_integrity"

    def check(self, sim: "FleetSim") -> List[Violation]:
        tracer = getattr(sim, "tracer", None)
        if tracer is None or not getattr(tracer, "enabled", False):
            return []
        out: List[Violation] = []
        if tracer.open_count != 0:
            open_names = [s.name for s in tracer._stack]
            out.append(
                self._v(
                    f"{tracer.open_count} span(s) still open at end of run: "
                    f"{open_names}"
                )
            )
        now = sim.clock.now()
        spans = tracer.spans()
        by_trace: Dict[str, Dict[str, object]] = {}
        for s in spans:
            by_trace.setdefault(s.trace_id, {})[s.span_id] = s
        for s in spans:
            if s.t1 is None:
                out.append(self._v(f"{s.span_id} ({s.name}): finished without t1"))
                continue
            if not (0.0 <= s.t0 <= s.t1 <= now + 1e-9):
                out.append(
                    self._v(
                        f"{s.span_id} ({s.name}): timestamps [{s.t0}, {s.t1}] "
                        f"outside the run's clock range [0, {now}]"
                    )
                )
            if s.parent_id is not None:
                parent = by_trace[s.trace_id].get(s.parent_id)
                if parent is None:
                    out.append(
                        self._v(
                            f"{s.span_id} ({s.name}): parent {s.parent_id} not "
                            f"in trace {s.trace_id} (dangling parent)"
                        )
                    )
                elif parent.seq >= s.seq:
                    out.append(
                        self._v(
                            f"{s.span_id} ({s.name}): parent {s.parent_id} "
                            "started after its child (inverted parentage)"
                        )
                    )
        traced_keys = {
            s.attrs.get("key") for s in spans if s.name == "worker.process"
        }
        untraced = sim.journal.completed_keys() - traced_keys
        if untraced:
            out.append(
                self._v(
                    "journal-completed keys with no worker.process span: "
                    f"{sorted(untraced)}"
                )
            )
        return out


class TelemetryPhiBoundary(InvariantChecker):
    """PHI must never cross the telemetry exporters: every span/metric export
    surface (JSONL spans, JSONL metrics, Chrome trace), rendered through the
    run's configured redaction, must be free of any MRN or patient name of
    any source version ever ingested. This is the *export* analogue of
    :class:`PhiBoundary` — the trace may internally reference study keys (the
    fleet's own identifiers), but identified-patient tokens in exported bytes
    are a violation. With ``telemetry_redact=False`` and planted PHI this
    checker must fire (its negative control)."""

    name = "telemetry_phi_boundary"

    def check(self, sim: "FleetSim") -> List[Violation]:
        tracer = getattr(sim, "tracer", None)
        if tracer is None:
            return []
        import json

        from repro_torch.obs.export import (
            Redactor,
            export_metrics_jsonl,
            export_spans_jsonl,
            to_chrome_trace,
        )

        redactor = Redactor(enabled=getattr(sim.config, "telemetry_redact", True))
        spans = tracer.spans()
        exported = export_spans_jsonl(spans, redactor)
        registry = getattr(sim, "registry", None)
        if registry is not None:
            exported += export_metrics_jsonl(registry.snapshot(), redactor)
        exported += json.dumps(to_chrome_trace(spans, redactor), sort_keys=True)
        out: List[Violation] = []
        for token, what in PhiBoundary()._forbidden(sim).items():
            text = token.decode()
            if text and text in exported:
                out.append(
                    self._v(f"exported telemetry contains {what} ({text!r})")
                )
        return out


class MetricsConservation(InvariantChecker):
    """Flow counters must balance exactly — work is neither minted nor lost
    between subsystems:

    * planner admission: every admitted accession lands in exactly one bin
      (``accessions == lake_hits + journal_hits + coalesced + published +
      rejected``), and every publish reaches exactly one terminal state
      (``published == resolved + dead_lettered + still-in-flight``);
    * broker copy conservation (both queues): every message copy entering a
      broker (``published + speculative_clones``) is acked, dead-lettered, or
      still outstanding;
    * delivery accounting: every serve-queue delivery the broker handed out
      was terminally handled by a worker (processed / deduped / fenced /
      zombie-aborted) or died in a crash;
    * registry aggregation: the shared registry's summed series must agree
      with the per-instance counters it aggregates.
    """

    name = "metrics_conservation"

    def _balance(self, what: str, lhs: int, rhs: int, detail: str) -> List[Violation]:
        if lhs != rhs:
            return [self._v(f"{what}: {lhs} != {rhs} ({detail})")]
        return []

    def check(self, sim: "FleetSim") -> List[Violation]:
        out: List[Violation] = []
        ps = sim.service.planner.stats
        out += self._balance(
            "planner admission",
            ps.accessions,
            ps.lake_hits + ps.journal_hits + ps.coalesced + ps.published + ps.rejected,
            "accessions vs lake_hits+journal_hits+coalesced+published+rejected",
        )
        out += self._balance(
            "planner in-flight lifecycle",
            ps.published,
            ps.resolved + ps.dead_lettered + len(sim.service.planner._inflight),
            "published vs resolved+dead_lettered+in_flight",
        )
        brokers = [("serve broker", sim.broker)]
        if getattr(sim, "ingest_broker", None) is not None:
            brokers.append(("ingest broker", sim.ingest_broker))
        for label, broker in brokers:
            c, st = broker.counters, broker.stats()
            out += self._balance(
                f"{label} copy conservation",
                c.published + c.speculative_clones,
                c.acked + c.dead_lettered + st.available + st.leased,
                "published+speculative vs acked+dead_lettered+outstanding",
            )
        handled = (
            sum(
                w.processed + w.deduped + w.fenced + w.zombie_aborts
                for w in sim.pool._all_workers
            )
            + sim.pool.crashes
        )
        out += self._balance(
            "serve delivery accounting",
            sim.broker.counters.deliveries,
            handled,
            "broker deliveries vs worker processed+deduped+fenced+zombie+crashes",
        )
        registry = getattr(sim, "registry", None)
        if registry is not None:
            want = sum(b.counters.published for _, b in brokers)
            out += self._balance(
                "registry aggregation",
                registry.value("repro_broker_published"),
                want,
                "summed repro_broker_published vs per-broker counters",
            )
            # executor batch accounting: the executor-side instance counter
            # (now registry-backed via ExecutorStats/StatsShim) against the
            # worker pool's independently kept per-run dispatch deltas —
            # every batched instance must have been driven by some worker
            want = sum(w.batched_instances for w in sim.pool._all_workers)
            out += self._balance(
                "executor batch accounting",
                registry.value("repro_executor_instances"),
                want,
                "summed repro_executor_instances vs worker batched deltas",
            )
        return out


class SloConformance(InvariantChecker):
    """The SLO plane's outputs must be recomputable from their inputs
    (DESIGN.md §13):

    * **replay equality** — rebuilding a fresh engine from the recorded
      observation log + evaluation times must reproduce the alert sequence
      bit-for-bit (alerts are a pure function of the run, with no hidden
      state);
    * **log conformance** — the ``slo_alert`` records in the event log match
      the engine's alert list one-to-one, in order;
    * **trace cross-check** — when tracing is on, the engine's cold-serve
      observation stream must equal the latencies independently re-derived
      from the span stream (``derive_serve_observations``): every latency
      alert is recomputable from the trace digest's underlying spans.

    With the engine disabled the only requirement is that no ``slo_alert``
    records exist.
    """

    name = "slo_conformance"

    def check(self, sim: "FleetSim") -> List[Violation]:
        logged = sim.log.by_kind("slo_alert")
        eng = getattr(sim, "slo_engine", None)
        if eng is None:
            if logged:
                return [self._v(f"{len(logged)} slo_alert records with no engine")]
            return []
        out: List[Violation] = []
        replayed = eng.replay()
        if replayed.alerts != eng.alerts:
            out.append(self._v(
                f"alert replay mismatch: {len(replayed.alerts)} replayed vs "
                f"{len(eng.alerts)} recorded"
            ))
        want = [(round(a.t, 9), a.slo, a.rule, a.action) for a in eng.alerts]
        got = [(r["t"], r["slo"], r["rule"], r["action"]) for r in logged]
        if want != got:
            out.append(self._v(
                f"event-log alerts diverge from engine: {len(got)} logged vs "
                f"{len(want)} recorded"
            ))
        tracer = getattr(sim, "tracer", None)
        if tracer is not None and getattr(tracer, "enabled", False):
            from repro_torch.obs.slo import derive_serve_observations

            derived = sorted(
                (round(t, 9), round(v, 9))
                for t, _key, v in derive_serve_observations(tracer.spans())
            )
            observed = sorted(
                (round(rec["t"], 9), round(rec["value"], 9))
                for rec in eng.obs_log
                if rec["slo"].startswith("cold_serve") and rec["value"] is not None
            )
            if derived != observed:
                out.append(self._v(
                    f"cold-serve observations diverge from the span stream: "
                    f"{len(observed)} observed vs {len(derived)} derived"
                ))
        return out


class AuditCompleteness(InvariantChecker):
    """The audit ledger must be a tamper-evident, *complete* account of the
    run, cross-checked against every other source of truth:

    1. **chain** — ``verify()`` recomputes the hash chain from disk bytes:
       any mutation, insertion, or reordering is a violation;
    2. **durability** — a fresh replay of the ledger file reproduces the
       live digest (nothing unflushed, nothing lost to a torn tail);
    3. **journal** — every journal-completed key has exactly one cold
       provenance record whose source etag matches the journal's, under a
       ruleset this fleet actually deployed; the total cold-provenance count
       equals the pool's processed count (this is the truncation bound:
       chopping the ledger's tail breaks the equality);
    4. **traces** — every cold provenance trace id resolves to a
       ``worker.process`` span (skipped under ``trace=False``);
    5. **event log** — the (key, etag) multiset of delivery records equals
       the sim's researcher-visible delivery ledger;
    6. **lake bytes** — every byte served out of / written into the lake has
       a ledger record: summed ``lake_hit``/``lake_write`` sizes equal the
       lake's own counters, and ``lru`` evictions match the eviction count;
    7. **DLQ** — dead-letter records match the broker's DLQ exactly;
    8. **ingest** — ``(feed_seq, outcome)`` of ingest records equals the
       durable checkpoint's outcome map (survives pooler crash rebuilds).

    Skipped when the run was configured with ``audit=False`` — NULL_LEDGER
    records nothing by design. Negative controls: ``audit_drop_provenance``
    (clauses 3+5), a mid-file byte flip (clause 1), and test-side counter /
    DLQ tampering (clauses 6+7)."""

    name = "audit_completeness"

    def check(self, sim: "FleetSim") -> List[Violation]:
        ledger = getattr(sim, "ledger", None)
        if ledger is None or not getattr(ledger, "enabled", False):
            return []
        from collections import Counter

        from repro_torch.audit.ledger import AuditLedger
        from repro_torch.audit.records import (
            DEAD_LETTER,
            DELIVERY,
            INGEST_APPLY,
            LAKE_EVICT,
            LAKE_HIT,
            LAKE_WRITE,
            PROVENANCE,
        )

        out: List[Violation] = []
        # 1. hash chain intact on disk
        for problem in ledger.verify():
            out.append(self._v(f"chain: {problem}"))
        # 2. durable replay reproduces the live chain
        replayed = AuditLedger(ledger.path)
        try:
            if replayed.digest() != ledger.digest():
                out.append(
                    self._v(
                        f"durability: replayed digest {replayed.digest()[:12]} != "
                        f"live {ledger.digest()[:12]}"
                    )
                )
        finally:
            replayed.close()
        # 3. ledger <-> journal: every completion left exactly one matching
        # cold provenance record, and nothing was chopped off the tail
        provs = ledger.records(PROVENANCE)
        cold = [p for p in provs if p.get("temp") == "cold"]
        by_key_etag = Counter((p.get("key"), p.get("etag")) for p in cold)
        deployed = set(sim._pipelines)
        for key in sorted(sim.journal.completed_keys()):
            etag = sim.journal.etag_for(key)
            n = by_key_etag.get((key, etag), 0)
            if n != 1:
                out.append(
                    self._v(
                        f"journal: completed {key} (etag {str(etag)[:12]}) has "
                        f"{n} cold provenance record(s), want exactly 1"
                    )
                )
        for p in cold:
            if p.get("ruleset") not in deployed:
                out.append(
                    self._v(
                        f"journal: provenance for {p.get('key')} names ruleset "
                        f"{str(p.get('ruleset'))[:12]} this fleet never deployed"
                    )
                )
        processed = sum(w.processed for w in sim.pool._all_workers)
        if len(cold) != processed:
            out.append(
                self._v(
                    f"journal: {len(cold)} cold provenance records != "
                    f"{processed} processed completions (ledger truncated?)"
                )
            )
        # 4. ledger <-> trace spans
        tracer = getattr(sim, "tracer", None)
        if tracer is not None and getattr(tracer, "enabled", False):
            roots = {
                s.trace_id for s in tracer.spans() if s.name == "worker.process"
            }
            for p in cold:
                if p.get("trace_id") not in roots:
                    out.append(
                        self._v(
                            f"traces: provenance for {p.get('key')} trace id "
                            f"{p.get('trace_id')} has no worker.process span"
                        )
                    )
        # 5. ledger <-> event log: delivery multisets agree
        led = Counter(
            (r.get("key"), r.get("etag")) for r in ledger.records(DELIVERY)
        )
        logged = Counter((d["key"], d["etag"]) for d in sim.delivery_log)
        if led != logged:
            missing = logged - led
            extra = led - logged
            out.append(
                self._v(
                    "event log: delivery multiset mismatch "
                    f"(unledgered={sorted(missing, key=str)} "
                    f"phantom={sorted(extra, key=str)})"
                )
            )
        # 6. every lake byte in/out/evicted is accounted
        hit_bytes = sum(r.get("nbytes", 0) for r in ledger.records(LAKE_HIT))
        write_bytes = sum(r.get("nbytes", 0) for r in ledger.records(LAKE_WRITE))
        lru_evicts = sum(
            1 for r in ledger.records(LAKE_EVICT) if r.get("reason") == "lru"
        )
        if hit_bytes != sim.lake.stats.bytes_out:
            out.append(
                self._v(
                    f"lake: ledgered hit bytes {hit_bytes} != "
                    f"bytes_out {sim.lake.stats.bytes_out}"
                )
            )
        if write_bytes != sim.lake.stats.bytes_in:
            out.append(
                self._v(
                    f"lake: ledgered write bytes {write_bytes} != "
                    f"bytes_in {sim.lake.stats.bytes_in}"
                )
            )
        if lru_evicts != sim.lake.stats.evictions:
            out.append(
                self._v(
                    f"lake: {lru_evicts} ledgered lru evictions != "
                    f"{sim.lake.stats.evictions} counted"
                )
            )
        # 7. dead-letter records mirror the broker's DLQ
        led_dlq = sorted(r.get("key") for r in ledger.records(DEAD_LETTER))
        broker_dlq = sorted(m.key for m in sim.broker.dead_letter)
        if led_dlq != broker_dlq:
            out.append(
                self._v(
                    f"dlq: ledgered {led_dlq} != broker {broker_dlq}"
                )
            )
        # 8. ingest outcomes mirror the durable checkpoint
        if sim.feed is not None and sim.applier is not None:
            led_ops = Counter(
                (r.get("feed_seq"), r.get("outcome"))
                for r in ledger.records(INGEST_APPLY)
            )
            ckpt_ops = Counter(
                (seq, rec.get("outcome"))
                for seq, rec in sim.applier.checkpoint.outcomes.items()
            )
            if led_ops != ckpt_ops:
                out.append(
                    self._v(
                        "ingest: ledgered outcomes disagree with checkpoint "
                        f"(missing={sorted(ckpt_ops - led_ops)} "
                        f"extra={sorted(led_ops - ckpt_ops)})"
                    )
                )
        return out


DEFAULT_CHECKERS = (
    ExactlyOnceDelivery(),
    PhiBoundary(),
    WarmReplayIdentity(),
    AutoscalerAccounting(),
    NoWedgedSubscribers(),
    LakeConsistency(),
    JournalDurability(),
    QueryConsistency(),
    CheckpointMonotonicity(),
    Freshness(),
    NoFullReingest(),
    TraceIntegrity(),
    TelemetryPhiBoundary(),
    MetricsConservation(),
    SloConformance(),
    AuditCompleteness(),
)
