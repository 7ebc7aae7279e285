"""Cohort request planner: warm/in-flight/cold partitioning + single-flight
coalescing (DESIGN.md §6).

Researchers request overlapping cohorts (lists of accessions). The planner is
the admission layer in front of the broker that makes repeat traffic cheap:

* **warm** — a study-level record exists in the result lake and every
  instance record it references is still resident: the results are served
  straight from the lake. Zero broker publishes, zero kernel dispatches.
* **in-flight** — another cohort already published this accession and a
  worker is (or will be) computing it: the new request *subscribes* to the
  existing computation instead of publishing duplicate work (single-flight).
* **cold** — genuinely new work: published to the broker, registered as
  in-flight so later requesters coalesce onto it.

Single-flight composes with the journal's exactly-once dedup rather than
replacing it: the planner stops duplicate *publishes* at admission; the
journal still stops duplicate *completions* (crash redelivery, speculative
clones) behind the broker. A journal-done accession whose lake entries were
evicted is still reported warm — its outputs were already delivered — with
the manifest replayed from the journal.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from repro_torch.audit.ledger import NULL_LEDGER
from repro_torch.audit.records import DELIVERY, PROVENANCE
from repro_torch.core.manifest import Manifest
from repro_torch.core.pipeline import DeidRequest, build_request
from repro_torch.core.pseudonym import PseudonymService
from repro_torch.dicom.dataset import DicomDataset
from repro_torch.lake.fingerprint import request_salt, study_key
from repro_torch.lake.records import decode_instance_record, decode_study_record
from repro_torch.lake.store import ResultLake
from repro_torch.obs.metrics import StatsShim
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.queueing.broker import Broker
from repro_torch.queueing.journal import Journal
from repro_torch.storage.object_store import StudyStore
from repro_torch.utils.logging import get_logger

log = get_logger("lake.planner")


class PlannerStats(StatsShim):
    """Planner admission counters as real metrics (``repro_planner_*``).

    The conservation identities the sim audits:
    ``accessions == lake_hits + journal_hits + coalesced + published + rejected``
    and ``published == resolved + dead_lettered + len(inflight)``.
    """

    _SUBSYSTEM = "planner"
    _FIELDS = (
        "accessions",
        "lake_hits",        # served entirely from the result lake
        "journal_hits",     # already completed; outputs delivered previously
        "coalesced",        # subscribed to an in-flight computation
        "published",        # cold: emitted to the broker
        "rejected",
        "resolved",         # in-flight completions handed to subscribers
        "demoted",          # study record found but instance blobs evicted
        "dead_lettered",    # in-flight work that exhausted its deliveries
        "stale_refreshes",  # journal-done keys republished: source mutated
    )


@dataclass
class CohortTicket:
    """One cohort request's view of its accessions.

    ``manifests``/``outputs`` are filled immediately for warm accessions and
    at :meth:`CohortPlanner.resolve` time for coalesced/cold ones (outputs
    only while the lake still holds them; cold outputs are always also
    delivered to the researcher bucket by the worker)."""

    cohort_id: int
    study_id: str
    # digest of (catalog snapshot, query) when this cohort came from
    # DeidService.submit_query — joins the warm-replay identity: the same
    # selection digest is guaranteed to name the same cohort, so a replayed
    # query is attributable to the exact catalog state that answered it
    selection_digest: str = ""
    hits: List[str] = field(default_factory=list)
    coalesced: List[str] = field(default_factory=list)
    cold: List[str] = field(default_factory=list)
    rejected: Dict[str, str] = field(default_factory=dict)
    failed: Dict[str, str] = field(default_factory=dict)  # e.g. dead-lettered
    manifests: Dict[str, Manifest] = field(default_factory=dict)
    outputs: Dict[str, List[DicomDataset]] = field(default_factory=dict)
    pending: Set[str] = field(default_factory=set)

    def done(self) -> bool:
        return not self.pending


@dataclass
class _InFlight:
    accession: str
    request: DeidRequest
    tickets: List[CohortTicket] = field(default_factory=list)
    published_at: float = 0.0  # broker publish_time of THIS registration


class CohortPlanner:
    def __init__(
        self,
        result_lake: ResultLake,
        source: StudyStore,
        broker: Broker,
        journal: Journal,
        validate: Optional[Callable[[str], Tuple[bool, str]]] = None,
        ruleset_digest: str = "",
        tracer=None,
        registry=None,
        ledger=None,
    ) -> None:
        self.result_lake = result_lake
        self.source = source
        self.broker = broker
        self.journal = journal
        self.validate = validate
        # must match the digest of the pipeline serving the worker pool —
        # DeidService wires both sides from the same DeidPipeline
        self.ruleset_digest = ruleset_digest
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.ledger = ledger if ledger is not None else NULL_LEDGER
        self.stats = PlannerStats(registry)
        self._inflight: Dict[str, _InFlight] = {}
        self._cohorts = 0

    # ------------------------------------------------------------- admission
    def submit(
        self,
        pseudo: PseudonymService,
        accessions: List[str],
        mrn_lookup: Dict[str, str],
        selection_digest: str = "",
    ) -> CohortTicket:
        """Partition one cohort request and publish only the cold slice.
        Callers are expected to pass deduplicated accessions
        (``DeidService`` does); a duplicate here would coalesce the second
        occurrence onto the first rather than double-publish, but would still
        double-count admission stats."""
        # opportunistically clear finished in-flight work first, so a key
        # completed since the last resolve() is served warm rather than
        # coalesced onto a registration nobody will ever resolve
        self.resolve()
        self._cohorts += 1
        ticket = CohortTicket(
            cohort_id=self._cohorts,
            study_id=pseudo.study_id,
            selection_digest=selection_digest,
        )
        with self.tracer.span(
            "planner.partition", cohort_id=ticket.cohort_id, n=len(accessions)
        ) as _part_span:
            self._partition(pseudo, accessions, mrn_lookup, ticket)
            _part_span.set(
                warm=len(ticket.hits),
                coalesced=len(ticket.coalesced),
                cold=len(ticket.cold),
                rejected=len(ticket.rejected),
            )
        return ticket

    def _partition(
        self,
        pseudo: PseudonymService,
        accessions: List[str],
        mrn_lookup: Dict[str, str],
        ticket: CohortTicket,
    ) -> None:
        with self.ledger.batch():  # one fsync per cohort admission
            self._partition_batched(pseudo, accessions, mrn_lookup, ticket)

    def _partition_batched(
        self,
        pseudo: PseudonymService,
        accessions: List[str],
        mrn_lookup: Dict[str, str],
        ticket: CohortTicket,
    ) -> None:
        for acc in accessions:
            self.stats.accessions += 1
            if self.validate is not None:
                ok, reason = self.validate(acc)
                if not ok:
                    ticket.rejected[acc] = reason
                    self.stats.rejected += 1
                    continue
            key = f"{pseudo.study_id}/{acc}"
            entry = self._inflight.get(key)
            if entry is not None:  # single-flight: subscribe, don't republish
                entry.tickets.append(ticket)
                ticket.coalesced.append(acc)
                ticket.pending.add(acc)
                self.stats.coalesced += 1
                continue
            request = build_request(pseudo, acc, mrn_lookup[acc])
            warm = self._materialize(acc, request)
            if warm is not None:
                ticket.hits.append(acc)
                ticket.outputs[acc], ticket.manifests[acc] = warm
                self.stats.lake_hits += 1
                self._record_hit(key, acc, request, temp="warm", instances=len(warm[0]))
                continue
            done = self.journal.manifest_for(key)
            if done is not None and not self._journal_stale(key, acc):
                # completed before, lake since evicted: outputs already sit in
                # the researcher bucket; replay the manifest only
                ticket.hits.append(acc)
                ticket.manifests[acc] = done
                self.stats.journal_hits += 1
                self._record_hit(key, acc, request, temp="journal", instances=0)
                continue
            if done is not None:
                # journal-done but the source mutated since: the recorded
                # manifest describes pre-mutation bytes. Freshness fencing:
                # never replay it — republish so only the changed content is
                # re-de-identified (the worker supersedes the journal entry)
                self.stats.stale_refreshes += 1
            ticket.cold.append(acc)
            ticket.pending.add(acc)
            self._register_and_publish(key, acc, request, [ticket])

    def admit(self, pseudo: PseudonymService, accession: str, request: DeidRequest) -> bool:
        """Single-flight admission for non-cohort submits (`DeidService.submit`).
        Returns False when the key is already in flight — the caller must not
        publish a duplicate; otherwise publishes and registers it so later
        cohorts coalesce onto this work. No ticket: plain submits track
        completion through the journal, not through subscriptions."""
        key = f"{pseudo.study_id}/{accession}"
        if key in self._inflight:
            self.stats.coalesced += 1
            return False
        self._register_and_publish(key, accession, request, [])
        return True

    def _register_and_publish(
        self, key: str, accession: str, request: DeidRequest, tickets: List[CohortTicket]
    ) -> None:
        # metadata-only admission: stored size is the backlog estimate;
        # only the worker ever reads (and pays egress for) the study
        self.broker.publish(
            key=key,
            payload={"accession": accession, "request": request.__dict__},
            nbytes=self.source.study_nbytes(accession) or 0,
        )
        self._inflight[key] = _InFlight(
            accession, request, tickets, published_at=self.broker.clock.now()
        )
        self.stats.published += 1

    # ------------------------------------------------------------ completion
    def resolve(self) -> List[str]:
        """Hand completed in-flight accessions to every subscribed ticket.
        Call after (or during) a pool drain; returns the resolved keys.

        In-flight work whose message exhausted its delivery budget (DLQ) is
        *failed out*: subscribers are unblocked with an error instead of
        waiting forever, and the registration is dropped so a later cohort
        can republish once the fault clears."""
        # match DLQ entries to *this* registration via publish_time: the DLQ
        # list is cumulative, and a key dead-lettered once must not poison a
        # later republish of the same accession (redeliveries and speculative
        # clones keep the original publish_time, so they still match)
        dead = {(m.key, m.publish_time) for m in self.broker.dead_letter}
        resolved: List[str] = []
        for key, entry in list(self._inflight.items()):
            if not self.journal.is_done(key):
                # fail out only when no live copy remains: a speculative clone
                # may dead-letter while the original delivery still completes
                if (key, entry.published_at) in dead and not self.broker.has_live(key):
                    for ticket in entry.tickets:
                        ticket.pending.discard(entry.accession)
                        ticket.failed[entry.accession] = (
                            "dead-lettered after max deliveries"
                        )
                    del self._inflight[key]
                    self.stats.dead_lettered += 1
                    self.tracer.event("planner.failout", key=key)
                continue
            warm = self._materialize(entry.accession, entry.request)
            manifest = warm[1] if warm is not None else self.journal.manifest_for(key)
            for ticket in entry.tickets:
                ticket.pending.discard(entry.accession)
                if manifest is not None:
                    ticket.manifests[entry.accession] = manifest
                if warm is not None:
                    ticket.outputs[entry.accession] = warm[0]
            del self._inflight[key]
            self.stats.resolved += 1
            resolved.append(key)
        if resolved:
            # emit only when work actually resolved: resolve() runs on every
            # sim step, and an unconditional event would swamp the trace
            self.tracer.event("planner.resolve", n=len(resolved))
        return resolved

    def inflight_keys(self) -> List[str]:
        return list(self._inflight)

    def audit_wedged(self) -> List[str]:
        """Registrations whose subscribers can never be resolved: no live
        broker copy remains, the journal never saw a completion, and the DLQ
        holds no entry :meth:`resolve` could fail them out with. A non-empty
        result means tickets would wait forever — the invariant the fleet
        simulator's conformance suite checks after every run (call
        :meth:`resolve` first so resolvable work doesn't show up here)."""
        dead = {(m.key, m.publish_time) for m in self.broker.dead_letter}
        wedged = []
        for key, entry in self._inflight.items():
            if self.journal.is_done(key) or self.broker.has_live(key):
                continue
            if (key, entry.published_at) in dead:
                continue  # resolve() will fail this one out to its tickets
            wedged.append(key)
        return wedged

    # ------------------------------------------------------------- internals
    def _record_hit(
        self, key: str, accession: str, request: DeidRequest, temp: str, instances: int
    ) -> None:
        """Delivery + provenance records for a warm/journal-hit admission.
        Warm hits disclose lake bytes (each underlying read already emitted a
        ``lake_hit`` record); journal hits replay only the manifest. The etag
        recorded is the *current* source etag — the freshness check that
        admitted the hit proved it matches the completed version."""
        etag = self.source.study_etag(accession)
        skey = (
            study_key(accession, etag, self.ruleset_digest, request_salt(request))
            if temp == "warm" and etag is not None else ""
        )
        self.ledger.append(
            DELIVERY, key=key, accession=accession, etag=etag, temp=temp, worker="planner"
        )
        self.ledger.append(
            PROVENANCE,
            key=key,
            project=request.research_study,
            accession=accession,
            lake_key=skey,
            etag=etag,
            ruleset=self.ruleset_digest,
            detector_sha="",
            kernel_path="lake" if temp == "warm" else "journal",
            batched=0,
            trace_id="",
            temp=temp,
            instances=instances,
            nbytes=0,
        )

    def _journal_stale(self, key: str, accession: str) -> bool:
        """True when the journal's completion for ``key`` was computed from a
        source version that has since mutated (etag drift). Legacy records
        without an etag are treated as fresh — staleness must be proven."""
        done_etag = self.journal.etag_for(key)
        current = self.source.study_etag(accession)
        return done_etag is not None and current is not None and done_etag != current

    def _materialize(
        self, accession: str, request: DeidRequest
    ) -> Optional[Tuple[List[DicomDataset], Manifest]]:
        """Reassemble a study's outputs purely from the lake, or None when any
        piece is missing (no study record, or instance blobs evicted)."""
        etag = self.source.study_etag(accession)
        if etag is None:
            return None
        skey = study_key(accession, etag, self.ruleset_digest, request_salt(request))
        blob = self.result_lake.get(skey)
        if blob is None:
            return None
        instance_keys = decode_study_record(blob)
        # reading every instance record back out of the lake: the ticket's
        # outputs (cohort admission's warm hits, and resolve's completions)
        with self.tracer.stage("planner.materialize", instances=len(instance_keys)):
            if not all(self.result_lake.contains(k) for k in instance_keys):
                # partially evicted: drop the stale study record and recompute
                self.result_lake.delete(skey)
                self.stats.demoted += 1
                return None
            manifest = Manifest(
                request_id=f"{request.research_study}/{request.anon_accession}"
            )
            outputs: List[DicomDataset] = []
            for k in instance_keys:
                rec = self.result_lake.get(k)
                if rec is None:  # raced an eviction between contains() and get()
                    self.stats.demoted += 1
                    return None
                dataset, entry = decode_instance_record(rec)
                manifest.add(entry)
                if dataset is not None:
                    outputs.append(dataset)
            return outputs, manifest
