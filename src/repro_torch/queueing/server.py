"""Central workflow server (paper §Method: "A central database and server
component ... to store workflow information relevant to the lifetime of a
de-identification request").

Responsibilities reproduced:
  * registry of research studies (IRB protocols) with their trust mode and key;
  * accession validation ("first validated as eligible for research");
  * pseudonym minting (anon accession, anon MRN, per-patient date jitter);
  * publishing one message per accession to the broker;
  * request lifecycle state (pending / queued / done) backed by the journal.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional, Set

from repro_torch.core.pipeline import build_request
from repro_torch.core.pseudonym import PseudonymService, TrustMode
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.queueing.broker import Broker
from repro_torch.queueing.journal import Journal
from repro_torch.storage.object_store import StudyStore
from repro_torch.utils.logging import get_logger

log = get_logger("queueing.server")


class RequestState(Enum):
    PENDING = "pending"
    QUEUED = "queued"
    DONE = "done"
    REJECTED = "rejected"


@dataclass
class WorkflowRecord:
    research_study: str
    accession: str
    state: RequestState
    anon_accession: str = ""
    reason: str = ""


class DeidService:
    def __init__(
        self,
        broker: Broker,
        lake: StudyStore,
        journal: Journal,
        result_lake=None,
        pipeline=None,
        catalog=None,
        tracer=None,
        registry=None,
        ledger=None,
    ) -> None:
        self.broker = broker
        self.lake = lake
        self.journal = journal
        # one deployment, one tracer: without its own, the service records
        # on the worker pipeline's
        if tracer is None:
            tracer = pipeline.tracer if pipeline is not None else NULL_TRACER
        self.tracer = tracer
        # audit ledger (repro_torch.audit): handed to the planner so warm/journal
        # admissions account their deliveries; workers get it via the pool
        self.ledger = ledger
        # optional metadata catalog (repro_torch.catalog.StudyCatalog): enables
        # query-then-de-identify via submit_query
        self.catalog = catalog
        self._studies: Dict[str, PseudonymService] = {}
        self._ineligible: Set[str] = set()  # e.g. research-opt-out patients
        self.records: List[WorkflowRecord] = []
        # cohort planner over the de-id result lake (DESIGN.md §6). The
        # planner's ruleset digest must match the worker pipeline's, so both
        # are wired from the same DeidPipeline instance.
        self.planner = None
        # optional health controller (repro_torch.obs.health): health_report()
        # snapshots SLO states / burn / budgets for operators
        self.health = None
        if result_lake is not None:
            if pipeline is None:
                raise ValueError(
                    "result_lake requires the worker DeidPipeline (ruleset digest)"
                )
            from repro_torch.lake.planner import CohortPlanner

            self.planner = CohortPlanner(
                result_lake,
                lake,
                broker,
                journal,
                validate=self.validate,
                ruleset_digest=pipeline.ruleset_fingerprint().digest,
                tracer=self.tracer,
                registry=registry,
                ledger=ledger,
            )

    # --------------------------------------------------------------- health
    def attach_health(self, controller) -> None:
        """Attach a :class:`repro_torch.obs.health.HealthController`; after this,
        :meth:`health_report` snapshots it at the broker clock's now."""
        self.health = controller

    def health_report(self):
        if self.health is None:
            raise RuntimeError("no health controller attached; call attach_health()")
        return self.health.snapshot(self.broker.clock.now())

    # -------------------------------------------------------------- studies
    def register_study(
        self, study_id: str, mode: TrustMode = TrustMode.POST_IRB, key: Optional[bytes] = None
    ) -> PseudonymService:
        if mode is TrustMode.POST_IRB and key is None:
            # per-protocol persistent key (stored in the central DB in prod)
            key = study_id.encode().ljust(32, b"\0")[:32]
        svc = PseudonymService(study_id, mode, key=key)
        self._studies[study_id] = svc
        return svc

    def mark_ineligible(self, accession: str) -> None:
        self._ineligible.add(accession)

    # -------------------------------------------------------------- requests
    def validate(self, accession: str) -> tuple[bool, str]:
        if accession in self._ineligible:
            return False, "accession opted out of research use"
        if not self.lake.has_study(accession):
            return False, "accession not present in the data lake"
        return True, ""

    @staticmethod
    def _dedupe(accessions: List[str]) -> List[str]:
        """Drop repeated accessions, keeping stable first-occurrence order —
        a duplicated accession in one request must neither double-publish
        nor double-count planner admission stats."""
        seen: Set[str] = set()
        out: List[str] = []
        for acc in accessions:
            if acc not in seen:
                seen.add(acc)
                out.append(acc)
        return out

    def submit(self, study_id: str, accessions: List[str], mrn_lookup: Dict[str, str]) -> List[WorkflowRecord]:
        """Validate + pseudonymize + enqueue one request per accession."""
        if study_id not in self._studies:
            raise KeyError(f"research study {study_id!r} not registered")
        pseudo = self._studies[study_id]
        out: List[WorkflowRecord] = []
        with self.tracer.span("service.submit", n=len(accessions)):
            out = self._submit_traced(pseudo, study_id, accessions, mrn_lookup)
        return out

    def _submit_traced(
        self, pseudo: PseudonymService, study_id: str,
        accessions: List[str], mrn_lookup: Dict[str, str],
    ) -> List[WorkflowRecord]:
        out: List[WorkflowRecord] = []
        for acc in self._dedupe(accessions):
            ok, reason = self.validate(acc)
            key = f"{study_id}/{acc}"
            done_etag = self.journal.etag_for(key)
            fresh_done = self.journal.is_done(key) and (
                done_etag is None or done_etag == self.lake.study_etag(acc)
            )
            if not ok:
                rec = WorkflowRecord(study_id, acc, RequestState.REJECTED, reason=reason)
            elif fresh_done:
                rec = WorkflowRecord(study_id, acc, RequestState.DONE)
            else:
                req = build_request(pseudo, acc, mrn_lookup[acc])
                if self.planner is not None:
                    # route through the single-flight registry: no duplicate
                    # publish when a cohort (or earlier submit) already has
                    # this accession in flight, and cohorts arriving later
                    # coalesce onto this publish
                    self.planner.admit(pseudo, acc, req)
                else:
                    # metadata-only: blob size estimates backlog without
                    # reading (decrypting) the study the worker fetches anyway
                    self.broker.publish(
                        key=f"{study_id}/{acc}",
                        payload={"accession": acc, "request": req.__dict__},
                        nbytes=self.lake.study_nbytes(acc) or 0,
                    )
                rec = WorkflowRecord(study_id, acc, RequestState.QUEUED, req.anon_accession)
            out.append(rec)
            self.records.append(rec)
        return out

    def submit_cohort(
        self,
        study_id: str,
        accessions: List[str],
        mrn_lookup: Dict[str, str],
        selection_digest: str = "",
    ):
        """Cohort admission through the planner: warm accessions are served
        from the result lake, in-flight ones coalesce onto existing work
        (single-flight), and only the cold slice is published to the broker.
        Returns the :class:`repro_torch.lake.planner.CohortTicket`."""
        if self.planner is None:
            raise RuntimeError("no result lake configured; use submit()")
        if study_id not in self._studies:
            raise KeyError(f"research study {study_id!r} not registered")
        with self.tracer.span("service.submit_cohort", n=len(accessions)) as sp:
            ticket = self.planner.submit(
                self._studies[study_id],
                self._dedupe(accessions),
                mrn_lookup,
                selection_digest=selection_digest,
            )
            sp.set(cohort_id=ticket.cohort_id, cold=len(ticket.cold))
        for acc in ticket.hits:
            self.records.append(
                WorkflowRecord(study_id, acc, RequestState.DONE)
            )
        for acc in ticket.coalesced + ticket.cold:
            self.records.append(WorkflowRecord(study_id, acc, RequestState.QUEUED))
        for acc, reason in ticket.rejected.items():
            self.records.append(
                WorkflowRecord(study_id, acc, RequestState.REJECTED, reason=reason)
            )
        return ticket

    def submit_query(self, study_id: str, query, mrn_lookup: Dict[str, str]):
        """Query-then-de-identify (the paper's core workflow): resolve a
        metadata predicate against the catalog, then admit the matching
        cohort through the planner. The selection digest — sha256 of
        (catalog snapshot, canonical query) — rides the ticket, pinning
        exactly which catalog state answered the query.

        Returns ``(CohortSelection, CohortTicket)``. ``mrn_lookup`` must
        cover every accession the catalog can return (in production the
        central DB joins this; here callers pass the ingest-time map).
        """
        if self.catalog is None:
            raise RuntimeError("no metadata catalog attached; pass catalog= or set .catalog")
        with self.tracer.span("service.submit_query") as sp:
            with self.tracer.stage("service.select"):
                selection = self.catalog.select(query)
            sp.set(matched=len(selection.accessions))
            ticket = self.submit_cohort(
                study_id,
                list(selection.accessions),
                mrn_lookup,
                selection_digest=selection.digest,
            )
        return selection, ticket

    def request_states(self, study_id: str) -> Dict[str, RequestState]:
        out: Dict[str, RequestState] = {}
        for rec in self.records:
            if rec.research_study == study_id:
                state = rec.state
                if state is RequestState.QUEUED and self.journal.is_done(f"{study_id}/{rec.accession}"):
                    state = RequestState.DONE
                out[rec.accession] = state
        return out
