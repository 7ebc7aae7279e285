"""Drain workers + pool orchestration (paper §Method d).

"Each worker retrieves messages from the queue, downloads and de-identifies
the DICOM files ..., and uploads the de-identified images to an object store
accessible to the researcher. Compute instances are deleted once the message
queue is empty, and a manifest file is created."

The pool is a deterministic single-threaded simulation: workers are
interleaved round-robin, processing time is modeled from bytes/throughput and
advanced on the shared SimClock. Fault tolerance mechanics are real, not
mocked: a crash abandons the lease mid-flight, the visibility timeout
redelivers, the journal dedups double completions from speculative
re-dispatch (straggler mitigation).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.audit.ledger import NULL_LEDGER
from repro_torch.audit.records import DELIVERY, PROVENANCE, SOURCE_FETCH
from repro_torch.core.manifest import Manifest
from repro_torch.core.pipeline import DeidPipeline, DeidRequest
from repro_torch.obs.metrics import StatsShim
from repro_torch.obs.trace import trace_id_for
from repro_torch.queueing.autoscaler import Autoscaler
from repro_torch.queueing.broker import Broker, Message
from repro_torch.queueing.journal import Journal
from repro_torch.storage.object_store import StudyStore
from repro_torch.utils.logging import get_logger

log = get_logger("queueing.worker")


class WorkerCrash(RuntimeError):
    pass


@dataclass
class FailureInjector:
    """Deterministic fault model: crash and/or stall specific (worker, key)
    pairs. Hash-based so runs are reproducible regardless of scheduling."""

    crash_rate: float = 0.0       # fraction of (worker, key, delivery) crashed
    straggler_rate: float = 0.0   # fraction processed at slow_factor speed
    slow_factor: float = 10.0
    crash_once_keys: frozenset = frozenset()  # crash first delivery of these keys

    def _u(self, *parts: object) -> float:
        h = hashlib.sha256("|".join(map(str, parts)).encode()).digest()
        return int.from_bytes(h[:8], "big") / 2**64

    def should_crash(self, worker_id: str, msg: Message) -> bool:
        if msg.key in self.crash_once_keys and msg.deliveries == 1:
            return True
        return self._u("crash", worker_id, msg.key, msg.deliveries) < self.crash_rate

    def slowdown(self, worker_id: str, msg: Message) -> float:
        if self._u("slow", worker_id, msg.key) < self.straggler_rate:
            return self.slow_factor
        return 1.0


@dataclass
class DeidWorker:
    worker_id: str
    pipeline: DeidPipeline
    source: StudyStore
    dest: StudyStore
    journal: Journal
    throughput: float = 160e6  # bytes/s of de-id compute (paper-calibrated)
    fence_stale_reads: bool = True  # abort deliveries computed from mutated bytes
    heartbeat_grace: float = 30.0   # lease headroom requested before delivery
    processed: int = 0
    deduped: int = 0
    batched_instances: int = 0  # instances that went through the fused batch path
    lake_hits: int = 0          # instances short-circuited by the result lake
    lake_misses: int = 0
    unknown_devices: int = 0    # registry misses (unknown manufacturer/model)
    detector_runs: int = 0      # burned-in text detector scans this worker ran
    fenced: int = 0             # stale-byte fences: source mutated mid-compute
    zombie_aborts: int = 0      # lease lost mid-compute: aborted without ack
    evicted_stale: int = 0      # superseded study records dropped from the lake
    tracer: object = None       # repro_torch.obs Tracer (None -> the pipeline's)
    ledger: object = None       # repro_torch.audit AuditLedger (None -> NULL_LEDGER)
    # negative-control knob for the AuditCompleteness checker: suppress the
    # delivery/provenance records a completion is supposed to produce
    audit_emit_provenance: bool = True

    def process(self, broker: Broker, msg: Message, injector: Optional[FailureInjector] = None) -> float:
        """Process one message; returns simulated seconds of work.

        The whole delivery runs under a ``worker.process`` root span whose
        trace id is derived from (key, delivery attempt) — the same id the
        broker stamped on this delivery's lease event — with child spans for
        fetch, de-id compute, lake write-back, and delivery. A crash
        propagates through the span (recorded as ``error=WorkerCrash``), so
        chaos runs leave an auditable retry chain across attempts.
        """
        tracer = self.tracer if self.tracer is not None else self.pipeline.tracer
        with tracer.span(
            "worker.process",
            trace_id=trace_id_for(msg.key, msg.deliveries),
            key=msg.key,
            attempt=msg.deliveries,
            worker=self.worker_id,
        ) as span:
            seconds = self._process_traced(broker, msg, injector, tracer, span)
            span.set(busy_s=seconds)
            return seconds

    def _process_traced(
        self, broker: Broker, msg: Message, injector, tracer, span
    ) -> float:
        request = DeidRequest(**msg.payload["request"])
        key = msg.key
        accession = msg.payload["accession"]

        if self.journal.is_done(key):
            done_etag = self.journal.etag_for(key)
            current = self.source.study_etag(accession)
            if done_etag is None or current is None or done_etag == current:
                # duplicate delivery of completed work: ack, drop (exactly-once)
                broker.ack(msg.msg_id)
                self.deduped += 1
                span.set(deduped=True)
                return 0.0
            # completed for a *previous* source version: the source mutated
            # since — fall through and re-de-identify (incremental re-deid);
            # record_done will supersede the stale journal entry

        if injector and injector.should_crash(self.worker_id, msg):
            # crash mid-processing: lease is abandoned, no ack, no journal entry
            raise WorkerCrash(f"{self.worker_id} crashed on {key} (delivery {msg.deliveries})")

        # pin the source version alongside the read: the study record must
        # bind results to the bytes we actually de-identified, not whatever
        # the source holds after a concurrent re-ingest
        with tracer.span("worker.fetch", accession=accession) as fetch_span:
            source_etag = self.source.study_etag(accession)
            if source_etag is None:
                # deleted while queued: nack toward the DLQ so the planner fails
                # subscribers out instead of leaving them waiting on erased bytes
                broker.nack(msg.msg_id)
                self.fenced += 1
                fetch_span.set(fenced=True)
                span.set(fenced=True)
                return 0.0
            study = self.source.get_study(accession)
            fetch_span.set(nbytes=study.nbytes(), instances=len(study.datasets),
                           modality=str(getattr(study, "modality", None) or "NA"))
        # the fetch itself is a PHI access (identified bytes left the source),
        # auditable even when a later fence discards this attempt's work
        ledger = self.ledger if self.ledger is not None else NULL_LEDGER
        with tracer.stage("worker.commit", record=SOURCE_FETCH):
            ledger.append(
                SOURCE_FETCH,
                key=key,
                accession=accession,
                etag=source_etag,
                worker=self.worker_id,
                attempt=msg.deliveries,
                nbytes=study.nbytes(),
            )
        slowdown = injector.slowdown(self.worker_id, msg) if injector else 1.0
        work_seconds = (study.nbytes() / self.throughput) * slowdown
        batched0 = self.pipeline.executor.stats.instances if self.pipeline.executor else 0
        dstats = self.pipeline.scrub.detect_stats
        unknown0, druns0 = dstats.unknown_lookups, dstats.detector_runs
        with tracer.span("worker.deid", bytes_in=study.nbytes(), busy_s=work_seconds):
            result = self.pipeline.run_study(study, request, self.worker_id)
        outputs, manifest = result.delivered, result.manifest
        batched_delta = 0
        if self.pipeline.executor is not None:
            batched_delta = self.pipeline.executor.stats.instances - batched0
            self.batched_instances += batched_delta
        self._batched_delta = batched_delta  # provenance: batch-bucket fact
        # unknown-device lookups are a surfaced worker metric, never a silent
        # pass-through (the shared scrub stage counts; workers take deltas)
        self.unknown_devices += dstats.unknown_lookups - unknown0
        self.detector_runs += dstats.detector_runs - druns0
        self.lake_hits += result.cache_hits
        self.lake_misses += result.cache_misses

        # heartbeat before delivering: if the lease expired mid-compute this
        # worker is a zombie — the broker already redelivered under a fresh
        # ack token, so delivering or journaling here would race the new owner
        if not broker.extend_lease(msg.msg_id, work_seconds + self.heartbeat_grace):
            self.zombie_aborts += 1
            span.set(kind="zombie_abort")
            return work_seconds

        # stale-byte fence: a source mutation that raced this computation must
        # invalidate, never deliver — drop the lease work and let redelivery
        # read the post-mutation bytes
        if self.fence_stale_reads and self.source.study_etag(accession) != source_etag:
            broker.nack(msg.msg_id)
            self.fenced += 1
            span.set(fenced=True)
            return work_seconds

        request_id = f"{request.research_study}/{request.anon_accession}"
        with tracer.span("worker.deliver", datasets=len(outputs)):
            for ds in outputs:
                self.dest.put_output(request_id, str(ds.get("SOPInstanceUID", "?")), ds)
        with tracer.span("worker.writeback", accession=accession) as wb_span:
            self._record_study(accession, source_etag, request, result)
            wb_span.set(lake_hits=result.cache_hits, cold=result.cache_misses)

        with tracer.stage("worker.commit", record="done"):
            if self.journal.record_done(key, manifest, self.worker_id, source_etag=source_etag):
                self.processed += 1
                span.set(ok=True)
                if self.audit_emit_provenance:
                    self._record_provenance(
                        ledger, key, accession, source_etag, request, result, msg, study
                    )
            else:
                self.deduped += 1  # lost the first-ack race to a speculative clone
                span.set(deduped=True)
        broker.ack(msg.msg_id)
        return work_seconds

    def _record_provenance(
        self, ledger, key, accession, source_etag, request, result, msg, study
    ) -> None:
        """One delivery + one provenance record per journal-accepted
        completion: the lineage chain ``lake key → source etag → ruleset
        fingerprint → detector sha → kernel path → trace id`` that makes a
        delivered instance reconstructible from the ledger alone."""
        from repro_torch.lake.fingerprint import request_salt, study_key

        digest = self.pipeline.ruleset_fingerprint().digest
        policy = self.pipeline.scrub.policy
        skey = (
            study_key(accession, source_etag, digest, request_salt(request))
            if source_etag is not None else ""
        )
        with ledger.batch():  # the pair group-commits on one fsync
            ledger.append(
                DELIVERY,
                key=key,
                accession=accession,
                etag=source_etag,
                temp="cold",
                worker=self.worker_id,
            )
            ledger.append(
                PROVENANCE,
                key=key,
                project=request.research_study,
                accession=accession,
                lake_key=skey,
                etag=source_etag,
                ruleset=digest,
                detector_sha=getattr(policy, "fingerprint_identity", "") if policy else "",
                kernel_path="batched" if self.pipeline.executor is not None else "serial",
                batched=getattr(self, "_batched_delta", 0),
                trace_id=trace_id_for(msg.key, msg.deliveries),
                temp="cold",
                instances=len(study.datasets),
                nbytes=study.nbytes(),
            )

    def _record_study(self, accession: str, etag, request, result) -> None:
        """Write the study-level completion record to the result lake so the
        cohort planner can serve this accession warm next time. When this
        completion supersedes a previous source version, the stale study
        record (old etag's key) is evicted — pre-mutation output must never
        be materializable again."""
        lake = self.pipeline.lake
        if lake is None or etag is None:
            return
        # lazy import: repro_torch.lake pulls core.pipeline back in (see lake/__init__)
        from repro_torch.lake.fingerprint import request_salt, study_key
        from repro_torch.lake.records import encode_study_record

        digest = self.pipeline.ruleset_fingerprint().digest
        salt = request_salt(request)
        prev_etag = self.journal.etag_for(f"{request.research_study}/{accession}")
        if prev_etag is not None and prev_etag != etag:
            old_key = study_key(accession, prev_etag, digest, salt)
            if lake.contains(old_key):
                lake.delete(old_key)
                self.evicted_stale += 1
        if not result.instance_keys:
            return
        if not all(lake.contains(k) for k in result.instance_keys):
            # some instance record never landed (oversize reject) or was
            # already evicted: a study record pointing at missing blobs would
            # only feed the planner's demote/recompute churn
            return
        skey = study_key(accession, etag, digest, salt)
        lake.put(skey, encode_study_record(result.instance_keys))


@dataclass
class PoolReport:
    processed: int
    deduped: int
    crashes: int
    redeliveries: int
    speculative: int
    wall_seconds: float
    bytes_in: int
    cost_usd: float
    scale_events: int
    unknown_devices: int = 0
    detector_runs: int = 0
    fenced: int = 0          # stale-byte fences (source mutated mid-compute)
    zombie_aborts: int = 0   # lease-expired heartbeats aborted without ack
    evicted_stale: int = 0   # superseded study records evicted from the lake


class PoolCounters(StatsShim):
    """Pool-level counters as real metrics (``repro_pool_*``)."""

    _SUBSYSTEM = "pool"
    _FIELDS = ("crashes", "speculative")


class WorkerPool:
    """Autoscaled drain loop with straggler re-dispatch."""

    def __init__(
        self,
        broker: Broker,
        autoscaler: Autoscaler,
        make_worker: Callable[[str], DeidWorker],
        injector: Optional[FailureInjector] = None,
        straggler_age: float = 300.0,
        tick_seconds: float = 5.0,
        max_ticks: int = 100_000,
        registry=None,
    ) -> None:
        self.broker = broker
        self.autoscaler = autoscaler
        self.make_worker = make_worker
        self.injector = injector
        self.straggler_age = straggler_age
        self.tick_seconds = tick_seconds
        self.max_ticks = max_ticks
        self.workers: List[DeidWorker] = []
        self._all_workers: List[DeidWorker] = []  # retains counters across scale-down
        self.counters = PoolCounters(registry)

    # `pool.crashes` / `pool.speculative` keep their attribute surface on
    # top of the metrics shim (tests and the fleet report read them)
    @property
    def crashes(self) -> int:
        return self.counters.crashes

    @crashes.setter
    def crashes(self, v: int) -> None:
        self.counters.crashes = v

    @property
    def speculative(self) -> int:
        return self.counters.speculative

    @speculative.setter
    def speculative(self, v: int) -> None:
        self.counters.speculative = v

    def _resize(self, n: int) -> None:
        while len(self.workers) < n:
            w = self.make_worker(f"w{len(self._all_workers)}")
            self.workers.append(w)
            self._all_workers.append(w)
        # scale-down deletes from the tail (paper: instances deleted when idle)
        del self.workers[n:]

    def step(self) -> float:
        """One scheduling round at the *current* sim time: autoscale, offer
        each live worker at most one message, then run straggler mitigation.

        Returns the busy-time (simulated seconds) of the slowest worker this
        round, 0.0 when every worker idled. The clock is NOT advanced — the
        caller owns time, which is what lets the fleet simulator interleave
        arrivals, chaos events, and pool rounds at exact sim-times.
        :meth:`drain` is the self-clocking wrapper.
        """
        n = self.autoscaler.tick()
        self._resize(max(n, 1) if not self.broker.empty() else n)

        busy = 0.0
        for worker in list(self.workers):
            msgs = self.broker.pull(worker.worker_id, max_messages=1)
            if not msgs:
                continue
            try:
                busy = max(busy, worker.process(self.broker, msgs[0], self.injector))
            except WorkerCrash:
                self.crashes += 1
                # no ack: the lease expires and the broker redelivers

        # straggler mitigation: clone stale leases back onto the queue
        stats = self.broker.stats()
        if stats.available == 0 and stats.leased > 0:
            for stale in self.broker.stale_leases(self.straggler_age):
                if self.broker.speculative_redeliver(stale.msg_id) is not None:
                    self.speculative += 1
        return busy

    def finish(self) -> None:
        """Final accounting tick + pool deletion (paper: instances deleted
        once the queue is empty). Step-driven callers invoke this once the
        broker is drained; :meth:`drain` does it automatically."""
        self.autoscaler.tick()
        self._resize(self.autoscaler.current)

    def report(self, t0: float = 0.0, bytes_in: int = 0) -> PoolReport:
        """Aggregate counters into a :class:`PoolReport` (step-driven callers
        pass the drain-start time and initial backlog they observed)."""
        return PoolReport(
            processed=sum(w.processed for w in self._all_workers),
            deduped=sum(w.deduped for w in self._all_workers),
            crashes=self.crashes,
            redeliveries=self.broker.total_redelivered,
            speculative=self.speculative,
            wall_seconds=self.broker.clock.now() - t0,
            bytes_in=bytes_in,
            cost_usd=self.autoscaler.cost_usd(),
            scale_events=len(self.autoscaler.events),
            unknown_devices=sum(w.unknown_devices for w in self._all_workers),
            detector_runs=sum(w.detector_runs for w in self._all_workers),
            fenced=sum(w.fenced for w in self._all_workers),
            zombie_aborts=sum(w.zombie_aborts for w in self._all_workers),
            evicted_stale=sum(w.evicted_stale for w in self._all_workers),
        )

    def drain(self) -> PoolReport:
        clock = self.broker.clock
        t0 = clock.now()
        bytes_in = self.broker.stats().backlog_bytes
        ticks = 0
        while not self.broker.empty() and ticks < self.max_ticks:
            ticks += 1
            busy = self.step()
            clock.advance(max(busy, self.tick_seconds))
        self.finish()
        return self.report(t0, bytes_in)
