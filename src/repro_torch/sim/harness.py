"""FleetSim: a deterministic discrete-event simulator over the REAL stack.

Drives ``DeidService -> Broker -> WorkerPool -> Autoscaler -> ResultLake ->
StudyStore`` — no mocks anywhere — under a traffic model and a chaos
schedule, interleaving cohort arrivals, pool scheduling rounds, and fault
injections at exact sim-times on the shared :class:`SimClock`.

Determinism contract: everything a run does is a pure function of
(:class:`FleetConfig`, traffic schedule, chaos schedule). Two runs with the
same seed produce byte-identical event logs (``report.log_digest``) and
metrics — the conformance suite enforces this, and it is what makes a chaos
failure from CI replayable on a laptop from one integer.

Event kinds in the log: ``ingest``, ``cohort``, ``query``, ``tick``,
``chaos``, ``chaos_restore``, ``cohort_done``, ``drain_done``, ``slo_alert``
(when the SLO engine is on), and — when the change feed is enabled —
``feed_commit``, ``feed_poll``, ``feed_restore``, ``feed_drained``.

The fleet's device work (the executors' kernels and the catalog's bitmap
kernel) runs on ``device`` (default ``cuda:0``; pass ``device="cpu"`` for the
plain PyTorch versions). The device is an argument of :class:`FleetSim`,
not a field of :class:`FleetConfig`, so one set of config fields describes
the same fleet in every implementation; a run and the same run on another
device give the same log, trace and audit digests and metrics.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.audit.ledger import NULL_LEDGER, AuditLedger
from repro_torch.audit.records import POLICY_EDIT
from repro_torch.catalog import CohortSelection, StudyCatalog
from repro_torch.catalog.columns import rows_from_study
from repro_torch.core.pipeline import DeidPipeline
from repro_torch.detect import DetectorPolicy
from repro_torch.core.pseudonym import TrustMode
from repro_torch.core import scripts as default_scripts
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dicom.generator import StudyGenerator, SyntheticStudy
from repro_torch.ingest.checkpoint import Checkpoint
from repro_torch.ingest.feed import PacsFeed, seeded_mutations
from repro_torch.ingest.pooler import ChangePooler, IngestApplier, PoolerCrash
from repro_torch.lake.store import ResultLake
from repro_torch.obs.health import HealthController
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.profile import CriticalPathProfiler
from repro_torch.obs.slo import SloEngine, SloSpec, default_burn_rules
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.queueing.autoscaler import Autoscaler, AutoscalerConfig
from repro_torch.queueing.broker import Broker
from repro_torch.queueing.journal import Journal
from repro_torch.queueing.server import DeidService
from repro_torch.queueing.worker import DeidWorker, FailureInjector, WorkerPool
from repro_torch.sim.chaos import ChaosSchedule
from repro_torch.sim.events import EventLog, EventQueue
from repro_torch.sim.invariants import DEFAULT_CHECKERS, Violation
from repro_torch.sim.traffic import CohortArrival, QueryArrival
from repro_torch.storage.object_store import StudyStore
from repro_torch.utils.timing import SimClock


@dataclass
class FleetConfig:
    seed: int = 0
    n_studies: int = 8
    images_per_study: int = 3
    modality: Optional[str] = "CT"   # None = draw the paper's modality mix
    delivery_window: float = 1800.0      # per-cohort SLA (seconds)
    # modeled de-id compute rate, applied to BOTH the workers and the
    # autoscaler's sizing estimate (a fleet whose planner disagrees with its
    # workers about throughput is a different experiment)
    worker_throughput: float = 160e6
    max_instances: int = 16
    visibility_timeout: float = 60.0
    max_deliveries: int = 5
    tick_seconds: float = 5.0
    straggler_age: float = 120.0
    lake_bytes: int = 1 << 30
    recompress: bool = False             # cheap pixels by default; sim is about the fleet
    max_events: int = 100_000
    # burned-in pixel-PHI detector (DESIGN.md §9): fraction of ingests drawn
    # from novel (manufacturer, model) variants outside the registry, and the
    # DetectorPolicy mode the fleet's pipelines run under ("off" is the
    # registry-only negative control the PHI invariant is tested against)
    unknown_device_rate: float = 0.0
    detector_mode: str = "registry_first"
    # continuous change-feed ingest (DESIGN.md §10): number of PACS mutations
    # committed during the run (0 = feed disabled, legacy batch-loaded lake),
    # the pooler's poll cadence, and its fault-handling knobs
    feed_mutations: int = 0
    feed_poll_interval: float = 25.0
    feed_create_fraction: float = 0.25
    feed_delete_fraction: float = 0.15
    pooler_batch: int = 16
    pooler_base_backoff: float = 5.0
    pooler_breaker_threshold: int = 3
    pooler_breaker_cooldown: float = 60.0
    # stale-byte fencing in the workers (False = the freshness invariant's
    # negative control: pre-mutation bytes may be delivered)
    fence_stale_reads: bool = True
    # observability plane (DESIGN.md §11): deterministic tracing on the sim
    # clock plus the telemetry negative-control knobs. ``trace=False`` swaps
    # in the NULL_TRACER (zero clock reads, zero behavior change);
    # ``telemetry_redact=False`` + ``plant_telemetry_phi=True`` is the
    # TelemetryPhiBoundary checker's negative control
    trace: bool = True
    telemetry_redact: bool = True
    plant_telemetry_phi: bool = False
    # streaming SLO engine + burn-rate alerting (DESIGN.md §13). ``slo=False``
    # removes the engine entirely (zero behavior change: same log minus
    # ``slo_alert`` records, same metrics). ``slo_autoscale`` opts the
    # autoscaler into the burn-rate pressure signal — the one SLO feature
    # that deliberately DOES change fleet behavior, so it defaults off.
    # Burn windows are the production 5m/1h + 6h/3d pairs scaled by
    # ``slo_window_scale`` to fit a ~600 s sim horizon.
    slo: bool = True
    slo_autoscale: bool = False
    slo_window_scale: float = 1.0 / 60.0
    slo_cold_threshold: float = 60.0     # cold-serve latency objective (s)
    slo_freshness_lag: float = 32.0      # ingest lag objective (feed events)
    # tamper-evident audit ledger (DESIGN.md §14). ``audit=False`` swaps in
    # NULL_LEDGER (provably zero behavior change: same event-log digest,
    # metrics, and trace digest). ``audit_drop_provenance=True`` is the
    # AuditCompleteness checker's negative control: completions stop emitting
    # their delivery/provenance records, so the ledger↔journal cross-check
    # must fire.
    audit: bool = True
    audit_drop_provenance: bool = False


@dataclass
class FleetReport:
    seed: int
    log_digest: str
    metrics: Dict[str, float]
    violations: List[Violation]
    # digest over the finished-span stream (repro_torch.obs.Tracer.digest): the
    # trace-layer half of the replayability contract. Kept out of ``metrics``
    # so metric-equality assertions stay about fleet behavior.
    trace_digest: str = ""
    # SLO plane summary (states, alert counts, budgets, alert/profile
    # digests) — also kept out of ``metrics``: turning the SLO engine on
    # must not move any metric-equality assertion.
    slo: Dict[str, object] = field(default_factory=dict)
    # audit-ledger summary (chain digest, record counts by kind) — same
    # isolation rule: the ledger must not move metrics or either digest.
    audit: Dict[str, object] = field(default_factory=dict)

    def ok(self) -> bool:
        return not self.violations


class FleetSim:
    def __init__(
        self,
        config: FleetConfig,
        traffic: Sequence[CohortArrival],
        journal_path,
        chaos: Optional[ChaosSchedule] = None,
        *,
        device: DeviceLike = None,
    ) -> None:
        self.config = config
        self.device = resolve_device(device)
        self.traffic = sorted(traffic, key=lambda a: (a.t, a.study_id))
        self.chaos = chaos or ChaosSchedule.quiet()
        self.clock = SimClock()
        self.log = EventLog()
        # --- observability plane: one tracer (sim clock) + one metrics
        # registry shared by every component, parallel to the event log —
        # spans never feed the log, so enabling tracing cannot move the
        # log digest
        self.registry = MetricsRegistry()
        self.tracer = Tracer(self.clock) if config.trace else NULL_TRACER
        # --- audit plane (DESIGN.md §14): one hash-chained ledger shared by
        # every PHI-touching component. Parallel to the event log like the
        # tracer: appends never feed the log or metrics, so enabling the
        # ledger cannot move either digest.
        self.ledger = (
            AuditLedger(f"{journal_path}.audit", clock=self.clock)
            if config.audit else NULL_LEDGER
        )
        # --- SLO plane (DESIGN.md §13): engine + critical-path profiler +
        # health controller. Observations are fed from the same hooks that
        # write the event log, so the alert stream is a pure function of the
        # run; evaluation happens on pool ticks and once at drain.
        self.slo_engine: Optional[SloEngine] = None
        self.profiler: Optional[CriticalPathProfiler] = None
        self.health: Optional[HealthController] = None
        self._slo_cold_spec: Optional[SloSpec] = None
        self._slo_last_dlq = 0
        self._slo_last_ack = 0
        if config.slo:
            s = config.slo_window_scale
            rules = default_burn_rules(s)
            budget_window = 86400.0 * s
            self._slo_cold_spec = SloSpec(
                "cold_serve", objective=0.9, threshold=config.slo_cold_threshold,
                kind="latency", rules=rules, budget_window=budget_window,
            )
            specs = [
                SloSpec("warm_hit", objective=0.99, threshold=1.0,
                        kind="latency", rules=rules, budget_window=budget_window),
                SloSpec("cohort_e2e", objective=0.9,
                        threshold=config.delivery_window, kind="latency",
                        rules=rules, budget_window=budget_window),
                SloSpec("dlq_rate", objective=0.95, kind="rate",
                        rules=rules, budget_window=budget_window),
            ]
            if config.feed_mutations > 0:
                specs.append(SloSpec(
                    "ingest_freshness", objective=0.9,
                    threshold=config.slo_freshness_lag, unit="events",
                    kind="freshness", rules=rules, budget_window=budget_window,
                ))
            self.slo_engine = SloEngine(specs, registry=self.registry)
            self.profiler = CriticalPathProfiler()
            self.health = HealthController(self.slo_engine, self.profiler)

        # --- corpus: the identified data lake, with PHI ground truth retained
        self.gen = StudyGenerator(config.seed)
        self.source = StudyStore("lake", key=b"sim-at-rest-key")
        # metadata catalog indexes every ingest (incl. chaos re-ingests)
        self.catalog = StudyCatalog(tracer=self.tracer, device=self.device)
        self.source.attach_catalog(self.catalog)
        self.mrns: Dict[str, str] = {}
        self._versions: List[SyntheticStudy] = []  # every ingest, incl. re-ingests
        self._etag_study: Dict[str, SyntheticStudy] = {}  # source etag -> version
        self._hit_etag: Dict[Tuple[int, str], str] = {}   # (cohort, acc) at serve time
        self._reingests = 0
        # freshness ledger: one global order over source mutations and
        # researcher-visible deliveries (same-sim-time events keep a definite
        # order), plus the per-mutation row budget the no-full-reingest
        # invariant counter-asserts against the catalog's own counters
        self._order_seq = 0
        self.mutation_log: List[Dict] = []
        self.delivery_log: List[Dict] = []
        self._acc_rows: Dict[str, int] = {}
        self._expected_catalog_rows = 0
        self._expected_tombstones = 0
        # --- change-feed ingest plane (feed_mutations > 0)
        self.feed: Optional[PacsFeed] = None
        self.pooler: Optional[ChangePooler] = None
        self.applier: Optional[IngestApplier] = None
        self._ckpt_path = f"{journal_path}.ckpt"
        self._pooler_crash_after: Optional[int] = None
        self._pooler_crashes = 0
        self._pooler_crashed_at: Optional[float] = None
        self._recovery_times: List[float] = []
        self._feed_totals: Dict[str, int] = {}
        if config.feed_mutations > 0:
            self.feed = PacsFeed(
                config.seed + 500_000, config.modality, config.images_per_study
            )
        for i in range(config.n_studies):
            acc = f"SIM{i:04d}"
            self._ingest(self.gen, acc)
        if config.plant_telemetry_phi and self._versions:
            # TelemetryPhiBoundary negative control: a debug span carrying
            # real PHI under a NON-allowlisted key. With redaction on, the
            # exporter drops it; with redaction off, the checker must catch it
            planted = self._versions[0]
            self.tracer.event(
                "debug.dump",
                note=f"patient={planted.patient_name} mrn={planted.mrn}",
                accession=planted.accession,
            )

        # --- the real control/data plane, wired exactly like production
        self.broker = Broker(
            self.clock,
            visibility_timeout=config.visibility_timeout,
            max_deliveries=config.max_deliveries,
            tracer=self.tracer,
            registry=self.registry,
            ledger=self.ledger,
        )
        self.journal = Journal(journal_path)
        # the ingest plane gets its own queue: feed events and de-id work are
        # separate streams in production (different consumers, different SLAs)
        self.ingest_broker: Optional[Broker] = None
        if self.feed is not None:
            self.ingest_broker = Broker(
                self.clock, visibility_timeout=config.visibility_timeout,
                tracer=self.tracer, registry=self.registry,
            )
            self._build_ingest_process()
        self.lake = ResultLake(
            max_bytes=config.lake_bytes, registry=self.registry, ledger=self.ledger
        )
        self.policy = DetectorPolicy(mode=config.detector_mode)
        self.pipeline = DeidPipeline(
            recompress=config.recompress, lake=self.lake,
            detector_policy=self.policy,
            tracer=self.tracer, registry=self.registry, ledger=self.ledger,
            device=self.device,
        )
        # genesis policy record: the ruleset/detector identity this fleet
        # deployed with — every later edit chains after it
        self.ledger.append(
            POLICY_EDIT,
            action="deploy",
            ruleset=self.pipeline.ruleset_fingerprint().digest,
            detector_sha=self.policy.fingerprint_identity,
        )
        self.dest = StudyStore("researcher")
        self.service = DeidService(
            self.broker, self.source, self.journal,
            result_lake=self.lake, pipeline=self.pipeline,
            catalog=self.catalog,
            tracer=self.tracer, registry=self.registry, ledger=self.ledger,
        )
        for arr in self.traffic:
            if arr.study_id not in self.service._studies:
                self.service.register_study(arr.study_id, TrustMode.POST_IRB)
        self.injector = FailureInjector()
        self.pool = WorkerPool(
            self.broker,
            Autoscaler(
                self.broker,
                AutoscalerConfig(
                    delivery_window=config.delivery_window,
                    per_instance_throughput=config.worker_throughput,
                    max_instances=config.max_instances,
                ),
                self.clock,
            ),
            # factory object (not a closure over self.pipeline): workers spawned
            # after a ruleset_edit chaos event get the edited pipeline
            DeidWorkerProxyFactory(self),
            self.injector,
            straggler_age=config.straggler_age,
            tick_seconds=config.tick_seconds,
            registry=self.registry,
        )
        if self.health is not None:
            self.service.attach_health(self.health)
            if config.slo_autoscale:
                # closed loop: burning latency SLOs boost the scale-up target
                self.pool.autoscaler.pressure_fn = self.health.pressure

        self.tickets: List[Tuple[object, object]] = []  # (arrival, ticket)
        # (arrival, serve-time selection, serve-time accession->etag map) per
        # query — what the QueryConsistency checker replays brute-force
        self.query_log: List[Tuple[QueryArrival, CohortSelection, Dict[str, str]]] = []
        self._submitted: Set[str] = set()
        self._cohort_arrival_t: Dict[int, float] = {}
        self._cohort_done_t: Dict[int, float] = {}
        self._tick_scheduled = False
        self._ruleset_edits = 0
        self._storm_depth = 0  # nested/overlapping lease storms (see _on_chaos)
        # ruleset digest -> the pipeline that minted it, so the warm-replay
        # checker can rebuild the exact cold oracle a hit was served under
        self._pipelines: Dict[str, DeidPipeline] = {
            self.pipeline.ruleset_fingerprint().digest: self.pipeline
        }
        self._ticket_digest: Dict[int, str] = {}

    # ------------------------------------------------------------- corpus ops
    def _ingest(self, gen: StudyGenerator, accession: str) -> None:
        device = None
        if self.config.unknown_device_rate > 0.0:
            # deterministic per (generator seed, accession): re-ingests under
            # a chaos generator may re-roll, which is realistic (device swap)
            u = gen._rng("unknown-device?", accession).random()
            if u < self.config.unknown_device_rate:
                device = gen.unknown_device(accession, self.config.modality)
        study = gen.gen_study(
            accession, modality=self.config.modality,
            n_images=self.config.images_per_study,
            device=device,
        )
        self.source.put_study(accession, study)
        self.mrns[accession] = study.mrn
        self._versions.append(study)
        self._etag_study[self.source.study_etag(accession)] = study
        self._account_rows(accession, len(rows_from_study(study)))
        self._log_mutation(accession, self.source.study_etag(accession))
        if self.feed is not None:
            # initial corpus predates the feed: version 0, no change event
            self.feed.adopt(accession, study)

    # ------------------------------------------------- freshness + row budget
    def _log_mutation(self, accession: str, etag: Optional[str]) -> None:
        """Source-visible mutation (put or delete) in the global order the
        Freshness checker compares deliveries against."""
        self._order_seq += 1
        self.mutation_log.append(
            {
                "seq": self._order_seq,
                "t": self.clock.now(),
                "accession": accession,
                "etag": etag,
            }
        )

    def _log_delivery(self, key: str, accession: str, etag: Optional[str]) -> None:
        """Researcher-visible delivery, tagged with the source etag the bytes
        were de-identified from (warm hits: the etag pinned at admission)."""
        self._order_seq += 1
        self.delivery_log.append(
            {
                "seq": self._order_seq,
                "t": self.clock.now(),
                "key": key,
                "accession": accession,
                "etag": etag,
            }
        )

    # ------------------------------------------------------------- SLO plane
    def _slo_observe(self, name: str, value: float) -> None:
        if self.slo_engine is not None:
            self.slo_engine.observe(name, t=self.clock.now(), value=value)

    def _slo_delivery(self, msg) -> None:
        """Cold-serve latency observation for one processed delivery:
        now − first publish time (``Message.publish_time`` survives
        redelivery and speculative cloning), bucketed per modality. This is
        the same quantity ``derive_serve_observations`` reconstructs from
        the span stream — SloConformance asserts the two streams are equal."""
        if self.slo_engine is None:
            return
        study = self._etag_study.get(self.journal.etag_for(msg.key))
        modality = getattr(study, "modality", None) or "NA"
        spec = self.slo_engine.ensure(
            replace(self._slo_cold_spec, name=f"cold_serve_{modality}")
        )
        self.slo_engine.observe(
            spec.name, t=self.clock.now(),
            value=self.clock.now() - msg.publish_time,
        )

    def _slo_evaluate(self) -> None:
        """Feed the per-tick DLQ/ack deltas, run the burn-rate state machine,
        and append any fire/resolve transitions to the event log."""
        if self.slo_engine is None:
            return
        now = self.clock.now()
        dlq = len(self.broker.dead_letter)
        acked = self.broker.total_acked
        d_bad, d_good = dlq - self._slo_last_dlq, acked - self._slo_last_ack
        self._slo_last_dlq, self._slo_last_ack = dlq, acked
        if d_bad or d_good:
            self.slo_engine.observe_counts("dlq_rate", t=now, good=d_good, bad=d_bad)
        for ev in self.slo_engine.evaluate(now):
            self.log.append(
                now, "slo_alert",
                slo=ev.slo, rule=ev.rule, action=ev.action,
                severity=ev.severity,
                burn_long=ev.burn_long, burn_short=ev.burn_short,
            )

    def _account_rows(self, accession: str, rows: int) -> None:
        """Maintain the exact catalog row budget this mutation is allowed to
        cost: a re-put tombstones the accession's prior live rows and appends
        ``rows`` new ones. NoFullReingest counter-asserts these totals against
        the catalog's own counters — any hidden rebuild breaks the equality."""
        self._expected_tombstones += self._acc_rows.get(accession, 0)
        self._expected_catalog_rows += rows
        self._acc_rows[accession] = rows

    # ------------------------------------------------------ change-feed plane
    def _build_ingest_process(self) -> None:
        cfg = self.config
        ckpt = Checkpoint(self._ckpt_path)
        self.pooler = ChangePooler(
            self.feed,
            self.ingest_broker,
            ckpt,
            self.clock,
            seed=cfg.seed,
            batch=cfg.pooler_batch,
            base_backoff=cfg.pooler_base_backoff,
            breaker_threshold=cfg.pooler_breaker_threshold,
            breaker_cooldown=cfg.pooler_breaker_cooldown,
            tracer=self.tracer,
            registry=self.registry,
        )
        self.applier = IngestApplier(
            self.ingest_broker, self.feed, self.source, ckpt,
            tracer=self.tracer, registry=self.registry, ledger=self.ledger,
        )

    def _rebuild_ingest_process(self) -> None:
        """Pooler crash recovery: every in-memory cursor dies with the
        process; the replacement replays the durable checkpoint. This is the
        crash-safety claim the conformance suite exercises."""
        for name, val in (
            ("polls", self.pooler.stats.polls),
            ("handed", self.pooler.stats.handed),
            ("duplicates", self.pooler.stats.duplicates),
            ("outages", self.pooler.stats.outages),
            ("breaker_opens", self.pooler.stats.breaker_opens),
            ("applied", self.applier.stats.applied),
            ("deletes", self.applier.stats.deletes),
            ("effect_deduped", self.applier.stats.effect_deduped),
            ("stale_skipped", self.applier.stats.stale_skipped),
            ("redelivered", self.applier.stats.redelivered),
        ):
            self._feed_totals[name] = self._feed_totals.get(name, 0) + val
        self.pooler.checkpoint.close()
        self._build_ingest_process()

    def _absorb_applied(self, ops) -> None:
        """Fold applier effects into the sim's ground truth: PHI oracles see
        the new source versions, mrn routing learns feed-created studies, and
        the freshness/row-budget ledgers advance."""
        for op in ops:
            if op.op == "put":
                etag = self.source.study_etag(op.accession)
                self._versions.append(op.study)
                self._etag_study[etag] = op.study
                self.mrns[op.accession] = op.study.mrn
                self._account_rows(op.accession, op.rows)
                self._log_mutation(op.accession, etag)
            else:  # delete
                self._expected_tombstones += self._acc_rows.pop(op.accession, 0)
                self._log_mutation(op.accession, None)

    def _on_feed_poll(self, eq: Optional[EventQueue]) -> None:
        now = self.clock.now()
        try:
            status = self.pooler.poll_once(crash_after=self._pooler_crash_after)
        except PoolerCrash:
            self._pooler_crashes += 1
            self._pooler_crashed_at = now
            self._pooler_crash_after = None
            self._rebuild_ingest_process()
            status = {"crashed": True}
        else:
            # an armed crash stays armed until a non-empty batch fires it
            if self._pooler_crashed_at is not None and "handed" in status:
                self._recovery_times.append(now - self._pooler_crashed_at)
                self._pooler_crashed_at = None
        applied = self.applier.drain()
        self._absorb_applied(applied)
        self.log.append(now, "feed_poll", applied=len(applied), **status)
        # ingest freshness = how far the durable checkpoint trails the PACS
        # head, in feed events, sampled at every poll
        self._slo_observe(
            "ingest_freshness",
            float(self.feed.last_seq - self.pooler.checkpoint.floor()),
        )
        if eq is not None and not self.broker.empty():
            self._schedule_tick(eq, now)

    def _drain_feed(self) -> None:
        """End-of-run catch-up: clear any standing outage, then poll/apply —
        jumping the clock over backoff/breaker windows — until the checkpoint
        floor reaches the feed head and the ingest queue is empty. The lake
        must not finish the run behind the PACS."""
        self.feed.outage = False
        for _ in range(1000):
            if not self.pooler.behind() and self.ingest_broker.empty():
                break
            wake = max(
                self.pooler.next_poll_at, self.pooler.breaker_open_until or 0.0
            )
            if wake > self.clock.now():
                self.clock.advance(wake - self.clock.now())
            self._on_feed_poll(None)
        self.log.append(
            self.clock.now(), "feed_drained",
            floor=self.pooler.checkpoint.floor(), head=self.feed.last_seq,
        )

    def study_versions(self) -> List[SyntheticStudy]:
        """Every source version ever ingested (re-ingests included) — the PHI
        checker scans outputs against ALL of them."""
        return list(self._versions)

    def submitted_keys(self) -> set:
        """Every study-scoped key admitted so far. Accession-list arrivals
        contribute their full lists at admission; query arrivals contribute
        whatever the catalog resolved at serve time (tracked live — the
        traffic schedule alone cannot know a query's cohort)."""
        return set(self._submitted)

    def cold_pipeline_for(self, ticket) -> DeidPipeline:
        """Lake-less clone of the pipeline whose ruleset served ``ticket``'s
        warm hits — the oracle the warm-replay checker compares against.
        (After a ruleset edit, earlier hits replay under the old scripts.)"""
        src = self._pipelines[self._ticket_digest[ticket.cohort_id]]
        return DeidPipeline(
            filter_script=src.filter.script_text,
            anonymizer_script=src.anonymizer.script_text,
            scrub_script=src.scrub.script_text,
            recompress=src.scrub.recompress,
            detector_policy=src.scrub.policy,
            device=self.device,
        )

    # --------------------------------------------------------------- main loop
    def run(self, checkers=DEFAULT_CHECKERS) -> FleetReport:
        eq = EventQueue()
        horizon = 600.0
        for arr in self.traffic:
            kind = "query" if isinstance(arr, QueryArrival) else "cohort"
            eq.push(arr.t, kind, arrival=arr)
            horizon = max(horizon, arr.t)
        for ce in self.chaos.sorted():
            eq.push(ce.t, "chaos", event=ce)
            horizon = max(horizon, ce.t)
        self._horizon = horizon
        if self.feed is not None:
            cfg = self.config
            for mut in seeded_mutations(
                cfg.seed,
                horizon,
                [f"SIM{i:04d}" for i in range(cfg.n_studies)],
                cfg.feed_mutations,
                create_fraction=cfg.feed_create_fraction,
                delete_fraction=cfg.feed_delete_fraction,
            ):
                eq.push(mut.t, "feed_commit", mutation=mut)
            # poll cadence outlives the last scheduled event so the tail of
            # the change sequence is picked up inside the loop when possible
            t = cfg.feed_poll_interval
            while t <= horizon + 4.0 * cfg.feed_poll_interval:
                eq.push(t, "feed_poll")
                t += cfg.feed_poll_interval

        n_events = 0
        while eq:
            n_events += 1
            if n_events > self.config.max_events:
                self.log.append(self.clock.now(), "aborted", reason="max_events")
                break
            ev = eq.pop()
            if ev.t > self.clock.now():
                self.clock.advance(ev.t - self.clock.now())
            if ev.kind == "cohort":
                self._on_cohort(eq, ev.payload["arrival"])
            elif ev.kind == "query":
                self._on_query(eq, ev.payload["arrival"])
            elif ev.kind == "tick":
                self._on_tick(eq)
            elif ev.kind == "chaos":
                self._on_chaos(eq, ev.payload["event"])
            elif ev.kind == "feed_commit":
                mut = ev.payload["mutation"]
                event = self.feed.commit(mut.op, mut.accession)
                self.log.append(
                    self.clock.now(), "feed_commit",
                    op=mut.op, accession=mut.accession,
                    seq=event.seq if event is not None else -1,
                )
            elif ev.kind == "feed_poll":
                self._on_feed_poll(eq)
            elif ev.kind == "feed_restore":
                self.feed.outage = False
                self.log.append(self.clock.now(), "feed_restore")
            elif ev.kind == "chaos_restore":
                # storms may overlap: only the last restore standing brings the
                # baseline timeout back (a restore must never resurrect another
                # storm's shrunken value)
                self._storm_depth -= 1
                if self._storm_depth == 0:
                    self.broker.visibility_timeout = self.config.visibility_timeout
                self.log.append(
                    self.clock.now(), "chaos_restore",
                    visibility_timeout=self.broker.visibility_timeout,
                    storm_depth=self._storm_depth,
                )

        if self.feed is not None:
            self._drain_feed()
        self.pool.finish()
        self._resolve_and_log_done()
        self._slo_evaluate()  # final burn evaluation at drain time
        self.log.append(
            self.clock.now(), "drain_done",
            processed=sum(w.processed for w in self.pool._all_workers),
            outstanding=self.broker.stats().outstanding,
        )
        return self._report(checkers)

    # ---------------------------------------------------------------- handlers
    def _schedule_tick(self, eq: EventQueue, t: float) -> None:
        if not self._tick_scheduled:
            eq.push(t, "tick")
            self._tick_scheduled = True

    def _admit_ticket(self, arr, ticket) -> None:
        """Bookkeeping shared by accession-list and query admissions."""
        self.tickets.append((arr, ticket))
        self._ticket_digest[ticket.cohort_id] = self.service.planner.ruleset_digest
        for acc in ticket.hits:  # pin the source version each hit replayed
            etag = self.source.study_etag(acc)
            self._hit_etag[(ticket.cohort_id, acc)] = etag
            # a warm hit is a researcher-visible delivery at admission time
            self._log_delivery(f"{arr.study_id}/{acc}", acc, etag)
            # ... served synchronously from the lake: zero queueing latency
            self._slo_observe("warm_hit", 0.0)
        self._cohort_arrival_t[ticket.cohort_id] = self.clock.now()
        if ticket.done():
            self._cohort_done_t[ticket.cohort_id] = self.clock.now()

    def _on_cohort(self, eq: EventQueue, arr: CohortArrival) -> None:
        ticket = self.service.submit_cohort(
            arr.study_id, list(arr.accessions), self.mrns
        )
        self._submitted |= {f"{arr.study_id}/{acc}" for acc in arr.accessions}
        self._admit_ticket(arr, ticket)
        self.log.append(
            self.clock.now(), "cohort",
            cohort_id=ticket.cohort_id, study_id=arr.study_id,
            n=len(arr.accessions), hits=len(ticket.hits),
            coalesced=len(ticket.coalesced), cold=len(ticket.cold),
            rejected=len(ticket.rejected),
        )
        if not self.broker.empty():
            self._schedule_tick(eq, self.clock.now())

    def _on_query(self, eq: EventQueue, arr: QueryArrival) -> None:
        selection, ticket = self.service.submit_query(
            arr.study_id, arr.query, self.mrns
        )
        # serve-time snapshot: which source version of each accession the
        # catalog had indexed when it answered — the consistency checker
        # replays the query brute-force against exactly these versions
        self.query_log.append((arr, selection, self.catalog.accession_etags()))
        self._submitted |= {
            f"{arr.study_id}/{acc}" for acc in selection.accessions
        }
        self._admit_ticket(arr, ticket)
        self.log.append(
            self.clock.now(), "query",
            cohort_id=ticket.cohort_id, study_id=arr.study_id,
            query=selection.query, selection_digest=selection.digest,
            matched=len(selection.accessions),
            instances=selection.total_instances,
            matched_bytes=selection.total_bytes,
            blocks_scanned=selection.blocks_scanned,
            blocks_pruned=selection.blocks_pruned,
            hits=len(ticket.hits), coalesced=len(ticket.coalesced),
            cold=len(ticket.cold), rejected=len(ticket.rejected),
        )
        if not self.broker.empty():
            self._schedule_tick(eq, self.clock.now())

    def _on_tick(self, eq: EventQueue) -> None:
        self._tick_scheduled = False
        busy = self.pool.step()
        self._resolve_and_log_done()
        stats = self.broker.stats()
        self.log.append(
            self.clock.now(), "tick",
            workers=len(self.pool.workers), busy=busy,
            available=stats.available, leased=stats.leased,
            dead_lettered=stats.dead_lettered,
            backlog_bytes=stats.backlog_bytes,
        )
        self._slo_evaluate()
        if not self.broker.empty():
            self._schedule_tick(
                eq, self.clock.now() + max(busy, self.config.tick_seconds)
            )

    def _on_chaos(self, eq: EventQueue, ce) -> None:
        now = self.clock.now()
        if ce.kind == "set_crash_rate":
            self.injector.crash_rate = ce.payload["rate"]
        elif ce.kind == "crash_keys":
            keys = {
                f"{sid}/{acc}"
                for sid in self.service._studies
                for acc in ce.payload["accessions"]
            }
            self.injector.crash_once_keys = frozenset(
                self.injector.crash_once_keys | keys
            )
        elif ce.kind == "set_straggler":
            self.injector.straggler_rate = ce.payload["rate"]
            self.injector.slow_factor = ce.payload.get("slow_factor", 10.0)
        elif ce.kind == "lease_storm":
            self._storm_depth += 1
            eq.push(now + ce.payload["duration"], "chaos_restore")
            self.broker.visibility_timeout = ce.payload["visibility_timeout"]
        elif ce.kind == "reingest":
            self._reingests += 1
            # re-acquisition: same accession, different bytes -> new etag; the
            # planner's etag-keyed study records go stale, never stale-served
            if self.feed is not None:
                # single-writer rule: once the ingest plane is live the feed
                # owns source mutations — route the re-acquisition through it
                self.feed.commit("update", ce.payload["accession"])
            else:
                self._ingest(
                    StudyGenerator(self.config.seed + 1000 + self._reingests),
                    ce.payload["accession"],
                )
        elif ce.kind == "pooler_crash":
            if self.feed is not None:
                self._pooler_crash_after = ce.payload["after"]
        elif ce.kind == "feed_outage":
            if self.feed is not None:
                self.feed.outage = True
                eq.push(now + ce.payload["duration"], "feed_restore")
        elif ce.kind == "feed_faults":
            if self.feed is not None:
                self.feed.dup_rate = ce.payload["dup_rate"]
                self.feed.shuffle = bool(ce.payload.get("shuffle", True))
        elif ce.kind == "ruleset_edit":
            self._ruleset_edits += 1
            edited = (
                default_scripts.DEFAULT_ANONYMIZER_SCRIPT
                + f"\n# chaos ruleset edit {self._ruleset_edits}\nempty PatientAge\n"
            )
            self.pipeline = DeidPipeline(
                anonymizer_script=edited,
                recompress=self.config.recompress,
                lake=self.lake,
                detector_policy=self.policy,
                tracer=self.tracer,
                registry=self.registry,
                ledger=self.ledger,
                device=self.device,
            )
            # planner admissions and new workers move to the edited ruleset
            # atomically; in-flight workers finish under the old one (their
            # lake keys embed the old digest, so results never cross over)
            digest = self.pipeline.ruleset_fingerprint().digest
            self._pipelines[digest] = self.pipeline
            self.service.planner.ruleset_digest = digest
            self.ledger.append(
                POLICY_EDIT, action="edit", ruleset=digest,
                detector_sha=self.policy.fingerprint_identity,
            )
        self.log.append(now, "chaos", chaos_kind=ce.kind, **ce.payload)
        if not self.broker.empty():
            self._schedule_tick(eq, now)

    def _resolve_and_log_done(self) -> None:
        self.service.planner.resolve()
        for _, ticket in self.tickets:
            if ticket.done() and ticket.cohort_id not in self._cohort_done_t:
                self._cohort_done_t[ticket.cohort_id] = self.clock.now()
                latency = self.clock.now() - self._cohort_arrival_t[ticket.cohort_id]
                self.log.append(
                    self.clock.now(), "cohort_done",
                    cohort_id=ticket.cohort_id,
                    latency=latency,
                    failed=len(ticket.failed),
                )
                self._slo_observe("cohort_e2e", latency)

    # ----------------------------------------------------------------- report
    def _report(self, checkers) -> FleetReport:
        cfg = self.config
        latencies = {
            cid: self._cohort_done_t[cid] - self._cohort_arrival_t[cid]
            for cid in self._cohort_done_t
        }
        n_cohorts = len(self.tickets)
        within = sum(1 for v in latencies.values() if v <= cfg.delivery_window)
        a = self.pool.autoscaler
        metrics = {
            "cohorts": n_cohorts,
            "cohorts_done": len(latencies),
            "sla_attainment": within / n_cohorts if n_cohorts else 1.0,
            "processed": sum(w.processed for w in self.pool._all_workers),
            "deduped": sum(w.deduped for w in self.pool._all_workers),
            "crashes": self.pool.crashes,
            "redeliveries": self.broker.total_redelivered,
            "speculative": self.pool.speculative,
            "dead_lettered": len(self.broker.dead_letter),
            "published": self.broker.total_published,
            "lake_hit_rate": round(self.lake.stats.hit_rate(), 6),
            "planner_lake_hits": self.service.planner.stats.lake_hits,
            "planner_coalesced": self.service.planner.stats.coalesced,
            "instance_seconds": round(a.instance_seconds, 6),
            "cost_usd": round(a.cost_usd(), 6),
            "sim_minutes": round(self.clock.now() / 60.0, 6),
            "max_latency_s": round(max(latencies.values()), 6) if latencies else 0.0,
            "queries": len(self.query_log),
            "query_matched_accessions": sum(
                len(sel.accessions) for _, sel, _ in self.query_log
            ),
            "catalog_rows": self.catalog.stats.rows,
            "catalog_blocks_pruned": self.catalog.stats.blocks_pruned,
            # burned-in pixel-PHI detector surface (DESIGN.md §9): unknown
            # (manufacturer, model) lookups are a first-class fleet signal
            "unknown_device_lookups": sum(
                w.unknown_devices for w in self.pool._all_workers
            ),
            "detector_runs": sum(w.detector_runs for w in self.pool._all_workers),
            "detector_detected": sum(
                p.scrub.detect_stats.detected for p in self._pipelines.values()
            ),
            # stale-byte fencing + incremental re-deid surface (DESIGN.md §10)
            "fenced": sum(w.fenced for w in self.pool._all_workers),
            "zombie_aborts": sum(w.zombie_aborts for w in self.pool._all_workers),
            "evicted_stale": sum(w.evicted_stale for w in self.pool._all_workers),
            "supersessions": self.journal.supersessions,
            "stale_refreshes": self.service.planner.stats.stale_refreshes,
            "catalog_tombstoned": self.catalog.stats.tombstoned,
            "catalog_deletes": self.catalog.stats.deletes,
        }
        if self.feed is not None:
            t = self._feed_totals
            ps, ap = self.pooler.stats, self.applier.stats
            metrics.update(
                {
                    "feed_events": self.feed.last_seq,
                    "feed_polls": t.get("polls", 0) + ps.polls,
                    "feed_handed": t.get("handed", 0) + ps.handed,
                    "feed_duplicates": t.get("duplicates", 0) + ps.duplicates,
                    "feed_outage_polls": t.get("outages", 0) + ps.outages,
                    "feed_breaker_opens": t.get("breaker_opens", 0)
                    + ps.breaker_opens,
                    "feed_applied": t.get("applied", 0) + ap.applied,
                    "feed_deletes": t.get("deletes", 0) + ap.deletes,
                    "feed_effect_deduped": t.get("effect_deduped", 0)
                    + ap.effect_deduped,
                    "feed_stale_skipped": t.get("stale_skipped", 0)
                    + ap.stale_skipped,
                    "feed_redelivered": t.get("redelivered", 0) + ap.redelivered,
                    "pooler_crashes": self._pooler_crashes,
                    "pooler_recovery_s": round(
                        sum(self._recovery_times) / len(self._recovery_times), 6
                    )
                    if self._recovery_times
                    else 0.0,
                }
            )
        slo_summary: Dict[str, object] = {}
        if self.slo_engine is not None:
            eng = self.slo_engine
            now = self.clock.now()
            # fold whatever the tracer saw (empty under trace=False — the
            # profile then reports zero traces, deterministically)
            self.profiler.fold(self.tracer.spans())
            fired = sum(1 for a in eng.alerts if a.action == "fire")
            slo_summary = {
                "alerts_fired": fired,
                "alerts_resolved": len(eng.alerts) - fired,
                "states": eng.states(),
                "budget_remaining": {
                    name: round(eng.budget_remaining(name, now), 6)
                    for name in eng.specs
                },
                "alert_digest": eng.digest(),
                "profile_digest": self.profiler.digest(),
                "traces_folded": self.profiler.traces_folded,
            }
        # snapshot the ledger BEFORE the checkers run: several checkers
        # re-materialize lake entries / replay pipelines, which appends more
        # (legitimate) records — the reported digest is the digest of the
        # *run*, identical across same-seed replays regardless of checker set
        audit_summary: Dict[str, object] = {"enabled": bool(self.ledger.enabled)}
        if self.ledger.enabled:
            self.ledger.flush()
            audit_summary.update(
                digest=self.ledger.digest(),
                records=len(self.ledger),
                head=self.ledger.head(),
                by_kind=self.ledger.kind_counts(),
            )
        violations: List[Violation] = []
        for checker in checkers:
            violations.extend(checker.check(self))
        return FleetReport(
            seed=cfg.seed,
            log_digest=self.log.digest(),
            metrics=metrics,
            violations=violations,
            trace_digest=self.tracer.digest(),
            slo=slo_summary,
            audit=audit_summary,
        )


class _LoggingWorker(DeidWorker):
    """DeidWorker that reports each researcher-visible delivery (a processed
    message, not a dedup ack) into the sim's freshness ledger, tagged with the
    source etag the journal pinned at read time."""

    def process(self, broker, msg, injector=None) -> float:
        before = self.processed
        spent = super().process(broker, msg, injector)
        if self.processed > before:
            self._sim._log_delivery(
                msg.key, msg.payload["accession"], self.journal.etag_for(msg.key)
            )
            self._sim._slo_delivery(msg)
        return spent


class DeidWorkerProxyFactory:
    """Worker factory that reads ``sim.pipeline`` at spawn time, so workers
    created after a ``ruleset_edit`` chaos event pick up the edited pipeline
    while already-running workers keep the old one (a rolling deploy)."""

    def __init__(self, sim: FleetSim) -> None:
        self.sim = sim

    def __call__(self, wid: str) -> DeidWorker:
        w = _LoggingWorker(
            wid, self.sim.pipeline, self.sim.source, self.sim.dest,
            self.sim.journal, throughput=self.sim.config.worker_throughput,
            fence_stale_reads=self.sim.config.fence_stale_reads,
            tracer=self.sim.tracer,
            ledger=self.sim.ledger,
            audit_emit_provenance=not self.sim.config.audit_drop_provenance,
        )
        w._sim = self.sim
        return w
