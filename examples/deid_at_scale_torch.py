"""End-to-end run of the PyTorch/CUDA port (the paper's kind: a batched
de-identification service).

    PYTHONPATH=src python examples/deid_at_scale_torch.py [--studies 40] [--device cpu] \
        [--journal PATH] [--trace out.jsonl] [--slo] [--audit]

Serves a Table-1-style request at simulation scale with everything turned on:
autoscaled worker pool, worker crashes + lease redelivery, stragglers +
speculative re-dispatch, a mid-drain restart resuming from the journal, and
the scrub farm over every card for the pixel stage. Ends with a
Table-1-style report. Pipelines, the catalog, the farm and the fleet
simulator run on ``--device`` (default ``cuda``: the card's kernels;
``cpu``: their plain PyTorch versions). The journals start fresh: files at
``--journal`` (default: a new temporary directory) are replaced.
"""
import argparse
import tempfile
from pathlib import Path

from repro_torch.audit import AuditLedger, DisclosureReport
from repro_torch.core import DeidPipeline, TrustMode
from repro_torch.detect import DetectorPolicy
from repro_torch.device import resolve_device
from repro_torch.dicom.generator import StudyGenerator
from repro_torch.distributed import ScrubFarm
from repro_torch.kernels.scrub.ops import make_blank_fn
from repro_torch.lake import ResultLake
from repro_torch.queueing import (
    Autoscaler,
    AutoscalerConfig,
    Broker,
    DeidWorker,
    FailureInjector,
    Journal,
    WorkerPool,
)
from repro_torch.queueing.server import DeidService, RequestState
from repro_torch.obs import NULL_TRACER, Redactor, Tracer, export_spans_jsonl, trace_id_for
from repro_torch.storage.object_store import StudyStore
from repro_torch.utils.bytesize import human_bytes
from repro_torch.utils.timing import SimClock


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--studies", type=int, default=40)
    ap.add_argument("--images-per-study", type=int, default=3)
    ap.add_argument("--journal", default=None,
                    help="journal file (replaced if present, with its .audit and "
                         ".edited siblings); default: a new temporary directory")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", metavar="OUT_JSONL", default=None,
                    help="write the run's redacted span JSONL here and print "
                         "a critical-path latency breakdown (DESIGN.md §11)")
    ap.add_argument("--slo", action="store_true",
                    help="run the burn-rate epilogue: a straggler storm in "
                         "the fleet sim fires the cold-serve SLO and the "
                         "health loop scales the pool up — then the same "
                         "seed with the signal off shows the slower "
                         "recovery (DESIGN.md §13)")
    ap.add_argument("--audit", action="store_true",
                    help="thread the tamper-evident audit ledger through the "
                         "run, then verify the hash chain, print the "
                         "accounting-of-disclosures report, and show the "
                         "tamper control failing verify (DESIGN.md §14)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)  # raises before any work without the card
    if args.journal is None:
        args.journal = str(Path(tempfile.mkdtemp()) / "deid-at-scale-journal.jsonl")

    # ---------------------------------------------------------------- ingest
    gen = StudyGenerator(seed=2024)
    lake = StudyStore("starr-lake", key=b"lake-at-rest-key")
    mrns = {}
    print(f"ingesting {args.studies} studies into the lake ...")
    for i in range(args.studies):
        problem = "pdf" if i % 11 == 0 else ("secondary_capture" if i % 13 == 0 else None)
        s = gen.gen_study(f"ACC{i:05d}", n_images=args.images_per_study, problem=problem)
        lake.put_study(s.accession, s)
        mrns[s.accession] = s.mrn
    total = lake.store.total_bytes()
    print(f"lake holds {human_bytes(total)} across {args.studies} studies")

    # ---------------------------------------------------------------- submit
    clock = SimClock()
    tracer = Tracer(clock) if args.trace else NULL_TRACER
    # fresh deployment: a journal left by a previous example run would replay
    # its completions and mark this run's submissions DONE at admission
    Path(args.journal).unlink(missing_ok=True)
    ledger = None
    if args.audit:
        ledger_path = Path(f"{args.journal}.audit")
        ledger_path.unlink(missing_ok=True)
        ledger = AuditLedger(ledger_path, clock=clock)
    broker = Broker(clock, visibility_timeout=120, tracer=tracer, ledger=ledger)
    journal = Journal(args.journal)
    result_lake = ResultLake(max_bytes=1 << 30, ledger=ledger)  # de-id cache (§6)
    policy = DetectorPolicy()  # registry-first burned-in-text fallback (§9)
    pipeline = DeidPipeline(
        blank_fn=make_blank_fn(device), lake=result_lake, detector_policy=policy,
        tracer=tracer, ledger=ledger, device=device,
    )
    service = DeidService(
        broker, lake, journal, result_lake=result_lake, pipeline=pipeline,
        tracer=tracer, ledger=ledger,
    )
    service.register_study("IRB-70007", TrustMode.POST_IRB)
    service.mark_ineligible("ACC00003")  # research opt-out
    records = service.submit("IRB-70007", list(mrns), mrns)
    queued = sum(1 for r in records if r.state is RequestState.QUEUED)
    print(f"validated: {queued} queued, "
          f"{sum(1 for r in records if r.state is RequestState.REJECTED)} rejected")

    # ------------------------------------------------- distributed scrub farm
    farm = ScrubFarm(None if device.type == "cuda" else [device])
    dest = StudyStore("researcher-bucket")

    injector = FailureInjector(crash_rate=0.08, straggler_rate=0.05, slow_factor=30.0)

    def make_worker(wid: str) -> DeidWorker:
        return DeidWorker(wid, pipeline, lake, dest, journal, tracer=tracer,
                          ledger=ledger)

    pool = WorkerPool(
        broker,
        Autoscaler(broker, AutoscalerConfig(delivery_window=1800), clock),
        make_worker,
        injector,
        straggler_age=120.0,
    )

    # ------------------------------------------------- drain (with a restart)
    print("draining (chaos on: crashes + stragglers) ...")
    pool.max_ticks = 10  # simulate an operator killing the pool mid-drain
    report1 = pool.drain()
    done_mid = len(journal.completed_keys())
    print(f"  pool killed after {pool.max_ticks} ticks: {done_mid}/{queued} done; restarting ...")

    pool2 = WorkerPool(
        broker,
        Autoscaler(broker, AutoscalerConfig(delivery_window=1800), clock),
        make_worker,
        injector,
        straggler_age=120.0,
    )
    report2 = pool2.drain()

    # ----------------------------------------------------------------- report
    manifest = journal.merged_manifest("IRB-70007")
    counts = manifest.counts()
    done = service.request_states("IRB-70007")
    wall = clock.now()
    print("\n=== Table-1-style report ===")
    print(f"studies:      {queued} requested, {sum(1 for s in done.values() if s is RequestState.DONE)} delivered")
    print(f"instances:    {counts['anonymized']} anonymized, {counts['scrubbed']} scrubbed, "
          f"{counts['filtered']} filtered, {counts['failed']} failed")
    print(f"bytes:        {human_bytes(total)}")
    print(f"duration:     {wall/60:.1f} min (simulated)")
    print(f"throughput:   {human_bytes(total / max(wall, 1e-9))}/s aggregate")
    print(f"cost:         ${report1.cost_usd + report2.cost_usd:.2f}")
    print(f"reliability:  {report1.crashes + report2.crashes} crashes, "
          f"{report1.redeliveries + report2.redeliveries} redeliveries, "
          f"{report1.speculative + report2.speculative} speculative re-dispatches, "
          f"{report1.deduped + report2.deduped} deduped")
    print(f"farm:         {farm.n} device(s) in the scrub farm")
    assert counts["failed"] == 0
    assert len(journal.completed_keys()) == queued

    # ----------------------------------- repeat cohort (the on-demand story)
    # an overlapping cohort replayed against the de-id result lake: warm
    # accessions are served without publishing or dispatching anything (§6)
    cohort = list(mrns)[: max(args.studies // 2, 1)]
    pub0 = broker.total_published
    disp0 = pipeline.executor.stats.dispatches if pipeline.executor else 0
    ticket = service.submit_cohort("IRB-70007", cohort, mrns)
    disp1 = pipeline.executor.stats.dispatches if pipeline.executor else 0
    print(f"\ncohort replay: {len(ticket.hits)} warm / {len(ticket.cold)} cold "
          f"/ {len(ticket.rejected)} rejected of {len(cohort)}; "
          f"+{broker.total_published - pub0} publishes, +{disp1 - disp0} dispatches")
    print(f"result lake:  {result_lake.stats.hits} hits, "
          f"{human_bytes(result_lake.stored_bytes())} stored, "
          f"{result_lake.stats.evictions} evictions")
    assert not ticket.cold and broker.total_published == pub0

    # ---------------------------- query-then-de-identify (the paper's §8 flow)
    # researchers don't hand-build accession lists: they query the metadata
    # catalog and the matching slice is admitted through the planner
    from repro_torch.catalog import And, Eq, Range, StudyCatalog

    catalog = StudyCatalog(device=device)
    lake.attach_catalog(catalog)  # backfills every stored study
    service.catalog = catalog
    query = And(Eq("modality", "CT"), Range("study_date", 20150101, 20191231))
    pub0 = broker.total_published
    selection, qticket = service.submit_query("IRB-70007", query, mrns)
    print(f"\nquery:        {selection.query}")
    print(f"selection:    {len(selection.accessions)} studies / "
          f"{selection.total_instances} instances / "
          f"{human_bytes(selection.total_bytes)} "
          f"(pruned {selection.blocks_pruned}/{selection.blocks_pruned + selection.blocks_scanned} blocks)")
    print(f"admission:    {len(qticket.hits)} warm / {len(qticket.cold)} cold / "
          f"{len(qticket.rejected)} rejected; "
          f"+{broker.total_published - pub0} publishes; "
          f"selection digest {qticket.selection_digest[:16]}")
    # everything CT was de-identified above -> the query serves fully warm
    assert not qticket.cold and broker.total_published == pub0

    # ------------------- unknown-device cohort (the §9 detector-fallback flow)
    # novel (manufacturer, model) variants have no scrub rule: the registry
    # miss is counted, the text-band detector proposes bands, and the blanked
    # cohort is served — then a policy edit structurally invalidates it all
    n_unknown = max(args.studies // 8, 2)
    unknown_cohort = []
    for i in range(n_unknown):
        acc = f"ACCU{i:04d}"
        s = gen.gen_study(acc, n_images=args.images_per_study,
                          device=gen.unknown_device(acc, "CT"))
        lake.put_study(acc, s)
        mrns[acc] = s.mrn
        unknown_cohort.append(acc)
    uticket = service.submit_cohort("IRB-70007", unknown_cohort, mrns)
    pool4 = WorkerPool(
        broker,
        Autoscaler(broker, AutoscalerConfig(delivery_window=1800), clock),
        make_worker,
    )
    pool4.drain()
    service.planner.resolve()
    st = pipeline.scrub.detect_stats
    print(f"\nunknown devices: {len(uticket.cold)} cold studies from novel "
          f"(make, model) variants; {st.unknown_lookups} registry misses "
          f"counted, {st.detector_runs} detector scans, "
          f"{st.detected} with text bands blanked")
    assert uticket.done() and not uticket.failed and st.detected > 0
    replay = service.submit_cohort("IRB-70007", unknown_cohort, mrns)
    assert not replay.cold, "same policy must serve the cohort warm"

    # a policy edit (stricter row threshold) changes the ruleset fingerprint:
    # every cached result minted under the old detector is structurally
    # invalid. The journal is deliberately ruleset-agnostic (it records
    # exactly-once *delivery*), so the edit rolls out as a redeploy — fresh
    # journal and broker against the same source lake and result lake — and
    # the very same cohort that just served warm now serves cold.
    edited = DeidPipeline(
        blank_fn=make_blank_fn(device), lake=result_lake,
        detector_policy=DetectorPolicy(row_frac=0.05), ledger=ledger,
        device=device,
    )
    if ledger is not None:
        ledger.append("policy_edit", action="redeploy",
                      ruleset=edited.ruleset_fingerprint().digest,
                      detector_sha=edited.scrub.policy.fingerprint_identity)
    broker2 = Broker(clock, visibility_timeout=120, ledger=ledger)
    journal2_path = args.journal + ".edited"
    Path(journal2_path).unlink(missing_ok=True)
    journal2 = Journal(journal2_path)
    service2 = DeidService(
        broker2, lake, journal2, result_lake=result_lake, pipeline=edited,
        ledger=ledger,
    )
    service2.register_study("IRB-70007", TrustMode.POST_IRB)
    recold = service2.submit_cohort("IRB-70007", unknown_cohort, mrns)
    print(f"policy edit:  fingerprint {pipeline.ruleset_fingerprint().digest[:12]} "
          f"-> {edited.ruleset_fingerprint().digest[:12]}; "
          f"{len(replay.hits)} warm before, {len(recold.cold)} cold after redeploy")
    assert len(recold.cold) == len(unknown_cohort) and not recold.hits
    pool5 = WorkerPool(
        broker2,
        Autoscaler(broker2, AutoscalerConfig(delivery_window=1800), clock),
        lambda wid: DeidWorker(wid, edited, lake, dest, journal2,
                               ledger=ledger),
    )
    pool5.drain()
    service2.planner.resolve()
    assert recold.done() and not recold.failed

    # ------------- source mutation mid-cohort (the §10 incremental re-deid)
    # the PACS re-acquires one already-delivered study: the planner's etag
    # check marks exactly that accession stale, its cached result is evicted,
    # and ONE incremental re-deid runs — every other study still serves warm
    victim = unknown_cohort[0]
    reacquired = gen.gen_study(victim, n_images=args.images_per_study,
                               device=gen.unknown_device(victim, "CT"))
    reacquired.mrn = mrns[victim]  # same patient, new bytes
    lake.put_study(victim, reacquired)
    super0 = journal2.supersessions
    mut_ticket = service2.submit_cohort("IRB-70007", unknown_cohort, mrns)
    assert service2.planner.stats.stale_refreshes >= 1
    assert victim in mut_ticket.cold or victim in mut_ticket.pending
    assert len(mut_ticket.hits) == len(unknown_cohort) - 1  # rest stay warm
    mworkers = []

    def make_edited_worker(wid: str) -> DeidWorker:
        w = DeidWorker(wid, edited, lake, dest, journal2, ledger=ledger)
        mworkers.append(w)
        return w

    pool6 = WorkerPool(
        broker2,
        Autoscaler(broker2, AutoscalerConfig(delivery_window=1800), clock),
        make_edited_worker,
    )
    pool6.drain()
    service2.planner.resolve()
    evicted = sum(w.evicted_stale for w in mworkers)
    re_deids = sum(w.processed for w in mworkers)
    print(f"\nsource mutated: {victim} re-acquired mid-cohort; "
          f"{len(mut_ticket.hits)} warm / {len(mut_ticket.cold)} cold; "
          f"{evicted} stale cache entry evicted, "
          f"{journal2.supersessions - super0} supersession, "
          f"{re_deids} incremental re-deid (amplification "
          f"{re_deids}/{1} = {re_deids:.1f})")
    assert mut_ticket.done() and not mut_ticket.failed
    assert re_deids == 1, "exactly one re-deid: incrementality, not a rebuild"
    assert evicted == 1 and journal2.supersessions - super0 == 1
    assert journal2.etag_for(f"IRB-70007/{victim}") == lake.study_etag(victim)

    # -------------------------------------------- trace epilogue (§11)
    # Only the first deployment is traced: trace ids are (key, attempt)
    # derived, so tracing the post-edit redeploy of the same cohort through
    # the same tracer would alias its trace ids onto the first drain's.
    if args.trace:
        spans = tracer.spans()
        Path(args.trace).write_text(export_spans_jsonl(spans, Redactor()))
        # Reconstruct each delivered item's critical path from the broker
        # event chain. Under SimClock a span's wall time inside one pool tick
        # is zero — latency lives *between* events (queue wait, redelivery
        # backoff) and in the worker's simulated busy_s, not inside spans.
        publishes = {s.trace_id: s for s in spans if s.name == "broker.publish"}
        entries = {}  # final attempt's queue-entry event (publish/redeliver)
        for s in spans:
            if s.name in ("broker.publish", "broker.redeliver"):
                entries.setdefault(s.trace_id, s)
        leases = {s.trace_id: s for s in spans if s.name == "broker.lease"}
        procs = {s.trace_id: s for s in spans if s.name == "worker.process"}
        chains = []
        for ack in (s for s in spans if s.name == "broker.ack"):
            key, attempts = ack.attrs["key"], ack.attrs["deliveries"]
            first = publishes.get(trace_id_for(key, 1))
            lease, proc = leases.get(ack.trace_id), procs.get(ack.trace_id)
            if first is None or lease is None or proc is None:
                continue  # speculative clone or fenced duplicate
            entry = entries.get(ack.trace_id, first)
            chains.append({
                "key": key,
                "attempts": attempts,
                "retry_s": entry.t0 - first.t0,
                "queue_s": lease.t0 - entry.t0,
                "busy_s": proc.attrs.get("busy_s", 0.0),
                "e2e_s": ack.t1 - first.t0,
            })
        chains.sort(key=lambda c: -c["e2e_s"])
        print(f"\n=== critical path: slowest of {len(chains)} delivered items "
              f"(simulated seconds) ===")
        print(f"{'key':<24}{'attempts':>9}{'retry':>9}{'queued':>9}"
              f"{'busy':>9}{'e2e':>9}")
        for c in chains[:5]:
            print(f"{c['key']:<24}{c['attempts']:>9}{c['retry_s']:>9.1f}"
                  f"{c['queue_s']:>9.1f}{c['busy_s']:>9.1f}{c['e2e_s']:>9.1f}")
        by_name: dict = {}
        for s in spans:
            by_name[s.name] = by_name.get(s.name, 0) + 1
        names = ", ".join(f"{n}×{by_name[n]}"
                          for n in sorted(by_name, key=by_name.get, reverse=True))
        print(f"\nspans:        {len(spans)} across {len(tracer.traces())} traces ({names})")
        print(f"trace:        {args.trace} (redacted JSONL), "
              f"digest {tracer.digest()[:16]}")

    # ------------------------------------------ SLO + burn-rate epilogue (§13)
    # A self-contained fleet-sim scenario: every worker straggles 20x from
    # t=0, so the cold-serve latency SLO burns while the generous delivery
    # window keeps the backlog-derived autoscaler target small. With the
    # burn signal wired into the autoscaler the pool scales past what the
    # backlog justifies and the alert resolves sooner; the same seed with
    # the signal off is the negative control.
    if args.slo:
        from repro_torch.sim import ChaosEvent, ChaosSchedule, CohortArrival, FleetConfig, FleetSim

        def storm(slo_autoscale: bool, tag: str):
            n = 10
            corpus = [f"SIM{i:04d}" for i in range(n)]
            cfg = FleetConfig(
                seed=3, n_studies=n, images_per_study=2,
                delivery_window=3600.0, worker_throughput=2e6,
                max_instances=8, slo_cold_threshold=20.0,
                slo_autoscale=slo_autoscale,
            )
            traffic = [CohortArrival(t=0.0, study_id="IRB-B",
                                     accessions=tuple(corpus))]
            chaos = ChaosSchedule([ChaosEvent(
                t=0.0, kind="set_straggler",
                payload={"rate": 1.0, "slow_factor": 20.0})])
            with tempfile.TemporaryDirectory() as td:
                sim = FleetSim(cfg, traffic, Path(td) / f"{tag}.jsonl", chaos,
                               device=device)
                rep = sim.run()
            return sim, rep

        print("\n=== burn-rate -> autoscaler closed loop (DESIGN.md §13) ===")
        results = {}
        for tag in ("on", "off"):
            sim, rep = storm(slo_autoscale=(tag == "on"), tag=tag)
            results[tag] = rep
            scale_ups = [e for e in sim.pool.autoscaler.events
                         if e.reason == "burn-scale-up"]
            alerts = [f"{a.action}@{a.t:.0f}s {a.slo}({a.severity})"
                      for a in sim.slo_engine.alerts]
            print(f"signal {tag:>3}: drained in {rep.metrics['sim_minutes']:.2f} "
                  f"sim-min, worst latency {rep.metrics['max_latency_s']:.1f}s; "
                  f"alerts [{', '.join(alerts) or 'none'}]; "
                  f"{len(scale_ups)} burn-scale-up event(s)")
            print(f"           health: {sim.service.health_report().summary()}")
        assert (results["on"].metrics["sim_minutes"]
                < results["off"].metrics["sim_minutes"])
        print("burn signal bought "
              f"{results['off'].metrics['sim_minutes'] - results['on'].metrics['sim_minutes']:.2f} "
              "sim-min of recovery time on the same seed")

    # --------------------- audit: verify chain + disclosures (§14)
    # Everything above rode the hash-chained ledger: every fetch, deid run,
    # lake byte in/out, delivery, and the policy redeploy. Verify the chain,
    # fold it into the accounting-of-disclosures report, then show the
    # tamper control: one flipped byte and verify() names the damaged line.
    if args.audit:
        ledger.flush()
        problems = ledger.verify()
        assert problems == [], problems
        kinds = ", ".join(f"{k}×{v}" for k, v in sorted(ledger.kind_counts().items()))
        print(f"\n=== tamper-evident audit ledger (DESIGN.md §14) ===")
        print(f"chain:        {len(ledger)} records verify clean ({kinds})")
        print(f"              head {ledger.head()[:16]}, digest {ledger.digest()[:16]}")
        print(DisclosureReport.from_ledger(ledger).summary())
        # the tamper control, on a scratch copy of the ledger file
        import shutil
        tampered_path = Path(f"{args.journal}.audit.tampered")
        shutil.copy(ledger.path, tampered_path)
        raw = bytearray(tampered_path.read_bytes())
        flip_at = len(raw) // 2
        raw[flip_at] = raw[flip_at] ^ 0x01
        tampered_path.write_bytes(bytes(raw))
        tampered = AuditLedger(tampered_path)
        tamper_problems = tampered.verify()
        tampered.close()
        tampered_path.unlink()
        assert tamper_problems, "one flipped byte must fail verification"
        print(f"tamper check: flipped 1 byte mid-file -> verify() fails: "
              f"{tamper_problems[0]}")
        ledger.close()


if __name__ == "__main__":
    main()
