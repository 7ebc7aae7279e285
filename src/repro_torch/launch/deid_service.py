"""De-identification service launcher: the paper's operational loop as a CLI.

    PYTHONPATH=src python -m repro_torch.launch.deid_service --studies 30 --window-min 30
    PYTHONPATH=src python -m repro_torch.launch.deid_service --device cpu

Stands up the full control plane (lake -> server -> broker -> autoscaled pool
-> researcher bucket) against the synthetic archive and drains one request,
printing the Table-1-style report. The heavy lifting is shared with
examples/deid_at_scale.py; this entry point exists so operators get the same
``python -m`` surface as train/serve/dryrun.

The pipeline runs on ``--device`` (default the card, ``cuda:0``; without
CUDA that default raises): the batched executor's kernels and the
``ScrubStage`` blank function (the scrub kernel, ``make_blank_fn``) run
there; ``--device cpu`` runs their plain PyTorch versions.
"""
from __future__ import annotations

import argparse

from repro_torch.core import DeidPipeline, TrustMode
from repro_torch.dicom.generator import StudyGenerator
from repro_torch.kernels.scrub.ops import make_blank_fn
from repro_torch.obs import (
    HealthController,
    SloEngine,
    SloSpec,
    Tracer,
    default_burn_rules,
    derive_serve_observations,
)
from repro_torch.queueing import Autoscaler, AutoscalerConfig, Broker, DeidWorker, FailureInjector, Journal, WorkerPool
from repro_torch.queueing.server import DeidService
from repro_torch.storage.object_store import StudyStore
from repro_torch.utils.bytesize import human_bytes
from repro_torch.utils.timing import SimClock


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--studies", type=int, default=30)
    ap.add_argument("--images-per-study", type=int, default=3)
    ap.add_argument("--window-min", type=float, default=30.0)
    ap.add_argument("--chaos", action="store_true")
    ap.add_argument("--journal", default="/tmp/deid-service-journal.jsonl")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default cuda:0)")
    args = ap.parse_args(argv)

    gen = StudyGenerator(args.seed)
    lake = StudyStore("lake", key=b"at-rest-key")
    mrns = {}
    for i in range(args.studies):
        s = gen.gen_study(f"SRV{i:05d}", n_images=args.images_per_study)
        lake.put_study(s.accession, s)
        mrns[s.accession] = s.mrn

    clock = SimClock()
    tracer = Tracer(clock)
    broker = Broker(clock, visibility_timeout=120, tracer=tracer)
    journal = Journal(args.journal)
    service = DeidService(broker, lake, journal, tracer=tracer)
    service.register_study("IRB-SRV", TrustMode.POST_IRB)
    service.submit("IRB-SRV", list(mrns), mrns)

    dest = StudyStore("researcher")
    pipeline = DeidPipeline(blank_fn=make_blank_fn(args.device), device=args.device)
    injector = FailureInjector(crash_rate=0.05, straggler_rate=0.05) if args.chaos else None
    pool = WorkerPool(
        broker,
        Autoscaler(broker, AutoscalerConfig(delivery_window=args.window_min * 60), clock),
        lambda wid: DeidWorker(wid, pipeline, lake, dest, journal, tracer=tracer),
        injector,
    )
    report = pool.drain()
    manifest = journal.merged_manifest("IRB-SRV")
    total = lake.store.total_bytes()

    # SLO/health surface (DESIGN.md §13): the launcher has no per-delivery
    # hook, so cold-serve latencies are re-derived from the span stream —
    # the same reconstruction the fleet sim's SloConformance cross-checks —
    # then evaluated once at drain time.
    engine = SloEngine([SloSpec(
        "cold_serve", objective=0.9, threshold=args.window_min * 60,
        kind="latency", rules=default_burn_rules(1.0 / 60.0),
    )])
    for t, _key, latency in derive_serve_observations(tracer.spans()):
        engine.observe("cold_serve", t=t, value=latency)
    engine.evaluate(clock.now())
    service.attach_health(HealthController(engine))
    health = service.health_report()

    out = {
        "studies": report.processed,
        "instances": manifest.counts(),
        "bytes": total,
        "minutes": clock.now() / 60,
        "throughput": total / max(clock.now(), 1e-9),
        "cost_usd": report.cost_usd,
        "crashes": report.crashes,
        "health": health.to_dict(),
    }
    print(
        f"{report.processed} studies | {human_bytes(total)} | {out['minutes']:.1f} min "
        f"| {human_bytes(out['throughput'])}/s | ${out['cost_usd']:.2f} | counts {out['instances']}"
    )
    print(f"health: {health.summary()}")
    return out


if __name__ == "__main__":
    main()
