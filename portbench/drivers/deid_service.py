"""De-identification driver: cohort queries to the port's ``DeidService``,
drained by its ``WorkerPool`` through ``DeidPipeline.run_study`` on the
card, against a catalog of an archive's size on the card.

Set-up draws the CT pixel stacks and the studies' tags from the seed, puts
the studies into the identified data lake (``StudyStore``), indexes them
beside the archive's background rows in the ``StudyCatalog``, builds the
deployment (broker, journal and audit ledger under ``TMPDIR``, result lake,
pipeline, autoscaled pool) and serves one warm-up study of the cell's own
size through the whole path, so the window does not pay the first touch of
a study's buffers. The window is a closed loop: each query selects two studies
that its research study (IRB protocol) has never had de-identified, and
``ahead`` queries stay submitted beyond the one in service. The queries
cycle over a pool of accession pairs, one protocol per cycle (research
groups asking for overlapping cohorts), so the loop never runs dry: every
(protocol, accession) is new to the journal and to the result lake. Progress
is counted by executor chunk (32 slices): a chunk counts when its collect
returns inside the window.

After the window every study that finished is checked against the plain
reference: the catalog's selection, every delivered instance's tags and
pixels, (with recompression) the payload of a sample of instances drawn
from the seed, one in each block of ``payload_sample_block`` slices, the
journal's manifest, and the ledger's records.
"""
from __future__ import annotations

import shutil
import tempfile
import time
from pathlib import Path

import numpy as np

from portbench import inputs


def _date_int(base: int, days: int) -> int:
    import datetime as dt

    d = dt.date(base // 10000, base // 100 % 100, base % 100) + dt.timedelta(days=days)
    return int(d.strftime("%Y%m%d"))


def _row(elements: dict, pixel_bytes: int, burned: bool) -> dict:
    """One catalog row of an instance (the catalog's columns)."""
    return {
        "modality": elements["Modality"], "body_part": elements["BodyPartExamined"],
        "manufacturer": elements["Manufacturer"], "model": elements["ManufacturerModelName"],
        "study_date": int(elements["StudyDate"]), "bits_stored": int(elements["BitsStored"]),
        "rows": int(elements["Rows"]), "cols": int(elements["Columns"]),
        "nbytes": sum(len(str(v)) for v in elements.values()) + pixel_bytes,
        "burned_in": 0, "burned_in_detected": int(burned),
    }


def setup(cell):
    import torch

    from repro_torch.audit import AuditLedger
    from repro_torch.catalog import And, In, Range, StudyCatalog
    from repro_torch.core import DeidPipeline
    from repro_torch.detect import DetectorPolicy
    from repro_torch.dicom.dataset import DicomDataset
    from repro_torch.dicom.devices import DeviceKey
    from repro_torch.dicom.generator import SyntheticStudy
    from repro_torch.lake import ResultLake
    from repro_torch.obs.trace import Tracer
    from repro_torch.queueing import Autoscaler, AutoscalerConfig, Broker, DeidWorker, Journal
    from repro_torch.queueing import WorkerPool
    from repro_torch.queueing.server import DeidService
    from repro_torch.storage.object_store import StudyStore
    from repro_torch.utils.timing import SimClock

    c, t = cell.config, cell.traffic
    dev = c["device"]
    phases, t_phase = {}, [time.perf_counter()]

    def phase(name):
        now = time.perf_counter()
        phases[name] = now - t_phase[0]
        t_phase[0] = now

    if cell.device.type == "cuda":
        from repro_torch.kernels.build import build_all

        build_all()
    n_slices, every = c["slices_per_study"], c["burned_in_every"]
    rects = [tuple(r) for r in c["scrub_rects"]]
    stacks = [inputs.ct_pixel_stack(cell.seed, f"stack{k}", n_slices, dev["rows"], dev["cols"],
                                    (1 << dev["bits_stored"]) - 1, rects, every, cell.device)
              for k in range(t["pixel_stacks"])]
    protocols = [(f"IRB-{k:03d}", inputs.rng(cell.seed, "protocol-key", k).bytes(32))
                 for k in range(t["protocols"])]
    phase("kernels_and_stacks")

    # the archive's background rows, then the request's studies
    cat_cfg = c["catalog"]
    catalog = StudyCatalog(block_rows=cat_cfg["block_rows"], device=cell.device)
    bg = inputs.catalog_background(cell.seed, cat_cfg["accessions"], cat_cfg["instances_per_accession"])
    per = cat_cfg["instances_per_accession"]
    for a in range(cat_cfg["accessions"]):
        catalog.ingest_rows(f"BG{a:06d}", inputs.catalog_row_dicts(bg, a * per, (a + 1) * per), etag=str(a))

    phase("catalog_background")
    source = StudyStore("lake")
    dkey = DeviceKey(dev["modality"], dev["manufacturer"], dev["model"], dev["rows"], dev["cols"])
    studies = {}

    def add_study(acc: str, date: int, n: int, stack: int) -> None:
        tags = inputs.ct_study_tags(cell.seed, acc, date, dev, n)
        study = SyntheticStudy(accession=acc, mrn=tags["mrn"], patient_name=tags["name"],
                               study_uid=tags["study_uid"], study_date=tags["date"],
                               modality=dev["modality"], device=dkey, body_part="CHEST")
        px = stacks[stack]
        for i, el in enumerate(tags["instances"]):
            study.datasets.append(DicomDataset(elements=dict(el), private=dict(tags["private"]),
                                               pixels=px[i]))
        source.put_study(acc, study)
        catalog.ingest_rows(acc, [_row(el, px[i].nbytes, i % every == 0)
                                  for i, el in enumerate(tags["instances"])],
                            etag=source.study_etag(acc))
        studies[acc] = {"tags": tags, "stack": stack, "date": date, "n": n}

    base = c["request_first_date"]
    add_study("WARM0", _date_int(base, -1), n_slices, 0)
    pairs = []
    for q in range(t["accession_pairs"]):
        date = _date_int(base, q)
        accs = [f"ACC{q:04d}{k}" for k in range(c["studies_per_request"])]
        for k, acc in enumerate(accs):
            add_study(acc, date, n_slices, (q * len(accs) + k) % len(stacks))
        pairs.append((And(In("modality", [dev["modality"]]), Range("study_date", date, date)), accs))
    warm_query = And(In("modality", [dev["modality"]]),
                     Range("study_date", _date_int(base, -1), _date_int(base, -1)))
    source.catalog = catalog
    phase("studies_into_lake")
    mrns = {acc: s["tags"]["mrn"] for acc, s in studies.items()}

    # the deployment
    tmp = Path(tempfile.mkdtemp(prefix="portbench-deid-"))
    clock = SimClock()
    ledger = AuditLedger(tmp / "audit.jsonl", clock=clock)
    broker = Broker(clock, visibility_timeout=t["visibility_timeout_s"])
    journal = Journal(tmp / "journal.jsonl")
    lake = ResultLake(max_bytes=t["result_lake_bytes"], ledger=ledger)
    tracer = Tracer(cell.clock) if cell.trace else None
    pipe = DeidPipeline(device=cell.device, detector_policy=DetectorPolicy(mode=c["detector_policy"]),
                        lake=lake, ledger=ledger, recompress=t["recompress"], tracer=tracer)
    service = DeidService(broker, source, journal, result_lake=lake, pipeline=pipe,
                          catalog=catalog, ledger=ledger)
    for name, pkey in protocols:
        service.register_study(name, key=pkey)
    dest = StudyStore("researcher")
    pool = WorkerPool(broker, Autoscaler(broker, AutoscalerConfig(), clock),
                      lambda wid: DeidWorker(wid, pipe, source, dest, journal, ledger=ledger))

    # warm-up: one study of the cell's own size through the whole path
    service.submit_query(protocols[0][0], warm_query, mrns)
    pool.drain()
    service.planner.resolve()
    if tracer is not None:
        tracer.clear()
    phase("deploy_and_warm_up")
    cell.layer.setdefault("notes", {})["setup_phases_s"] = phases

    # the benchmark's own readings around the program's calls
    ex = pipe.executor
    rec = {"chunks": [], "payloads": {}, "current": None, "submits": []}
    samples = {acc: sample_indices(cell, acc, s["n"]) for acc, s in studies.items()}
    orig_run_study, orig_run, orig_collect = pipe.run_study, ex.run, ex._collect_chunk
    orig_submit = service.submit_query

    def run_study(study, request, worker_id=""):
        rec["current"] = (request.research_study, request.accession)
        return orig_run_study(study, request, worker_id)

    def run(items, **kw):
        outs = orig_run(items, **kw)
        proto, acc = rec["current"]
        if kw.get("recompress", True) and acc in samples:
            for i in samples[acc]:
                rec["payloads"][(proto, acc, i)] = outs[i].payload
        return outs

    def collect(items, st, sv, out):
        orig_collect(items, st, sv, out)
        rec["chunks"].append((time.perf_counter(), sum(items[i][0].nbytes for i in st.idxs),
                              sum(len(out[i].payload or b"") for i in st.idxs)))

    def submit_query(study_id, query, mrn_lookup):
        t0 = time.perf_counter()
        with cell.span("deid.submit_query"):
            sel, ticket = orig_submit(study_id, query, mrn_lookup)
        rec["submits"].append((t0, time.perf_counter() - t0, sel, ticket))
        return sel, ticket

    pipe.run_study, ex.run, ex._collect_chunk = run_study, run, collect
    service.submit_query = submit_query
    if cell.device.type == "cuda":
        torch.cuda.synchronize()
    return {"service": service, "pool": pool, "clock": clock, "broker": broker, "journal": journal,
            "ledger": ledger, "dest": dest, "pipe": pipe, "tracer": tracer, "lake": lake,
            "catalog": catalog, "source": source, "pairs": pairs, "mrns": mrns, "tmp": tmp,
            "rec": rec, "studies": studies, "stacks": stacks, "protocols": protocols, "bg": bg,
            "samples": samples}


def sample_indices(cell, acc: str, n: int) -> list:
    """The instances whose payload the check compares: the first slice,
    which carries the burned-in banner, and one drawn from the seed in each
    block of ``payload_sample_block`` slices (the executor's chunk), the
    short last block included."""
    block = cell.traffic["payload_sample_block"]
    r = inputs.rng(cell.seed, "ct-sample", acc)
    return sorted({0, *(b0 + int(r.integers(min(block, n - b0))) for b0 in range(0, n, block))})


def _done(journal, proto, accs) -> bool:
    return all(journal.is_done(f"{proto}/{a}") for a in accs)


def measure(cell, s):
    service, pool, clock, journal = s["service"], s["pool"], s["clock"], s["journal"]
    pairs, protocols, mrns, rec = s["pairs"], s["protocols"], s["mrns"], s["rec"]
    ahead = cell.traffic["ahead"]
    submitted = []   # (protocol, query, accessions)
    t0 = time.perf_counter()
    deadline = t0 + cell.seconds
    while True:
        while sum(1 for p, _, a in submitted if not _done(journal, p, a)) < 1 + ahead:
            q = len(submitted)
            if q // len(pairs) >= len(protocols):
                raise RuntimeError("the traffic ran out of protocols inside the window; add protocols")
            proto = protocols[q // len(pairs)][0]
            pred, accs = pairs[q % len(pairs)]
            service.submit_query(proto, pred, mrns)
            submitted.append((proto, pred, accs))
        with cell.span("deid.pool_step"):
            busy = pool.step()
        clock.advance(max(busy, pool.tick_seconds))
        if time.perf_counter() >= deadline:
            break
    t1 = time.perf_counter()
    service.planner.resolve()
    cell.window = (t0, t1)
    inside = [(t, px, pl) for t, px, pl in rec["chunks"] if t0 <= t <= t1]
    pixel_bytes = sum(px for _, px, _ in inside)
    cell.e2e["deid_MB_per_s"] = pixel_bytes / 1e6 / (t1 - t0)
    submits = [ms for ts, ms, _, _ in rec["submits"] if t0 <= ts <= t1]
    cell.layer["deid"] = {
        "recompress": cell.traffic["recompress"], "pixel_bytes": pixel_bytes,
        "payload_bytes": sum(pl for _, _, pl in inside), "chunks": len(inside),
        "submit_s": submits, "chunk_times": [(t, px, pl) for t, px, pl in rec["chunks"]],
    }
    if s["tracer"] is not None:
        spans = [(sp.name, sp.t0, sp.t1) for sp in s["tracer"].spans() if sp.t1 is not None]
        cell.spans.extend(spans)
        cell.layer["deid"]["pipeline_spans"] = spans
    s["submitted"] = submitted
    s["outstanding"] = s["broker"].stats().outstanding
    cell.layer.setdefault("notes", {})["pool_steps_s"] = [
        round(b - a, 3) for n, a, b in cell.spans if n == "deid.pool_step"]


def release(cell, s):
    s["pipe"].executor.close()
    keep = ("journal", "ledger", "dest", "rec", "studies", "stacks", "protocols", "bg",
            "submitted", "samples", "tmp", "outstanding")
    return {k: s[k] for k in keep}


def expected_selection(s, pred_date: int, modality_index: int) -> list:
    """Accessions a query for CT on one date must select: evaluated over
    the background columns and the request's own studies."""
    bg = s["bg"]
    hits = int(np.sum((bg["modality"] == modality_index) & (bg["study_date"] == pred_date)))
    if hits:
        raise RuntimeError("background rows match a request date; the inputs are malformed")
    return sorted(acc for acc, st in s["studies"].items() if st["date"] == pred_date)


def check(cell, s):
    from portbench.reference import deid

    c, t = cell.config, cell.traffic
    journal, ledger, dest, rec = s["journal"], s["ledger"], s["dest"], s["rec"]
    rects = [tuple(r) for r in c["scrub_rects"]]
    recompress = t["recompress"]
    keys = dict(s["protocols"])
    mism = {"selection": 0, "tags": 0, "pixels": 0, "payload": 0, "records": 0}
    ct_index = 0  # the background's modality list starts with CT
    if inputs.catalog_background_modality(ct_index) != c["device"]["modality"]:
        raise RuntimeError("the background's modality list changed")
    failed = 0
    for (proto, pred, accs), (_, _, sel, ticket) in zip(s["submitted"], rec["submits"]):
        failed += len(ticket.failed) + len(ticket.rejected)
        if list(sel.accessions) != expected_selection(s, s["studies"][accs[0]]["date"], ct_index):
            mism["selection"] += 1
    done = [(proto, acc) for proto, _, accs in s["submitted"] for acc in accs
            if _done(journal, proto, [acc])]
    s["done"] = done
    for proto, acc in done:
        st = s["studies"][acc]
        tags = st["tags"]
        px = s["stacks"][st["stack"]]
        pseudo = deid.pseudonyms(keys[proto], proto, acc, tags["mrn"])
        outs = {int(o.elements.get("InstanceNumber", 0)) - 1: o
                for o in dest.outputs(f"{proto}/{pseudo['accession']}")}
        if sorted(outs) != list(range(st["n"])):
            mism["records"] += 1
            continue
        sample = set(s["samples"][acc])
        for i, el in enumerate(tags["instances"]):
            o = outs[i]
            if o.elements != deid.anonymize(el, pseudo, recompress) or o.private or o.encapsulated:
                mism["tags"] += 1
            want = deid.blank(px[i], rects)
            if o.pixels is None or o.pixels.dtype != want.dtype or not np.array_equal(o.pixels, want):
                mism["pixels"] += 1
            if recompress and i in sample and rec["payloads"].get((proto, acc, i)) != deid.encode(want):
                mism["payload"] += 1
        m = journal.manifest_for(f"{proto}/{acc}")
        entries = m.entries if m is not None else []
        if len(entries) != st["n"] or any(e.outcome.value != "anonymized" for e in entries):
            mism["records"] += 1
    measured = {(proto, acc) for proto, _, accs in s["submitted"] for acc in accs}

    def owner(r):
        return (r.get("project") or str(r.get("key", "")).split("/")[0], r.get("accession"))

    kinds = {kind: sum(1 for r in ledger.records(kind) if owner(r) in measured)
             for kind in ("source_fetch", "deid_execute", "delivery", "provenance")}
    mism["records"] += sum(1 for n in kinds.values() if n != len(done))
    if ledger.verify():
        mism["records"] += 1
    # a study neither finished nor still queued or leased never comes
    lost = len(measured) - len(done) - s["outstanding"]
    cell.attempted = len(measured)
    cell.failed = max(failed, lost)
    cell.layer.setdefault("notes", {})["checked"] = {"studies": len(done), "ledger": kinds,
                                                      "mismatches": mism}
    lim = t["limits"]
    cell.check("selection_mismatches", mism["selection"], lim["selection_mismatches"])
    cell.check("tag_mismatches", mism["tags"], lim["tag_mismatches"])
    cell.check("pixel_mismatches", mism["pixels"], lim["pixel_mismatches"])
    if recompress:
        cell.check("payload_mismatches", mism["payload"], lim["payload_mismatches"])
    cell.check("record_mismatches", mism["records"], lim["record_mismatches"])
    cell.check("studies_unchecked", 0 if done else 1, 0)
    cell.check("lost_or_failed_studies", cell.failed, 0)
    journal.close()
    ledger.close()
    shutil.rmtree(s["tmp"], ignore_errors=True)


def control(cell, s):
    """The control: the plain reference with one stated guarantee broken
    (the burned-in regions left unblanked) in the program's place, held to
    the same comparison of every delivered instance's pixels."""
    from portbench.reference import deid

    rects = [tuple(r) for r in cell.config["scrub_rects"]]
    n = bad = 0
    for _, acc in s["done"]:
        st = s["studies"][acc]
        px = s["stacks"][st["stack"]]
        for i in range(st["n"]):
            n += 1
            bad += int(not np.array_equal(px[i], deid.blank(px[i], rects)))
    cell.layer.setdefault("notes", {})["control"] = {"unblanked_pixel_mismatches": bad, "compared": n}
