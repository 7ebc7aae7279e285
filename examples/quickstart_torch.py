"""Quickstart on the PyTorch/CUDA port: de-identify one imaging study end to end.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu] [--journal PATH]

Walks the paper's full request lifecycle on a tiny synthetic study:
register an IRB study -> validate + pseudonymize -> queue -> drain with one
worker -> inspect the de-identified output and the manifest. The worker's
pipeline runs on ``--device`` (default ``cuda``: the card's kernels;
``cpu``: their plain PyTorch versions). The journal starts fresh: a file at
``--journal`` (default: a new temporary directory) is replaced.
"""
import argparse
import json
import tempfile
from pathlib import Path

from repro_torch.core import DeidPipeline, TrustMode
from repro_torch.device import resolve_device
from repro_torch.dicom.generator import StudyGenerator
from repro_torch.queueing import Autoscaler, AutoscalerConfig, Broker, DeidWorker, Journal, WorkerPool
from repro_torch.queueing.server import DeidService
from repro_torch.storage.object_store import StudyStore
from repro_torch.utils.timing import SimClock


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--journal", default=None,
                    help="journal file (replaced if present); default: a new temporary directory")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)  # raises before any work without the card
    journal_path = Path(args.journal or Path(tempfile.mkdtemp()) / "quickstart-journal.jsonl")
    # fresh deployment: a stale journal would replay its completions and
    # deliver nothing
    journal_path.unlink(missing_ok=True)

    # --- the data lake holds identified studies (paper: encrypted object store)
    gen = StudyGenerator(seed=42)
    lake = StudyStore("starr-lake", key=b"lake-at-rest-key")
    study = gen.gen_study("ACC-2024-001", modality="CT", n_images=3, problem="pdf")
    lake.put_study(study.accession, study)
    print(f"lake: {study.accession} ({len(study.datasets)} instances, "
          f"{study.nbytes()/1e6:.1f} MB, patient {study.patient_name})")

    # --- central server: register the research study, submit the request
    clock = SimClock()
    broker = Broker(clock)
    journal = Journal(journal_path)
    service = DeidService(broker, lake, journal)
    service.register_study("IRB-60001", TrustMode.POST_IRB)
    records = service.submit("IRB-60001", [study.accession], {study.accession: study.mrn})
    print(f"submitted: {records[0].accession} -> {records[0].anon_accession} ({records[0].state.value})")

    # --- autoscaled worker pool drains the queue
    dest = StudyStore("researcher-bucket")
    pipeline = DeidPipeline(device=device)
    pool = WorkerPool(
        broker,
        Autoscaler(broker, AutoscalerConfig(), clock),
        lambda wid: DeidWorker(wid, pipeline, lake, dest, journal),
    )
    report = pool.drain()
    print(f"drained: {report.processed} studies, cost ${report.cost_usd:.4f}")

    # --- researcher sees de-identified instances + manifest, never PHI
    request_id = f"IRB-60001/{records[0].anon_accession}"
    outputs = list(dest.outputs(request_id))
    manifest = journal.merged_manifest("IRB-60001")
    print(f"delivered {len(outputs)} instances; manifest counts: {manifest.counts()}")
    ds = outputs[0]
    print(f"  PatientID={ds['PatientID']} AccessionNumber={ds['AccessionNumber']} "
          f"StudyDate={ds['StudyDate']} (original {study.study_date})")
    assert all(study.mrn not in json.dumps(e.to_dict()) for e in manifest.entries)
    print(f"PHI-free manifest verified (journal {journal_path}). Done.")


if __name__ == "__main__":
    main()
