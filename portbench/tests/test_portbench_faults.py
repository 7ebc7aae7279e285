"""A run with the timed path broken underneath comes out as not correct.

Each test skips the harness's look for a card and drives the rest of a run
at a tiny size on the CPU, with one fault planted in the port: a step that
returns its state unchanged, half of a batch left out, an answer or a token
altered where it is produced, an answer that never comes. (One card: no exchange between cards to
leave out.)
"""
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from portbench import harness  # noqa: E402
from portbench_staged import bench  # noqa: E402

TINY_CT = {"config": {"slices_per_study": 24,
                      "catalog": {"accessions": 4, "instances_per_accession": 512, "block_rows": 512,
                                  "columns": 11}},
           "traffic": {"payload_sample_block": 8}}
# full width and vocabulary (the limit is set there), two layers
SMALL_SERVE = {"config": {"num_hidden_layers": 2},
               "traffic": {"max_batch": 2, "batches": 4,
                           "prompt": {"median": 12, "sigma": 0.6, "min": 4, "max": 32},
                           "output": {"median": 8, "sigma": 0.6, "min": 2, "max": 16},
                           "sample_requests": 2}}


def _run(workload, overrides):
    return harness.run_cell(workload, 21, 0.1, False, t_start=time.perf_counter(), device="cpu",
                            require_card=False, overrides=overrides, check_imports=False,
                            bench=bench())


def _broken_run(executor_cls):
    """BatchedDeidExecutor.run with ``fault(items, outputs)`` applied to
    what it produces."""
    orig = executor_cls.run

    def patch(fault):
        def run(self, items, **kw):
            return fault(items, orig(self, items, **kw))
        return run
    return patch


@pytest.mark.parametrize("workload", ["ct_request.cold", "ct_request.scrub"])
def test_deid_sound_run_is_correct(workload):
    assert _run(workload, TINY_CT)["correct"]


@pytest.mark.parametrize("workload", ["ct_request.cold", "ct_request.scrub"])
def test_deid_state_returned_unchanged(monkeypatch, workload):
    """The anonymizer hands back the instance as it came."""
    from repro_torch.core.anonymize import AnonResult, AnonymizerStage

    monkeypatch.setattr(AnonymizerStage, "__call__", lambda self, ds, params, pseudo=None:
                        AnonResult(ds.copy(), {}))
    out = _run(workload, TINY_CT)
    assert not out["correct"] and out["checks"]["tag_mismatches"]["value"] > 0


@pytest.mark.parametrize("workload", ["ct_request.cold", "ct_request.scrub"])
def test_deid_half_of_the_batch_left_out(monkeypatch, workload):
    """The executor de-identifies the first half of each batch and hands
    the rest back as it came (blanked nowhere, coded from the raw pixels)."""
    from repro_torch.core.batch import BatchOutput, BatchedDeidExecutor
    from repro_torch.dicom import codec

    raw = {}
    orig_run = BatchedDeidExecutor.run

    def run(self, items, **kw):
        half = len(items) // 2
        kept = orig_run(self, items[:half], **kw)
        rest = [BatchOutput(pixels=raw[id(p)], payload=codec.encode(raw[id(p)], 1)
                            if kw.get("recompress", True) else None) for p, _ in items[half:]]
        return kept + rest

    from repro_torch.core.scrub import ScrubStage
    from repro_torch.dicom.dataset import DicomDataset

    orig_scrub_study = ScrubStage.scrub_study

    def scrub_study(self, datasets, executor):
        for ds in datasets:
            raw[id(ds.pixels)] = ds.pixels
        return orig_scrub_study(self, datasets, executor)

    orig_copy = DicomDataset.copy

    def copy(self):
        out = orig_copy(self)
        if out.pixels is not None and id(self.pixels) in raw:
            raw[id(out.pixels)] = self.pixels
        return out

    monkeypatch.setattr(ScrubStage, "scrub_study", scrub_study)
    monkeypatch.setattr(DicomDataset, "copy", copy)
    monkeypatch.setattr(BatchedDeidExecutor, "run", run)
    out = _run(workload, TINY_CT)
    assert not out["correct"] and out["checks"]["pixel_mismatches"]["value"] > 0


@pytest.mark.parametrize("workload", ["ct_request.cold", "ct_request.scrub"])
def test_deid_answer_altered(monkeypatch, workload):
    """One pixel of every de-identified slice is altered where it is
    produced."""
    from repro_torch.core.batch import BatchedDeidExecutor

    def fault(items, outs):
        for o in outs:
            o.pixels[100, 100] ^= 1
        return outs

    monkeypatch.setattr(BatchedDeidExecutor, "run", _broken_run(BatchedDeidExecutor)(fault))
    out = _run(workload, TINY_CT)
    assert not out["correct"] and out["checks"]["pixel_mismatches"]["value"] > 0


@pytest.mark.parametrize("block", [5, 8])
def test_deid_one_chunk_altered(monkeypatch, block):
    """One pixel and one payload byte of each slice of the study's last
    block, the short one, are altered where they are produced: the check
    compares every delivered instance's pixels, and samples a payload in
    every block."""
    from repro_torch.core.batch import BatchedDeidExecutor

    n = TINY_CT["config"]["slices_per_study"]

    def fault(items, outs):
        if len(outs) == n:
            for o in outs[n - (n % block or block):]:
                o.pixels[100, 100] ^= 1
                o.payload = o.payload[:-1] + bytes([o.payload[-1] ^ 1])
        return outs

    monkeypatch.setattr(BatchedDeidExecutor, "run", _broken_run(BatchedDeidExecutor)(fault))
    over = {"config": TINY_CT["config"], "traffic": {"payload_sample_block": block}}
    out = _run("ct_request.cold", over)
    assert not out["correct"]
    assert out["checks"]["pixel_mismatches"]["value"] > 0
    assert out["checks"]["payload_mismatches"]["value"] > 0


def test_serve_sound_run_is_correct():
    assert _run("qwen2-0.5b.serve", SMALL_SERVE)["correct"]


def test_serve_token_altered(monkeypatch):
    """The engine serves the worst token, not the best, at one step of each
    batch."""
    from repro_torch.serving.engine import ServeEngine

    orig = ServeEngine._sample
    calls = {"n": 0}

    def sample(logits, reqs, generator):
        calls["n"] += 1
        out = orig(logits, reqs, generator)
        if calls["n"] % 3 == 0:
            out = np.asarray(logits.argmin(-1).cpu().numpy())
        return out

    monkeypatch.setattr(ServeEngine, "_sample", staticmethod(sample))
    out = _run("qwen2-0.5b.serve", SMALL_SERVE)
    assert not out["correct"]
    assert out["checks"]["served_logit_gap"]["value"] > out["checks"]["served_logit_gap"]["limit"]


def test_serve_state_returned_unchanged(monkeypatch):
    """Decode leaves its cache as it was: the new keys and values are
    never written."""
    import repro_torch.models.blocks as blocks

    monkeypatch.setattr(blocks, "update_kv_cache", lambda k_cache, v_cache, k, v, pos: (k_cache, v_cache))
    out = _run("qwen2-0.5b.serve", SMALL_SERVE)
    assert not out["correct"]


def test_deid_study_never_comes(monkeypatch):
    """A worker acknowledges the first measured study's message and drops
    its work (the warm-up's study is processed before it)."""
    from repro_torch.queueing.worker import DeidWorker

    orig = DeidWorker.process
    seen = {"n": 0}

    def process(self, broker, msg, injector=None):
        seen["n"] += 1
        if seen["n"] == 2:
            broker.ack(msg.msg_id)
            return 0.0
        return orig(self, broker, msg, injector)

    monkeypatch.setattr(DeidWorker, "process", process)
    out = _run("ct_request.scrub", TINY_CT)
    assert not out["correct"] and out["checks"]["lost_or_failed_studies"]["value"] > 0


def test_serve_half_of_the_batch_left_out(monkeypatch):
    """The engine answers the first half of each batch only."""
    from repro_torch.serving.engine import ServeEngine

    orig = ServeEngine._run_batch

    def run_batch(self, reqs, generator):
        return orig(self, reqs, generator)[: max(1, len(reqs) // 2)]

    monkeypatch.setattr(ServeEngine, "_run_batch", run_batch)
    out = _run("qwen2-0.5b.serve", SMALL_SERVE)
    assert not out["correct"] and out["checks"]["missing_requests"]["value"] > 0
