"""The port's scrub farm and elastic controller (``repro_torch.distributed``)
against the JAX package's farm and ``numpy_blank``, in process over lists
of CPU devices (the JAX package needs a subprocess to fake 8 devices), and
the two example twins against the JAX examples."""
import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.scrub import numpy_blank
from repro.distributed import ScrubFarm as JaxScrubFarm
from repro_torch.core import DeidPipeline
from repro_torch.dicom.generator import StudyGenerator
from repro_torch.distributed import ElasticFarmController, ScrubFarm, bucket_by_resolution

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _batch(n=13, dtype=np.uint16, seed=0):
    rng = np.random.default_rng(seed)
    imgs = (rng.random((n, 64, 128)) * (4000 if dtype == np.uint16 else 250)).astype(dtype)
    rl = [[(0, 0, 128, 8), (int(rng.integers(100)), int(rng.integers(50)), 20, 10)]
          for _ in range(n)]
    return imgs, rl


def _blank(imgs, rl):
    return np.stack([numpy_blank(imgs[i], rl[i]) for i in range(len(rl))])


class TestScrubFarm:
    @pytest.mark.parametrize("n_devices", [1, 3, 8])
    @pytest.mark.parametrize("n_images", [1, 5, 13, 16])
    def test_equals_numpy_blank_and_reference(self, n_devices, n_images):
        imgs, rl = _batch(n_images)
        farm = ScrubFarm([CPU] * n_devices)
        assert farm.n == n_devices
        out = farm.scrub_batch(imgs, rl)
        assert out.shape == imgs.shape and out.dtype == imgs.dtype
        np.testing.assert_array_equal(out, _blank(imgs, rl))
        np.testing.assert_array_equal(out, JaxScrubFarm().scrub_batch(imgs, rl))

    def test_ragged_rects_and_uint8(self, rng):
        imgs = (rng.random((5, 64, 96)) * 250).astype(np.uint8)
        rl = [[(0, 0, 96, 8)], [(10, 10, 20, 20)], [], [(90, 60, 20, 20)],
              [(0, 0, 1, 1), (2, 2, 3, 3), (4, 4, 5, 5), (6, 6, 7, 7), (8, 8, 9, 9)]]
        out = ScrubFarm([CPU] * 2).scrub_batch(imgs, rl)
        np.testing.assert_array_equal(out, _blank(imgs, rl))
        np.testing.assert_array_equal(out, JaxScrubFarm().scrub_batch(imgs, rl))

    def test_process_datasets_buckets_and_writes_back(self):
        pipe = DeidPipeline(recompress=False, device="cpu")
        gen = StudyGenerator(seed=1234)
        studies = [gen.gen_study("DF-1", modality="US", n_images=2),
                   gen.gen_study("DF-2", modality="CT", n_images=2),
                   gen.gen_study("DF-3", modality="DX", n_images=1)]
        datasets = [d for s in studies for d in s.datasets]
        before = [None if d.pixels is None else d.pixels.copy() for d in datasets]
        assert len(bucket_by_resolution(datasets)) == 3
        applied = ScrubFarm([CPU] * 4).process_datasets(datasets, pipe.scrub.rects_for)
        assert applied
        for i, ds in enumerate(datasets):
            if i in applied:
                np.testing.assert_array_equal(ds.pixels, numpy_blank(before[i], applied[i]))
            elif before[i] is not None:
                np.testing.assert_array_equal(ds.pixels, before[i])

    def test_default_needs_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            ScrubFarm()
        with pytest.raises(RuntimeError, match="CUDA"):
            ElasticFarmController()
        with pytest.raises(RuntimeError, match="CUDA"):
            ScrubFarm(["cuda:0"])

    def test_empty_device_list_is_refused(self):
        with pytest.raises(ValueError):
            ScrubFarm([])


class TestElasticController:
    def test_resize_shrink_grow_and_device_failure(self):
        imgs, rl = _batch()
        ref = _blank(imgs, rl)
        c = ElasticFarmController([CPU] * 8)
        f4 = c.reconcile(4)
        assert c.active == 4 and c.members == [0, 1, 2, 3]
        np.testing.assert_array_equal(f4.scrub_batch(imgs, rl), ref)
        c.reconcile(8)
        assert c.active == 8
        c.mark_failed(3)  # the active farm holds it: rebuilt at once
        assert c.active == 7 and 3 not in c.members
        f_after = c.reconcile(8)
        assert c.active == 7 and c.rebuilds == 3
        np.testing.assert_array_equal(f_after.scrub_batch(imgs, rl), ref)
        assert [e.kind for e in c.events] == ["resize", "resize", "device-failure", "resize"]

    def test_no_rebuild_when_stable(self):
        c = ElasticFarmController([CPU] * 2)
        farm = c.reconcile(4)
        assert c.active == 2
        assert farm is c.reconcile(4) and c.rebuilds == 1

    def test_failure_outside_the_active_farm_keeps_it(self):
        c = ElasticFarmController([CPU] * 4)
        farm = c.reconcile(2)
        c.mark_failed(3)
        assert c.reconcile(2) is farm and c.rebuilds == 1
        c.mark_failed(1)
        assert c.reconcile(2) is not farm and c.members == [0, 2]

    def test_repeated_entries_are_told_apart_by_index(self):
        """A pool naming one device twice: failing entry 0 must rebuild,
        although the device it names is still in the healthy list."""
        c = ElasticFarmController([CPU, CPU])
        farm = c.reconcile(1)
        assert c.members == [0]
        c.mark_failed(0)
        assert c.reconcile(1) is not farm and c.members == [1]

    def test_total_pool_loss_alerts_and_keeps_a_farm(self):
        c = ElasticFarmController([CPU])
        c.reconcile(1)
        c.mark_failed(0)
        kinds = [e.kind for e in c.events]
        assert "device-failure" in kinds and "alert" in kinds
        assert c.reconcile(4) is not None

    def test_total_pool_loss_before_any_farm(self):
        c = ElasticFarmController([CPU] * 2)
        c.mark_failed(0)
        c.mark_failed(1)
        farm = c.reconcile(2)
        assert farm is not None and farm.n == 1
        assert [e.kind for e in c.events][-1] == "alert"


# ------------------------------------------------------------- examples
def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _counts(text: str):
    """Printed lines with the fields that name one package's bytes masked:
    digests, fingerprints and etag-keyed ids (hex runs), and the result
    lake's stored sizes (pickles name their module)."""
    out = []
    for line in text.splitlines():
        if line.startswith("farm:"):
            continue  # names each farm's design: a shard_map mesh, shards per card
        line = re.sub(r"[0-9a-f]{12,}…?", "<hex>", line)
        line = re.sub(r"\d+ B (in|out)", r"<bytes> \1", line)
        out.append(line)
    return out


def test_quickstart_twin_manifest_equals_reference(tmp_path, monkeypatch, capsys):
    from repro.queueing import Journal as JaxJournal
    from repro_torch.queueing import Journal

    twin = _load(ROOT / "examples" / "quickstart_torch.py", "quickstart_torch")
    twin.main(["--device", "cpu", "--journal", str(tmp_path / "torch.jsonl")])
    twin.main(["--device", "cpu", "--journal", str(tmp_path / "torch.jsonl")])  # fresh again
    port_out = capsys.readouterr().out
    # the JAX example writes a fixed journal path; point it at tmp_path
    jax = _load(ROOT / "examples" / "quickstart.py", "quickstart_jax")
    monkeypatch.setattr(jax, "Journal", lambda _path: JaxJournal(tmp_path / "jax.jsonl"))
    jax.main()
    jax_out = capsys.readouterr().out
    a = Journal(tmp_path / "torch.jsonl").merged_manifest("IRB-60001")
    b = JaxJournal(tmp_path / "jax.jsonl").merged_manifest("IRB-60001")
    assert a.counts() == b.counts() and a.counts()["anonymized"] == 3
    assert [e.to_dict() for e in a.entries] == [e.to_dict() for e in b.entries]
    port_lines = [ln for ln in port_out.splitlines() if not ln.startswith("PHI-free")]
    assert port_lines[: len(port_lines) // 2] == port_lines[len(port_lines) // 2:]
    assert port_lines[: len(port_lines) // 2] == [
        ln for ln in jax_out.splitlines() if not ln.startswith("PHI-free")]


def test_deid_at_scale_twin_counts_equal_reference(tmp_path, monkeypatch, capsys):
    twin = _load(ROOT / "examples" / "deid_at_scale_torch.py", "deid_at_scale_torch")
    twin.main(["--studies", "4", "--slo", "--audit", "--device", "cpu",
               "--journal", str(tmp_path / "torch.jsonl")])
    port_out = capsys.readouterr().out
    jax = _load(ROOT / "examples" / "deid_at_scale.py", "deid_at_scale_jax")
    monkeypatch.setattr(sys, "argv", ["deid_at_scale.py", "--studies", "4", "--slo", "--audit",
                                      "--journal", str(tmp_path / "jax.jsonl")])
    jax.main()
    jax_out = capsys.readouterr().out
    assert "burn signal bought" in port_out and "tamper check" in port_out
    assert _counts(port_out) == _counts(jax_out)


@pytest.mark.parametrize("twin", ["quickstart_torch", "deid_at_scale_torch"])
def test_example_twin_default_device_needs_cuda(tmp_path, monkeypatch, twin):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = _load(ROOT / "examples" / f"{twin}.py", twin)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(["--journal", str(tmp_path / "j.jsonl")])
    assert not (tmp_path / "j.jsonl").exists()
