"""The port's training launcher (``python -m repro_torch.launch.train``)
against the JAX package's, and the two training example twins, on the CPU.

Both launchers resume from one checkpoint, the reference's
``train_state_init`` written by the reference's ``CheckpointManager`` at
step 0, and train the reduced qwen2-0.5b on the same synthetic batches.
Tolerances, set beforehand: final loss within 1e-4 (atol and rtol); the
checkpoints they leave hold the same keys, dtypes and steps, and master
weights as ``torch_train.assert_master_close`` says.
"""
import importlib.util
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.config.registry import get_arch as j_get_arch
from repro.launch import train as j_train
from repro.models import build_model as j_build_model
from repro.training import CheckpointManager as JCheckpointManager
from repro.training import train_state_init as j_train_state_init
from repro_torch.launch import train
from torch_train import assert_master_close, one_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2-0.5b"
RUN = ["--arch", ARCH, "--steps", "12", "--batch", "4", "--seq", "32", "--lr", "1e-3",
       "--warmup", "3", "--ckpt-every", "5", "--seed", "3"]


def _start(tmp_path):
    """Checkpoint dirs for both launchers holding the reference's step-0 state."""
    jcfg = j_get_arch(ARCH).reduced()
    jm = j_build_model(jcfg)
    state = jax.jit(lambda k: j_train_state_init(jm, k))(jax.random.PRNGKey(3))
    JCheckpointManager(tmp_path / "jax" / jcfg.name).save(0, state)
    shutil.copytree(tmp_path / "jax", tmp_path / "torch")
    return jcfg.name


def _arrays(path):
    with np.load(path / "arrays.npz") as npz:
        return {k: npz[k] for k in npz.files}


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("launch")
    name = _start(tmp)
    got = train.main([*RUN, "--resume", "--ckpt-dir", str(tmp / "torch"), "--device", "cpu"])
    want = j_train.main([*RUN, "--resume", "--ckpt-dir", str(tmp / "jax")])
    return tmp, name, got, want


def test_final_loss_equals_reference(launched):
    _, _, got, want = launched
    assert got["steps"] == want["steps"] == 12 and got["device"] == "cpu"
    np.testing.assert_allclose(got["final_loss"], want["final_loss"], atol=1e-4, rtol=1e-4)


def test_checkpoints_equal_reference(launched):
    import json

    tmp, name, _, _ = launched
    dirs = {side: tmp / side / name for side in ("torch", "jax")}
    kept = {side: sorted(p.name for p in d.iterdir() if p.name.startswith("step_")) for side, d in dirs.items()}
    assert kept["torch"] == kept["jax"] == ["step_00000005", "step_00000010", "step_00000012"]
    assert (dirs["torch"] / "LATEST").read_text() == (dirs["jax"] / "LATEST").read_text() == "step_00000012"
    for step in kept["jax"]:
        mt = json.loads((dirs["torch"] / step / "meta.json").read_text())
        mj = json.loads((dirs["jax"] / step / "meta.json").read_text())
        assert mt["keys"] == mj["keys"] and mt["dtypes"] == mj["dtypes"]
        assert mt["step"] == mj["step"] and mt["extra"] == mj["extra"] == {"arch": name}
    at, aj = _arrays(dirs["torch"] / "step_00000012"), _arrays(dirs["jax"] / "step_00000012")
    assert at[".opt/.step"] == aj[".opt/.step"] == 12
    lr_sum = 12 * 1e-3
    for key in aj:
        if key.startswith(".opt/.master/"):
            assert_master_close(at[key], aj[key], lr_sum, key)


def test_resume_from_latest_equals_an_uninterrupted_run(tmp_path):
    args = [*RUN[:2], "--steps", "6", "--batch", "2", "--seq", "32", "--ckpt-every", "3", "--device", "cpu"]
    whole = train.main([*args, "--ckpt-dir", str(tmp_path / "a")])
    name = j_get_arch(ARCH).reduced().name
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    cut = tmp_path / "b" / name
    shutil.rmtree(cut / "step_00000006")
    (cut / "LATEST").write_text("step_00000003")
    resumed = train.main([*args, "--ckpt-dir", str(tmp_path / "b"), "--resume"])
    assert resumed["final_loss"] == pytest.approx(whole["final_loss"], rel=1e-6)
    a, b = _arrays(tmp_path / "a" / name / "step_00000006"), _arrays(cut / "step_00000006")
    for key in a:
        np.testing.assert_allclose(a[key].astype(np.float32) if a[key].dtype != np.uint16 else a[key],
                                   b[key].astype(np.float32) if b[key].dtype != np.uint16 else b[key],
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("extra", [["--compression"], ["--microbatches", "2"]])
def test_compression_and_microbatches_run(tmp_path, extra):
    out = train.main(["--arch", ARCH, "--steps", "3", "--batch", "4", "--seq", "32", "--device", "cpu",
                      "--ckpt-dir", str(tmp_path), *extra])
    assert np.isfinite(out["final_loss"])
    meta = (tmp_path / j_get_arch(ARCH).reduced().name / "step_00000003" / "meta.json").read_text()
    assert (".comp/embed/tok/.residual" in meta) == (extra == ["--compression"])


def test_default_device_is_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", ARCH, "--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())  # refused before any work


def test_batch_to_device_keeps_values():
    batch = {"tokens": np.arange(6, dtype=np.int32).reshape(2, 3), "mask": np.array([[True, False]])}
    out = train.batch_to_device(batch, torch.device("cpu"))
    assert out["tokens"].dtype == torch.int32 and out["tokens"].tolist() == batch["tokens"].tolist()
    assert out["mask"].dtype == torch.bool


# ------------------------------------------------------------ example twins
def _example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_lm_twin_runs_on_cpu(tmp_path, capsys):
    out = _example("train_lm_torch").main(["--steps", "20", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert out["final_loss"] < 6.2 and out["device"] == "cpu"
    assert "final loss" in capsys.readouterr().out


def test_deid_to_training_twin_runs_on_cpu(capsys):
    out = _example("deid_to_training_torch").main(["--device", "cpu"])
    assert len(out["delivered"]) == 12 and out["flagged"] == 0
    assert len(out["losses"]) == 20 and out["losses"][-1] < out["losses"][0]
    printed = capsys.readouterr().out
    assert "phi_detect audit: clean" in printed and "de-id -> training integration OK" in printed


def test_deid_to_training_twin_delivers_the_references_pixels():
    """The twin's de-identification, on the CPU, delivers the pixels the
    reference example's pipeline delivers for the same corpus."""
    from repro.core import DeidPipeline as JPipeline, PseudonymService as JPseudo, TrustMode as JTrust
    from repro.core import build_request as j_build_request
    from repro.dicom.generator import StudyGenerator as JGenerator

    gen, pseudo, pipe = JGenerator(11), JPseudo("IRB-IMG", JTrust.POST_IRB, key=b"i" * 32), \
        JPipeline(recompress=False)
    want = []
    for i in range(6):
        s = gen.gen_study(f"IMG{i:03d}", modality="US" if i % 2 else "CT", n_images=2)
        want.extend(pipe.process_study(s, j_build_request(pseudo, s.accession, s.mrn))[0])
    got = _example("deid_to_training_torch").main(["--device", "cpu", "--steps", "3"])["delivered"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g.pixels, w.pixels)
