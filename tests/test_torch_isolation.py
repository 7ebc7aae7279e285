"""The port stands alone: importing every module of ``repro_torch`` loads
neither JAX nor any module of the JAX package ``repro``, no source of the
port, ``chip_smoke.py``, ``kernel_ab.py`` or an example twin
(``examples/*_torch.py``) imports them, not even inside a function, and
the default device is the card (an error without CUDA), never a silent CPU
fallback."""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(len(names))
print(",".join(bad))
"""


def test_importing_every_module_loads_no_jax_and_no_repro():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True, check=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"},
    )
    n_modules, bad = out.stdout.split("\n")[:2]
    assert int(n_modules) >= 95
    assert bad == ""


_FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)|from\s+repro\b(?!_))",
                        re.MULTILINE)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py",
                                      ROOT / "kernel_ab.py",
                                      *(ROOT / "examples").glob("*_torch.py")]))
def test_no_source_imports_jax_or_repro(path):
    text = (ROOT / path).read_text()
    assert not _FORBIDDEN.findall(text), path


def test_every_kernel_source_names_the_tpu_kernel_it_replaces():
    for cu in ("scrub.cu", "fused.cu", "entropy.cu", "textdetect.cu", "phi_detect.cu",
               "bitmap.cu", "jls.cu"):
        text = (PORT / "csrc" / cu).read_text()
        assert "Replaces" in text and "src/repro/kernels/" in text and "Bound" in text


def test_example_twins_are_scanned():
    twins = sorted(p.name for p in (ROOT / "examples").glob("*_torch.py"))
    assert twins == ["deid_at_scale_torch.py", "deid_to_training_torch.py", "quickstart_torch.py",
                     "serve_lm_torch.py", "train_lm_torch.py"]


def test_resolve_device():
    from repro_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None) == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


def test_package_lists_its_modules():
    import repro_torch

    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    for needed in ("repro_torch.core.batch", "repro_torch.core.pipeline",
                   "repro_torch.kernels.fused.ops", "repro_torch.kernels.jls.entropy",
                   "repro_torch.kernels.scrub.ops", "repro_torch.carry", "repro_torch.device",
                   "repro_torch.kernels.textdetect.ops", "repro_torch.kernels.textdetect.ref",
                   "repro_torch.kernels.phi_detect.ops", "repro_torch.kernels.phi_detect.ref",
                   "repro_torch.detect.regions",
                   "repro_torch.kernels.bitmap.ops", "repro_torch.kernels.bitmap.ref",
                   "repro_torch.catalog.catalog", "repro_torch.catalog.columns",
                   "repro_torch.catalog.query", "repro_torch.lake.planner",
                   "repro_torch.lake.records", "repro_torch.lake.store",
                   "repro_torch.queueing.autoscaler", "repro_torch.queueing.broker",
                   "repro_torch.queueing.journal", "repro_torch.queueing.server",
                   "repro_torch.queueing.worker", "repro_torch.storage.object_store",
                   "repro_torch.audit.ledger", "repro_torch.utils.bytesize",
                   "repro_torch.utils.logging", "repro_torch.utils.timing",
                   "repro_torch.utils.wal",
                   "repro_torch.kernels.jls.ops", "repro_torch.kernels.jls.ref",
                   "repro_torch.obs.export", "repro_torch.obs.slo", "repro_torch.obs.profile",
                   "repro_torch.obs.health", "repro_torch.audit.report",
                   "repro_torch.launch.deid_service", "repro_torch.sim.events",
                   "repro_torch.ingest.checkpoint", "repro_torch.ingest.feed",
                   "repro_torch.ingest.pooler", "repro_torch.core.scenarios",
                   "repro_torch.sim.traffic", "repro_torch.sim.chaos",
                   "repro_torch.sim.invariants", "repro_torch.sim.harness",
                   "repro_torch.distributed.scrub_farm", "repro_torch.distributed.elastic",
                   "repro_torch.config.model", "repro_torch.config.registry",
                   *(f"repro_torch.configs.{m}" for m in (
                       "qwen1_5_110b", "qwen2_0_5b", "glm4_9b", "h2o_danube_1_8b", "mixtral_8x22b",
                       "olmoe_1b_7b", "llava_next_34b", "zamba2_2_7b", "hubert_xlarge",
                       "falcon_mamba_7b")),
                   "repro_torch.models.spec", "repro_torch.models.layers",
                   "repro_torch.models.attention", "repro_torch.models.moe",
                   "repro_torch.models.ssm", "repro_torch.models.blocks",
                   "repro_torch.models.model", "repro_torch.serving.engine",
                   "repro_torch.launch.serve",
                   "repro_torch.distributed.compression", "repro_torch.training",
                   "repro_torch.training.optimizer", "repro_torch.training.data",
                   "repro_torch.training.checkpoint", "repro_torch.training.train_step",
                   "repro_torch.launch.train"):
        assert needed in names
