"""The benchmark's own files against the rules of its format, on the CPU.

Nothing here needs a card: a cell is driven at a tiny size with the
harness's look for a card skipped (``require_card=False``).
"""
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from portbench import harness, yardstick  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
TINY_CT = {"config": {"slices_per_study": 24,
                      "catalog": {"accessions": 4, "instances_per_accession": 512, "block_rows": 512,
                                  "columns": 11}},
           "traffic": {"payload_sample_block": 8}}


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert bench["paths"] == ["portbench"] and bench["command"] == ["python3", "portbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["chips"] in (1, 4)
    for c in bench["configs"]:
        assert LINE.match(c["why"]) and LINE.match(c["source"]) and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank", "_size")), key
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in bench["per_layer"]:
        assert LINE.match(m["layer"])


def test_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_resolves_its_files(bench):
    here = ROOT / "portbench"
    for c in bench["configs"]:
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    for w in bench["workloads"]:
        wl, config, traffic = harness.resolve(bench, w["name"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert (here / "drivers" / f"{traffic['driver']}.py").is_file()
    for m in bench["per_layer"]:
        assert (here / "metrics" / f"{m['name']}.py").is_file()


def test_every_metric_moves_one_that_its_cells_report(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert "workloads" not in moved or cell in moved["workloads"]
    for cell in cells:
        reported = [m for m in harness.end_to_end_metrics(bench, cell) if m["name"] != "setup_s"]
        assert reported and harness.per_layer_metrics(bench, cell)


def test_staged_cells_resolve_their_files():
    """A staged cell comes back by entries in BENCHMARK.json alone: its
    traffic, driver and metric readers are in place."""
    from portbench_staged import STAGED, bench as staged_bench

    b = staged_bench()
    for name in STAGED:
        wl, config, traffic = harness.resolve(b, name)
        assert (ROOT / "portbench" / "drivers" / f"{traffic['driver']}.py").is_file()
        for m in harness.per_layer_metrics(b, name):
            assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        assert [m["name"] for m in harness.end_to_end_metrics(b, name)] == ["setup_s", "deid_MB_per_s"]


def test_train_flops_frozen_copy():
    cfg = json.loads((ROOT / "portbench/configs/qwen2-0.5b.json").read_text())
    flops = yardstick.train_flops(cfg, 8, 1024)["model_flops"]
    assert flops == 25362570412032  # 6 x 493,961,216 x 8192 + 3 x 361,129,574,400
    assert f"{flops:.3e}" == "2.536e+13"
    assert yardstick.matmul_params(cfg) == 493961216


def test_result_line_has_its_keys():
    out = harness.run_cell("ct_request.scrub", 2**31 + 11, 0.5, False, t_start=time.perf_counter(),
                           device="cpu", require_card=False, overrides=TINY_CT, check_imports=False)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "deid_MB_per_s"}
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


def _python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})


def test_nothing_of_jax_is_loaded():
    """A run's process, after the harness, the drivers and the references
    are loaded and a tiny cell has run, holds no module whose whole
    top-level name is jax, jaxlib, flax or repro; the references load
    nothing of the port."""
    code = f"""
import sys, time
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
import portbench.reference.deid, portbench.reference.qwen2
assert not [m for m in sys.modules if m.split('.')[0] == 'repro_torch'], 'reference loads the port'
from portbench import harness
for d in ('deid_service', 'serve', 'lm'):
    harness.load_module(harness.HERE / 'drivers' / (d + '.py'), 'x_' + d)
harness.run_cell('ct_request.scrub', 5, 0.3, False, t_start=time.perf_counter(), device='cpu',
                 require_card=False, overrides=__import__('json').loads({json.dumps(TINY_CT)!r}))
print(harness.forbidden_modules())
"""
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_refuses_without_a_card():
    """Without CUDA the benchmark prints no result and exits non-zero."""
    proc = _python("import torch; print(torch.cuda.is_available())")
    if proc.stdout.strip() != "False":
        pytest.skip("a card is present: the refusal is not reachable here")
    run = subprocess.run([sys.executable, "portbench/run.py", "--workload", "ct_request.scrub", "--seed",
                          "3", "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode != 0 and run.stdout.strip() == ""
    assert "no CUDA device" in run.stderr
