"""Cells whose files the benchmark holds but ``BENCHMARK.json`` does not
list (their runs on the card spread wider than a bound may be; see
PERF.md): tests drive them from a copy of ``BENCHMARK.json`` with them and
their metrics added."""
import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
STAGED = {"ct_request.cold": {
    "workload": {"name": "ct_request.cold", "config": "ct_request", "traffic": "cold", "chips": 1,
                 "why": "closed loop of 2-study CT queries, one queued ahead, recompression on"},
    "listed": ("deid_MB_per_s", "submit_ms.deid", "device_idle_pct.deid"),
    "per_layer": [
        {"name": "entropy_code_share_pct.deid", "unit": "%", "better": "lower",
         "source": "program_span", "layer": "core/batch host entropy tail",
         "moves": "deid_MB_per_s", "workloads": ["ct_request.cold"]},
        {"name": "deid_roofline_pct", "unit": "%", "better": "higher", "source": "device_trace",
         "layer": "kernels (csrc/*.cu)", "moves": "deid_MB_per_s",
         "workloads": ["ct_request.cold"]}]}}


def bench() -> dict:
    """``BENCHMARK.json`` with the staged cells and their metrics added."""
    b = copy.deepcopy(json.loads((ROOT / "BENCHMARK.json").read_text()))
    names = {w["name"] for w in b["workloads"]}
    for name, staged in STAGED.items():
        if name in names:
            continue
        b["workloads"].append(staged["workload"])
        for m in b["end_to_end"] + b["per_layer"]:
            if m["name"] in staged["listed"] and "workloads" in m:
                m["workloads"].append(name)
        b["per_layer"].extend(copy.deepcopy(staged["per_layer"]))
    return b
