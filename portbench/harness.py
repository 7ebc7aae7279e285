"""The harness: one run of one cell, driven by ``BENCHMARK.json``.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<cell>.json``); the traffic names its driver
(``drivers/<driver>.py``), and each per-layer metric has a reader
(``metrics/<metric>.py``). A driver has three phases, which the harness
calls in order:

* ``setup(cell)`` builds the system under test and its inputs from the
  seed, warms up every shape the cell's traffic uses and, where the check
  needs it, drives the timed call through its first steps; it returns the
  driver's state;
* ``measure(cell, state)`` runs the window of ``cell.seconds`` and fills
  ``cell.e2e`` (end-to-end metrics) and ``cell.layer`` (what the per-layer
  readers read);
* ``check(cell, state)`` runs after the window, once the device's peak
  memory has been read and the program's state freed: it holds what the
  timed path produced against the plain reference and appends each number
  compared, with its limit, to ``cell.checks``.

With ``--trace 1`` the window runs under ``torch.profiler`` (device
activity only); the harness reduces the trace to busy seconds, kernel times
by name and the idle gaps, each gap named by the innermost host span that
covers it (the benchmark's own spans and the pipeline's wall-clock spans).
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "BENCHMARK.json"
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(RuntimeError):
    """The run cannot be made here (no card, too few cards, a module it
    must not load); it prints no result."""


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


class WallClock:
    """The host clock the pipeline's tracer stamps its spans with."""

    def now(self) -> float:
        return time.perf_counter()


class Cell:
    """One run of one cell: its parameters in, its readings out."""

    def __init__(self, workload: dict, config: dict, traffic: dict, seed: int, seconds: float,
                 trace: bool, device: str) -> None:
        self.workload, self.config, self.traffic = workload, config, traffic
        self.name = workload["name"]
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = torch.device(device)
        self.e2e: Dict[str, float] = {}
        self.layer: Dict[str, Any] = {}
        self.checks: List[tuple] = []
        self.attempted = 0
        self.failed = 0
        self.spans: List[tuple] = []       # (name, t0, t1) on the host clock
        self.clock = WallClock()
        self.window = (0.0, 0.0)           # the measured window, host clock
        self.traced = None                 # Trace of the window (--trace 1)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))

    def check(self, name: str, value: float, limit: float) -> None:
        """One number compared: correct while ``value <= limit``."""
        self.checks.append((name, float(value), float(limit)))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class Trace:
    """Device activity of the window from ``torch.profiler``."""

    def __init__(self, cell: Cell) -> None:
        self.cell = cell
        self.prof = None
        self.kernels: List[tuple] = []     # (name, start_s, end_s) on the host clock
        self.copies: List[tuple] = []
        self.offset = 0.0

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        # a marker kernel right after a synchronize ties the trace's clock
        # to the host clock
        self.cell.sync()
        self.t_mark = time.perf_counter()
        torch.cuda._sleep(1000)
        self.cell.sync()
        return self

    def __exit__(self, *exc):
        self.cell.sync()
        self.prof.__exit__(*exc)
        events = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            events.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        events.sort(key=lambda e: e[1])
        if not events:
            raise RuntimeError("the profiler recorded no device activity")
        k = next(i for i, e in enumerate(events) if "sleep" in e[0].lower() or "spin" in e[0].lower())
        self.offset = self.t_mark - events[k][1] * 1e-9
        for name, s, t in events[:k] + events[k + 1:]:
            rec = (name, s * 1e-9 + self.offset, t * 1e-9 + self.offset)
            (self.copies if name.lower().startswith("memcpy") or name.lower().startswith("memset")
             else self.kernels).append(rec)
        return False

    def busy(self, t0: float, t1: float) -> List[tuple]:
        """Union of device activity (kernels and copies) inside [t0, t1]."""
        iv = sorted((max(s, t0), min(e, t1)) for _, s, e in self.kernels + self.copies
                    if e > t0 and s < t1)
        out: List[list] = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(x) for x in out]

    def kernel_seconds(self, t0: float, t1: float) -> float:
        return sum(min(e, t1) - max(s, t0) for _, s, e in self.kernels if e > t0 and s < t1)

    def by_name(self, t0: float, t1: float) -> List[list]:
        acc: Dict[str, float] = {}
        for n, s, e in self.kernels + self.copies:
            if e > t0 and s < t1:
                acc[n] = acc.get(n, 0.0) + min(e, t1) - max(s, t0)
        return sorted(([n, v] for n, v in acc.items()), key=lambda x: -x[1])


def idle_gaps(busy: List[tuple], t0: float, t1: float, spans: List[tuple]) -> List[list]:
    """Idle stretches of the window, summed by the innermost host span that
    covers each one's midpoint."""
    import numpy as np

    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    if not gaps:
        return []
    g = np.array(gaps)
    order = np.argsort(g.sum(1))
    g = g[order]
    mids = 0.5 * (g[:, 0] + g[:, 1])
    best_len = np.full(len(g), np.inf)
    best = np.full(len(g), -1)
    names = sorted({n for n, _, _ in spans})
    index = {n: i for i, n in enumerate(names)}
    for n, a, b in spans:
        i0, i1 = np.searchsorted(mids, a, "left"), np.searchsorted(mids, b, "right")
        if i0 < i1:
            inner = best_len[i0:i1] > (b - a)
            best_len[i0:i1][inner] = b - a
            best[i0:i1][inner] = index[n]
    acc: Dict[str, float] = {}
    for k, length in zip(best.tolist(), (g[:, 1] - g[:, 0]).tolist()):
        name = names[k] if k >= 0 else "outside any span"
        acc[name] = acc.get(name, 0.0) + length
    return sorted(([n, v] for n, v in acc.items()), key=lambda x: -x[1])


def per_layer_metrics(bench: dict, workload: str) -> List[dict]:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose ``moves`` metric the cell reports."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}

    def reports(metric_name):
        m = e2e[metric_name]
        return "workloads" not in m or workload in m["workloads"]

    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif reports(m["moves"]):
            out.append(m)
    return out


def end_to_end_metrics(bench: dict, workload: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if "workloads" not in m or workload in m["workloads"]]


def resolve(bench: dict, workload: str, overrides: Optional[dict] = None):
    """(workload entry, config dict, traffic dict) of a cell, by name."""
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"unknown workload {workload!r}")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{wl['name']}.json")
    if overrides:
        config = {**config, **overrides.get("config", {})}
        traffic = {**traffic, **overrides.get("traffic", {})}
    return wl, config, traffic


def setup_environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = HERE / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, t_start: float,
             device: str = "cuda:0", require_card: bool = True, overrides: Optional[dict] = None,
             control: bool = False,
             notes: Optional[dict] = None, bench: Optional[dict] = None,
             check_imports: bool = True) -> dict:
    """One run of one cell; returns the result line as a dict. Tests pass
    ``require_card=False`` with a CPU ``device`` and small ``overrides``.
    With ``control`` the driver
    also reads its control (``driver.control``) after the check. ``notes``
    receives what the driver noted beside the numbers compared. Tests may
    pass their own ``bench`` and leave the import check (``check_imports``)
    to a process of its own."""
    bench = load_json(BENCH) if bench is None else bench
    wl, config, traffic = resolve(bench, workload, overrides)
    if require_card:
        if not torch.cuda.is_available():
            raise Refused("no CUDA device: this benchmark measures the card and has no CPU fallback")
        if torch.cuda.device_count() < int(wl["chips"]):
            raise Refused(f"the cell needs {wl['chips']} card(s), {torch.cuda.device_count()} present")
    setup_environment()
    cell = Cell(wl, config, traffic, seed, seconds, trace, device)
    driver = load_module(HERE / "drivers" / f"{traffic['driver']}.py", f"portbench_driver_{traffic['driver']}")

    if cell.device.type == "cuda":
        torch.cuda.set_device(cell.device)
    state = driver.setup(cell)
    # what set-up made stays out of the collector's passes in the window
    gc.collect()
    gc.freeze()
    cell.sync()
    if cell.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(cell.device)
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    if trace:
        with Trace(cell) as tr:
            driver.measure(cell, state)
        cell.traced = tr
    else:
        driver.measure(cell, state)
    cell.sync()
    peak = torch.cuda.max_memory_allocated(cell.device) if cell.device.type == "cuda" else 0
    # the reference runs after the peak is read and the program is freed
    state = driver.release(cell, state)
    gc.unfreeze()
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    driver.check(cell, state)
    if control:
        driver.control(cell, state)
    if notes is not None:
        notes.update(cell.layer.get("notes", {}))

    found = forbidden_modules() if check_imports else []
    if found:
        raise Refused(f"modules of JAX or the JAX package are loaded: {found}")

    correct = bool(cell.checks) and all(v <= lim and math.isfinite(v) for _, v, lim in cell.checks)
    dev = {"platform": "gpu" if cell.device.type == "cuda" else cell.device.type,
           "kind": torch.cuda.get_device_name(cell.device) if cell.device.type == "cuda" else "cpu",
           "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    out: Dict[str, Any] = {"correct": correct, "attempted": int(cell.attempted),
                           "failed": int(cell.failed)}
    metrics: Dict[str, dict] = {}
    if not trace:
        cell.e2e["setup_s"] = setup_s
        for m in end_to_end_metrics(bench, workload):
            if m["name"] in cell.e2e:
                metrics[m["name"]] = {"value": cell.e2e[m["name"]], "unit": m["unit"]}
    else:
        t0, t1 = cell.window
        busy = cell.traced.busy(t0, t1)
        busy_s = sum(e - s for s, e in busy)
        dev["busy_s"] = busy_s
        dev["window_s"] = t1 - t0
        cell.layer["busy_s"], cell.layer["window_s"] = busy_s, t1 - t0
        cell.layer["kernel_s"] = cell.traced.kernel_seconds(t0, t1)
        for m in per_layer_metrics(bench, workload):
            reader = load_module(HERE / "metrics" / f"{m['name']}.py", "portbench_metric")
            value = reader.read(cell)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["breakdown"] = {
            "device_ops": cell.traced.by_name(t0, t1)[:10],
            "idle_gaps": idle_gaps(busy, t0, t1, cell.spans)[:10],
        }
    out["metrics"] = metrics
    out["device"] = dev
    if "breakdown" in out:
        out["breakdown"] = out.pop("breakdown")
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in cell.checks}
    return out


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="one run of one benchmark cell on the card")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter() if t_start is None else t_start
    notes: Dict[str, Any] = {}
    try:
        out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_start,
                       notes=notes)
    except Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    print(f"notes {json.dumps(notes)}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    sys.stdout.flush()
    return 0
