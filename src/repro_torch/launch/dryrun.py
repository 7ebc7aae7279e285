"""Multi-pod dry-run: every (architecture x input shape x mesh) cell traced
on a fake world of 256 or 512 ranks, with nothing allocated.

For a cell: a ``fake`` process group of the mesh's size (this process is
rank 0), the production mesh on it, the model's parameters (and for a
train cell its AdamW state, for a decode cell its cache) as DTensors laid
out by the sharding rules over meta local tensors, and one step (the
sharded train step, a prefill or a decode step) run under the activation
rules and traced op by op (``launch/hlo_analysis.OpTrace``): memory (the
rank's arguments, outputs and the peak of its temporaries), FLOPs, bytes
and collective bytes by kind with cross-pod attribution, and a roofline
from ``launch/hw``, into a JSON record a cell.

The local tensors are meta tensors, not ``FakeTensorMode`` tensors: DTensor
propagates the sharding of a flattened batch-and-sequence gradient through
index tensors that a fake tensor cannot read, and a meta op costs a tenth
of a fake one. The mesh's device type is ``--device``'s, as a run on the
cards would have it.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # every cell, both meshes

``--device`` defaults to ``cuda`` (and raises where CUDA is absent); pass
``--device cpu`` to trace on a CPU-only host. Nothing here runs at import.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config.model import SHAPES, ModelConfig, ShapeConfig, cell_runnable
from repro_torch.config.registry import get_arch, list_archs
from repro_torch.launch import hw

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
CELL_TIMEOUT_S = 3000
MESHES = ("single", "multi")


# ----------------------------------------------------------------- world
def start_world(world: int) -> None:
    """A ``fake`` process group of ``world`` ranks, this process rank 0
    (collectives return at once; only shapes and groups are real)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a world of {dist.get_world_size()} ranks is up; this cell needs {world}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _check_device(device: str) -> str:
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but CUDA is not available; pass --device cpu")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return device


# ---------------------------------------------------------- abstract state
def _abstract_train_state(model):
    """The TrainState of ``model`` as meta tensors: bf16 parameters, f32
    AdamW moments and master copy, an int32 step, no compression."""
    from repro_torch.models.spec import tree_map
    from repro_torch.training.optimizer import AdamWState
    from repro_torch.training.train_step import TrainState

    params = model.abstract_params()
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")
    opt = AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                     m=tree_map(f32, params), v=tree_map(f32, params), master=tree_map(f32, params))
    return TrainState(params=params, opt=opt, comp=None)


def _placed(abstract: torch.Tensor, sharding):
    """A DTensor of ``abstract``'s shape and dtype laid out by ``sharding``
    (a ``NamedSharding``) over a meta local tensor: this rank's block."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.act_sharding import local_block

    placements = sharding.placements()
    local, _ = local_block(abstract.shape, sharding.mesh, placements)
    return DTensor.from_local(torch.empty(local, dtype=abstract.dtype, device="meta"), sharding.mesh,
                              placements, run_check=False, shape=abstract.shape, stride=abstract.stride())


def _place_tree(abstract, shardings):
    from repro_torch.models.spec import tree_items

    flat = dict(tree_items(shardings))
    out: Dict[str, Any] = {}
    for path, leaf in tree_items(abstract):
        node = out
        *head, last = path.split(".")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = _placed(leaf, flat[path])
    return out


def _place_model(model, shardings):
    """``model``'s parameters as meta-backed DTensors laid out by
    ``shardings`` (``place_model`` without drawing a weight)."""
    from repro_torch.launch.shardings import _set_param
    from repro_torch.models.spec import tree_items

    placed = dict(tree_items(_place_tree(model.abstract_params(), shardings)))
    mesh = None
    for path, param in list(model.named_parameters()):
        _set_param(model, path, placed[path], param.requires_grad)
        mesh = placed[path].device_mesh
    model.mesh = mesh
    return model


def _local_bytes(tree) -> int:
    """Bytes of this rank's blocks of every tensor in ``tree``."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, DTensor):
        return _local_bytes(tree.to_local())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    return 0


# ------------------------------------------------------------------ trace
def _trace_variant(cfg: ModelConfig, shape: ShapeConfig, mesh, *, microbatches: int = 1,
                   fsdp: bool = True) -> Tuple[Any, Dict[str, float]]:
    """Trace one step of (cfg, shape) on ``mesh``: the sharded train step
    for a train cell (state laid out by ``opt_state_shardings``), a prefill,
    or a decode step at the cache's last slot. Returns the ``OpTrace`` and
    the rank's argument and output bytes and the trace's wall seconds."""
    from repro_torch.launch.act_sharding import activation_sharding
    from repro_torch.launch.hlo_analysis import OpTrace
    from repro_torch.launch.shardings import (activation_rules, cache_shardings, input_shardings,
                                              opt_state_shardings, param_shardings)
    from repro_torch.models.model import build_model
    from repro_torch.training import cosine_schedule, make_train_step
    from repro_torch.training.optimizer import AdamWState
    from repro_torch.training.train_step import TrainState

    model = build_model(cfg, "meta")
    in_specs = model.input_specs(shape)
    trace = OpTrace("meta")
    t0 = time.perf_counter()
    with activation_sharding(activation_rules(mesh, shape, cfg)):
        if shape.kind == "train":
            state_abs = _abstract_train_state(model)
            state_sh = opt_state_shardings(model, mesh, state_abs, fsdp=fsdp)
            _place_model(model, state_sh.params)
            opt = AdamWState(step=torch.zeros((), dtype=torch.int32, device="meta"),
                             m=_place_tree(state_abs.opt.m, state_sh.opt.m),
                             v=_place_tree(state_abs.opt.v, state_sh.opt.v),
                             master=_place_tree(state_abs.opt.master, state_sh.opt.master))
            state = TrainState(model.params(), opt, None)
            batch = _place_tree(in_specs, input_shardings(model, mesh, shape, in_specs))
            step = make_train_step(model, cosine_schedule(3e-4, 100, 10000), microbatches=microbatches)
            args = (state, batch)
            with trace:
                out = step(state, batch)
        else:
            _place_model(model, param_shardings(model, mesh, fsdp=fsdp))
            if shape.kind == "prefill":
                batch = _place_tree(in_specs, input_shardings(model, mesh, shape, in_specs))
                args = (model.params(), batch)
                with trace:
                    out = model.prefill(batch)
                if cfg.family == "encoder":
                    out = out[0]
            else:
                sh = input_shardings(model, mesh, shape, in_specs)
                cache = _place_tree(in_specs["cache"], sh["cache"])
                tokens = _placed(in_specs["tokens"], sh["tokens"])
                args = (model.params(), tokens, cache)
                # the reference's abstract pos stands for any slot: the last one
                with trace:
                    out = model.decode_step(tokens, cache, shape.seq_len - 1)
    sizes = {"argument_size_in_bytes": _local_bytes(args), "output_size_in_bytes": _local_bytes(out),
             "trace_s": time.perf_counter() - t0}
    return trace, sizes


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *, microbatches: int = 1,
               fsdp: bool = True) -> Dict[str, Any]:
    """The numbers of (cfg, shape) on ``mesh`` under the record's names,
    traced at full depth: every layer, attention tile and scan chunk runs,
    so nothing is multiplied."""
    from repro_torch.launch.hlo_analysis import analyze_trace, top_collectives

    trace, sizes = _trace_variant(cfg, shape, mesh, microbatches=microbatches, fsdp=fsdp)
    static = analyze_trace(trace)
    out = dict(sizes)
    out["temp_size_in_bytes"] = trace.peak
    out["peak_bytes_per_device"] = sizes["argument_size_in_bytes"] + trace.peak
    out["ops"] = trace.ops
    out["collectives"] = {k: float(v) for k, v in static["coll"].items()}
    out["collective_counts"] = {}
    for (kind, _), (count, _) in trace.collectives.items():
        out["collective_counts"][kind] = out["collective_counts"].get(kind, 0) + int(count)
    out["program_flops"] = static["flops"]
    out["program_bytes"] = static["bytes"]
    out["coll_intra"], out["coll_cross"] = static["coll_intra"], static["coll_cross"]
    out["top_collectives"] = [list(r) for r in top_collectives(trace, 8)]
    return out


def roofline(rec: Dict[str, Any]) -> Dict[str, Any]:
    flops, bts = rec["program_flops"], rec["program_bytes"]
    intra, cross = rec["coll_intra"], rec["coll_cross"]
    return {"compute_s": flops / hw.PEAK_FLOPS_BF16 if flops > 0 else None,
            "memory_s": bts / hw.HBM_BW if bts > 0 else None,
            "collective_s": intra / hw.ICI_BW + cross / hw.DCI_BW,
            "collective_bytes_intra": intra, "collective_bytes_cross_pod": cross}


# ------------------------------------------------------------------ cells
def lower_cell(arch: str, shape_name: str, multi_pod: bool, *, overrides: Optional[dict] = None,
               device: str = "cuda") -> Dict[str, Any]:
    """Trace one cell; returns its record (nothing allocated). Starts the
    fake world of the cell's mesh in this process."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.model import build_model
    from repro_torch.models.spec import param_count

    cfg = get_arch(arch)
    microbatches = 1
    if overrides:
        overrides = dict(overrides)
        microbatches = int(overrides.pop("microbatches", 1))
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    ok, reason = cell_runnable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "skipped", "reason": reason}

    record: Dict[str, Any] = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "n_chips": 512 if multi_pod else 256,
        "params": cfg.param_count() and param_count(build_model(cfg, "meta").param_specs()),
        "active_params": cfg.active_param_count(),
        "overrides": overrides or {},
        "microbatches": microbatches,
        "device": _check_device(device),
    }
    start_world(record["n_chips"])
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
    numbers = trace_cell(cfg, shape, mesh, microbatches=microbatches)
    record.update(numbers)
    record["roofline"] = roofline(record)
    record["status"] = "ok"
    return record


def run_cell_subprocess(arch: str, shape: str, mesh: str, out_dir: Path, timeout: int = CELL_TIMEOUT_S,
                        device: str = "cuda") -> dict:
    """Isolation wrapper: one cell per process (a fresh fake world)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    out_file = out_dir / f"{arch}__{shape}__{mesh}.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
           "--mesh", mesh, "--device", device, "--out", str(out_file)]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[2])
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env)
        if proc.returncode == 0 and out_file.exists():
            return json.loads(out_file.read_text())
        rec = {"arch": arch, "shape": shape, "mesh": mesh, "status": "failed", "error": proc.stderr[-2000:]}
    except subprocess.TimeoutExpired:
        rec = {"arch": arch, "shape": shape, "mesh": mesh, "status": "timeout"}
    out_file.write_text(json.dumps(rec, indent=1))
    return rec


def all_cells():
    """Every (arch, shape, mesh) triple, in the reference's order."""
    return [(arch, shape, mesh) for arch in list_archs() for shape in SHAPES for mesh in MESHES]


def run_all(out_dir: Path = OUT_DIR, device: str = "cuda", jobs: int = 1) -> list:
    """Every cell, one process each (``jobs`` at a time); a cell whose
    record is already ok or skipped is read back, not traced again."""
    def one(cell):
        arch, shape, mesh = cell
        out_file = out_dir / f"{arch}__{shape}__{mesh}.json"
        if out_file.exists():
            rec = json.loads(out_file.read_text())
            if rec.get("status") in ("ok", "skipped"):
                return rec
        rec = run_cell_subprocess(arch, shape, mesh, out_dir, device=device)
        print(f"{arch:18s} {shape:12s} {mesh:6s} -> {rec['status']}", flush=True)
        return rec

    with ThreadPoolExecutor(max_workers=max(jobs, 1)) as pool:
        return list(pool.map(one, all_cells()))


def summary(results: list) -> str:
    bad = [r for r in results if r["status"] not in ("ok", "skipped")]
    return (f"{len(results)} cells: {sum(r['status'] == 'ok' for r in results)} ok, "
            f"{sum(r['status'] == 'skipped' for r in results)} skipped, {len(bad)} failed")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=list(MESHES), default="single")
    ap.add_argument("--all", action="store_true", help="run every cell x both meshes via subprocesses")
    ap.add_argument("--out", default=None)
    ap.add_argument("--override", action="append", default=[], help="cfg override k=v (perf iterations)")
    ap.add_argument("--device", default="cuda", help="the mesh's device type: cuda (default) or cpu")
    ap.add_argument("--jobs", type=int, default=1, help="--all: cells traced at once")
    args = ap.parse_args(argv)

    if args.all:
        results = run_all(OUT_DIR, args.device, args.jobs)
        print(f"\n{summary(results)}")
        sys.exit(1 if any(r["status"] not in ("ok", "skipped") for r in results) else 0)

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v

    try:
        rec = lower_cell(args.arch, args.shape, args.mesh == "multi", overrides=overrides or None,
                         device=args.device)
    except Exception:
        rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "status": "failed", "error": traceback.format_exc()[-4000:]}
    text = json.dumps(rec, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    if rec["status"] == "ok":
        print(f"\n# traced: peak/device = {rec['peak_bytes_per_device'] / 1e9:.2f} GB "
              f"(args {rec['argument_size_in_bytes'] / 1e9:.2f} + temps {rec['temp_size_in_bytes'] / 1e9:.2f})")
        print(f"# op stream: flops/device = {rec['program_flops']:.3e}, bytes = {rec['program_bytes']:.3e}")
    sys.exit(0 if rec["status"] in ("ok", "skipped") else 1)


if __name__ == "__main__":
    main()
