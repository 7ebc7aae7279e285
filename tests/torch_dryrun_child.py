"""Jobs of ``tests/test_torch_dryrun.py`` that need a fake world: run as
``python tests/torch_dryrun_child.py WORLD JOB [JOB ...]`` (PYTHONPATH=src),
each job's result printed as one JSON line ``{"job": ..., "result": ...}``.
A process holds one world, so a test starts one child a world. Imports
nothing of JAX."""
from __future__ import annotations

import json
import sys

import torch

from repro_torch.config import ShapeConfig, get_arch
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import OpTrace, analyze_trace, top_collectives
from repro_torch.launch.mesh import make_mesh, make_production_mesh

SMALL = {"train": ShapeConfig("train", 128, 2, "train"), "prefill": ShapeConfig("prefill", 128, 2, "prefill"),
         "decode": ShapeConfig("decode", 128, 2, "decode")}
REDUCED = {"dense": "qwen2-0.5b", "moe": "olmoe-1b-7b", "ssm": "falcon-mamba-7b"}


def synthetic(axis: str) -> dict:
    """24 x (a 16x128 @ 128x128 matmul + an all-reduce of it over ``axis``
    of the production mesh): the reference's SYNTHETIC_HLO, unrolled."""
    import torch.distributed._functional_collectives as funcol

    mesh = make_production_mesh(multi_pod=axis == "pod", device_type="cpu")
    x = torch.empty(16, 128, device="meta")
    w = torch.empty(128, 128, device="meta")
    with OpTrace("meta") as trace:
        for _ in range(24):
            d = x @ w
            x = funcol.wait_tensor(funcol.all_reduce(d, "sum", (mesh, mesh.mesh_dim_names.index(axis))))
    out = analyze_trace(trace)
    out["top"] = top_collectives(trace)
    return out


def flops(family: str, kind: str) -> float:
    """The traced FLOPs of a reduced model's step on a world of one."""
    cfg = get_arch(REDUCED[family]).reduced()
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    return dryrun.trace_cell(cfg, SMALL[kind], mesh)["program_flops"]


def peak_pair() -> dict:
    """A reduced qwen2 train step on a world of one: the dry-run's traced
    temporaries (meta tensors) and ``OpTrace``'s peak over the same step
    on real tensors (weights placed from seed 0, the same AdamW state), the
    second of two."""
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.act_sharding import activation_sharding
    from repro_torch.models import build_model
    from repro_torch.training import cosine_schedule, make_train_step, train_state_init

    cfg = get_arch("qwen2-0.5b").reduced()
    shape = ShapeConfig("train", 64, 2, "train")
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    traced = dryrun.trace_cell(cfg, shape, mesh)
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    model = sh.place_model(model, sh.param_shardings(model, mesh))
    state = train_state_init(model)
    step = make_train_step(model, cosine_schedule(3e-4, 100, 10000))
    # the batch laid out before the step, as the dry-run's arguments are
    batch = {k: model._input(torch.zeros(v.shape, dtype=v.dtype)) for k, v in model.input_specs(shape).items()}
    with activation_sharding(sh.activation_rules(mesh, shape, cfg)):
        # a step first: DTensor makes host index tensors once per layout it
        # meets, and the traced step is a steady one
        state, _ = step(state, batch)
        trace = OpTrace()
        with trace:
            step(state, batch)
    return {"traced": traced["temp_size_in_bytes"], "real": trace.peak,
            "traced_flops": traced["program_flops"], "real_flops": analyze_trace(trace)["flops"]}


def comms(kind: str) -> dict:
    """A reduced qwen2 step's collectives on (data 1, model 4): count and
    bytes by kind, as the dry-run traces them."""
    cfg = get_arch("qwen2-0.5b").reduced()
    shape = {"decode": ShapeConfig("decode", 16, 4, "decode"), "train": ShapeConfig("train", 16, 4, "train")}[kind]
    out = dryrun.trace_cell(cfg, shape, make_mesh((1, 4), ("data", "model"), "cpu"))
    return {"counts": out["collective_counts"], "bytes": out["collectives"]}


if __name__ == "__main__":
    dryrun.start_world(int(sys.argv[1]))
    for job in sys.argv[2:]:
        name, *args = job.split(":")
        print(json.dumps({"job": job, "result": globals()[name](*args)}), flush=True)
