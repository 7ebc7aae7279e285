"""The port's training step and sequence-sharded decode on a mesh, in a
world of spawned processes, gloo on the CPU or NCCL with one card a rank
(``tests/torch_sharded.py``'s pattern).

``run_world(cases, world, tmp_path)`` runs every case on every rank and
returns ``{rank: {case name: result}}``. A ``train`` case places a reduced
model with FSDP on (``param_shardings(fsdp=True)``, the FSDP size floor
lowered so that the reduced leaves shard too), lays its state out by
``opt_state_shardings``, and takes two steps under
``activation_sharding(activation_rules(...))`` beside the same weights
unsharded; it records both runs' losses, gnorms and master leaves, and the
collectives of the last sharded step. A ``decode`` case places zamba2
reduced with B 1 and a cache sharded along the sequence (``long_500k``'s
layout) and decodes greedily across a shard boundary beside the unsharded
model. Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import traceback
from pathlib import Path

import numpy as np
import torch

FSDP_MIN_ELEMS = 1 << 10


def _placed_pair(cfg, mesh, device, fsdp: bool):
    from repro_torch.launch import shardings as sh
    from repro_torch.models import build_model

    ref = build_model(cfg, device, generator=torch.Generator().manual_seed(0)).float()
    placed = sh.place_model(build_model(cfg, device, generator=torch.Generator().manual_seed(0)).float(),
                            sh.param_shardings(ref, mesh, fsdp=fsdp))
    return ref, placed


def _leaves(tree):
    from repro_torch.models.spec import tree_items

    return dict(tree_items(tree))


def _full(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().float().cpu().numpy()


def _batch(cfg, rng, B: int, S: int) -> dict:
    tokens = rng.integers(0, cfg.vocab_size, (B, S))
    labels = rng.integers(0, cfg.vocab_size, (B, S))
    if cfg.family == "encoder":
        return {"frame_embeds": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
                "mask": rng.random((B, S)) < 0.5, "labels": labels}
    if cfg.family == "vlm":
        return {"tokens": tokens[:, : S // 2], "labels": labels[:, : S // 2],
                "patch_embeds": rng.standard_normal((B, S // 2, cfg.d_model)).astype(np.float32)}
    return {"tokens": tokens, "labels": labels}


def run_train(case: dict, device: torch.device) -> dict:
    """Two steps of the sharded train step beside two of the unsharded one
    from the same f32 weights, written back in f32: the steps' gradients
    and their collectives are f32, so the two runs differ by summation
    order alone."""
    from repro_torch.config import ShapeConfig, get_arch
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.act_sharding import activation_sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import cosine_schedule, make_train_step, train_state_init
    from repro_torch.training import optimizer, train_step

    # the weights written back in f32 (this process only): AdamW's bf16 cast
    # would round the two runs' nearly equal masters apart
    train_step.adamw_update = functools.partial(optimizer.adamw_update, param_dtype=torch.float32)
    cfg = dataclasses.replace(get_arch(case["arch"]).reduced(), **case.get("overrides", {}))
    mesh = make_mesh(case["mesh"], ("data", "model"), device.type)
    floor, sh._FSDP_MIN_ELEMS = sh._FSDP_MIN_ELEMS, FSDP_MIN_ELEMS
    try:
        ref, placed = _placed_pair(cfg, mesh, device, fsdp=True)
    finally:
        sh._FSDP_MIN_ELEMS = floor
    comp = case.get("compression", False)
    state = train_state_init(placed, compression=comp)
    ref_state = train_state_init(ref, compression=comp)
    floor, sh._FSDP_MIN_ELEMS = sh._FSDP_MIN_ELEMS, FSDP_MIN_ELEMS
    try:
        layout = sh.opt_state_shardings(placed, mesh, state)
    finally:
        sh._FSDP_MIN_ELEMS = floor
    pairs = [(state.params, layout.params), (state.opt.m, layout.opt.m), (state.opt.v, layout.opt.v),
             (state.opt.master, layout.opt.master)]
    if comp:
        pairs.append(({k: c.residual for k, c in _leaves(state.comp).items()},
                      {k: c.residual for k, c in _leaves(layout.comp).items()}))
    out = {"laid_out": all(tuple(t.placements) == _leaves(shards)[path].placements()
                           for tree, shards in pairs for path, t in _leaves(tree).items()),
           "fsdp_leaves": sorted(p for p, s in _leaves(layout.params).items()
                                 if "data" in str(s.spec))}
    sched = cosine_schedule(1e-3, 0, 10)
    step = make_train_step(placed, sched, microbatches=case.get("microbatches", 1), compression=comp)
    ref_step = make_train_step(ref, sched, microbatches=case.get("ref_microbatches", 1), compression=comp)
    B, S = case.get("batch", (4, 16))
    shape = ShapeConfig("train", S, B, "train")
    batches = [_batch(cfg, np.random.default_rng(7 + i), B, S) for i in range(2)]
    got, want = [], []
    with activation_sharding(sh.activation_rules(mesh, shape, cfg)):
        for batch in batches:
            state, m = step(state, batch)
            got.append({k: float(v) for k, v in m.items()})
            out["metric_types"] = sorted({type(v).__name__ for v in m.values()})
    for batch in batches:
        ref_state, m = ref_step(ref_state, batch)
        want.append({k: float(v) for k, v in m.items()})
    out["metrics"], out["ref_metrics"] = got, want
    out["lr_sum"] = sum(m["lr"] for m in want)
    out["master"] = {p: _full(t) for p, t in _leaves(state.opt.master).items()}
    out["ref_master"] = {p: _full(t) for p, t in _leaves(ref_state.opt.master).items()}
    out["master_placements"] = {p: str(tuple(t.placements)) for p, t in _leaves(state.opt.master).items()}
    out["param_placements"] = {p: str(tuple(t.placements)) for p, t in _leaves(state.params).items()}
    return out


def run_comms(case: dict, device: torch.device) -> dict:
    """The collectives (``CollectiveLog.calls``) of one real step of reduced
    qwen2-0.5b on (data 1, model 4), set up as ``launch/dryrun.py`` traces
    it: weights placed by ``param_shardings`` (FSDP on), a decode step at
    the last slot of a cache placed by ``cache_shardings``, or a train step
    from ``train_state_init``."""
    from repro_torch.config import ShapeConfig, get_arch
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.act_sharding import activation_sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.training import cosine_schedule, make_train_step, train_state_init

    cfg = get_arch("qwen2-0.5b").reduced()
    mesh = make_mesh((1, 4), ("data", "model"), device.type)
    model = build_model(cfg, device, generator=torch.Generator().manual_seed(0))
    model = sh.place_model(model, sh.param_shardings(model, mesh))
    shape = ShapeConfig(case["step"], 16, 4, case["step"])
    log = sh.CollectiveLog()
    with activation_sharding(sh.activation_rules(mesh, shape, cfg)):
        if case["step"] == "decode":
            cache = model.init_cache(4, 16)
            tokens = np.zeros(4, np.int64)
            with log:
                model.decode_step(tokens, cache, 15)
        else:
            state = train_state_init(model)
            step = make_train_step(model, cosine_schedule(3e-4, 100, 10000))
            batch = {"tokens": np.zeros((4, 16), np.int64), "labels": np.zeros((4, 16), np.int64)}
            with log:
                step(state, batch)
    return {"calls": log.calls}


def _worker(rank: int, world: int, backend: str, init: str, cases: dict, out_dir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    device = torch.device("cpu")
    if backend == "nccl":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    dist.init_process_group(backend, init_method=f"file://{init}", rank=rank, world_size=world)
    results = {}
    try:
        for name, case in cases.items():
            try:
                fn = {"train": run_train, "decode": run_decode, "comms": run_comms}[case["kind"]]
                results[name] = fn(case, device)
            except Exception:
                results[name] = {"error": traceback.format_exc()}
    finally:
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()


def run_decode(case: dict, device: torch.device) -> dict:
    """Greedy decode from an empty cache of ``case["cache"]`` slots, B 1,
    the cache laid out as ``long_500k``'s (its sequence sharded over the
    data axis), beside the same weights unsharded fed the same tokens."""
    from repro_torch.config import ShapeConfig, get_arch
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.act_sharding import activation_sharding
    from repro_torch.launch.mesh import make_mesh

    cfg = dataclasses.replace(get_arch(case["arch"]).reduced(), **case.get("overrides", {}))
    mesh = make_mesh(case["mesh"], ("data", "model"), device.type)
    ref, placed = _placed_pair(cfg, mesh, device, fsdp=False)
    S = case["cache"]
    shape = ShapeConfig("long_500k", S, 1, "decode")
    tok = np.array([int(np.random.default_rng(9).integers(1, cfg.vocab_size))])
    out = {"errs": [], "tokens": [], "ref_tokens": []}
    with activation_sharding(sh.activation_rules(mesh, shape, cfg)):
        cache = placed.init_cache(1, S)
        out["cache_placements"] = {k: str(tuple(v.placements)) for k, v in cache.items()}
        ref_cache = ref.init_cache(1, S)
        for pos in range(case["steps"]):
            got, cache = placed.decode_step(tok, cache, pos)
            want, ref_cache = ref.decode_step(tok, ref_cache, pos)
            g = _full(got)
            out["errs"].append(float(np.abs(g - want.float().numpy()).max()))
            out["tokens"].append(int(g.argmax(-1)[0]))
            out["ref_tokens"].append(int(want.argmax(-1)[0]))
            tok = g.argmax(-1)
        out["k_err"] = float(np.abs(_full(cache["k"]) - ref_cache["k"].float().numpy()).max())
    return out


def run_world(cases: dict, world: int, tmp_path: Path, backend: str = "gloo") -> dict:
    import torch.multiprocessing as mp

    mp.spawn(_worker, args=(world, backend, str(tmp_path / "init"), cases, str(tmp_path)), nprocs=world)
    return {r: torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)}
