"""The port's LM stack on a mesh, in a world of spawned processes.

``run_world(cases, world, tmp_path)`` spawns ``world`` processes (gloo on
the CPU, or NCCL with one card a rank), which meet through a ``file://``
init method in ``tmp_path`` (no port to race for), run every case and
leave one result file a rank; it returns ``{rank: {case name: result}}``.
A case places a reduced model on a mesh (``param_shardings`` with
fsdp=False, then ``activation_sharding(activation_rules(...))``), holds its
prefill logits and ``ServeEngine`` greedy tokens against the same weights
unsharded, and records the collectives of one decode step. Imports
nothing of JAX, so the card's tests use it too.
"""
from __future__ import annotations

import dataclasses
import os
import traceback
from pathlib import Path

import numpy as np
import torch

PROMPT_LENS = (16, 9, 12, 16)
MAX_NEW = 4


def _batch(cfg, rng, B: int = 4, S: int = 16) -> dict:
    if cfg.family == "encoder":
        return {"frame_embeds": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)}
    if cfg.family == "vlm":
        return {"tokens": rng.integers(0, cfg.vocab_size, (B, S // 2)),
                "patch_embeds": rng.standard_normal((B, S // 2, cfg.d_model)).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}


def _serve(model, prompts) -> list:
    from repro_torch.serving import Request, ServeEngine

    eng = ServeEngine(model, max_batch=len(prompts))
    for i, p in enumerate(prompts):
        eng.submit(Request(f"r{i}", p, max_new_tokens=MAX_NEW))
    return [r.tokens for r in eng.run()]


def run_case(case: dict, device: torch.device) -> dict:
    """One model case on the default process group's world."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.config import ShapeConfig, get_arch
    from repro_torch.launch.act_sharding import activation_sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import (CollectiveLog, activation_rules, gather_model, param_shardings,
                                              place_model)
    from repro_torch.models import build_model
    from repro_torch.models.model import DECODE_GRAPH_MIN_NEW

    cfg = dataclasses.replace(get_arch(case["arch"]).reduced(), **case.get("overrides", {}))
    mesh = make_mesh(case["mesh"], ("data", "model"), device.type)
    if "seed" in case:
        # each rank draws its own shards; the unsharded twin gathers them
        meta = build_model(cfg, "meta")
        placed = place_model(meta, param_shardings(meta, mesh, fsdp=False), seed=case["seed"])
        ref = gather_model(placed, device)
    else:
        ref = build_model(cfg, device, generator=torch.Generator().manual_seed(0))
        placed = place_model(build_model(cfg, device, generator=torch.Generator().manual_seed(0)),
                             param_shardings(ref, mesh, fsdp=False))
    rng = np.random.default_rng(3)
    batch = _batch(cfg, rng)
    out = {"placements": {n: str(tuple(p.placements)) for n, p in placed.named_parameters()},
           "params": {n: p.detach().float().cpu().numpy() for n, p in ref.named_parameters()
                      if p.numel() <= 1 << 16} if "seed" in case else {}}
    shape = ShapeConfig("serve", 16, 4, "decode")
    with activation_sharding(activation_rules(mesh, shape, cfg)):
        got, cache = placed.prefill(batch)
        want = ref.prefill(batch)[0]
        out["prefill_err"] = float((got.full_tensor() - want).abs().max())
        out["prefill_shape"] = tuple(got.shape)
        if cfg.has_decode and cfg.family != "vlm":
            prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]
            out["tokens"], out["ref_tokens"] = _serve(placed, prompts), _serve(ref, prompts)
            # one decode step's collectives, after a prefill of the same batch
            cache = placed.grow_cache(cache, 16, 18)
            nxt = got.full_tensor().argmax(-1)
            log = CollectiveLog()
            with CommDebugMode() as comm, log:
                step_logits, _ = placed.decode_step(nxt, cache, 16)
            # the twin's step on the cache it holds (on the card, the graph's)
            ref_cache = ref.grow_cache(ref.prefill(batch)[1], 16, 16 + DECODE_GRAPH_MIN_NEW)
            want_step = ref.decode_step(nxt, ref_cache, 16)[0]
            out["decode_err"] = float((step_logits.full_tensor() - want_step).abs().max())
            out["comm_counts"] = {str(k): v for k, v in comm.get_comm_counts().items()}
            out["log_counts"] = log.counts()
            out["gathered_params"] = log.gathered_params(placed)
            out["cache_placements"] = {n: str(tuple(t.placements)) for n, t in cache.items()}
            # decode steps by path (graphs captured, replayed, eager)
            out["decode_paths"] = {name: (m.decode_graphs_captured, m.decode_steps_replayed, m.decode_steps_eager)
                                   for name, m in (("placed", placed), ("ref", ref))}
    return out


def run_psum(case: dict, rank: int) -> dict:
    from repro_torch.distributed.compression import CompressionState, compressed_psum_int8
    from repro_torch.launch.mesh import make_mesh

    grads, residuals = case["grads"], case["residuals"]
    mesh = make_mesh((grads.shape[0],), ("data",), "cpu")
    mean, state = compressed_psum_int8(torch.from_numpy(grads[rank]),
                                       CompressionState(torch.from_numpy(residuals[rank])), (mesh, "data"))
    return {"mean": mean.numpy(), "residual": state.residual.numpy()}


def _worker(rank: int, world: int, backend: str, init: str, cases: dict, out_dir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
    dist.init_process_group(backend, init_method=f"file://{init}", rank=rank, world_size=world)
    results = {}
    try:
        for name, case in cases.items():
            try:
                results[name] = run_psum(case, rank) if "grads" in case else run_case(case, device)
            except Exception:
                results[name] = {"error": traceback.format_exc()}
    finally:
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()


def run_world(cases: dict, world: int, tmp_path: Path, backend: str = "gloo") -> dict:
    import torch.multiprocessing as mp

    mp.spawn(_worker, args=(world, backend, str(tmp_path / "init"), cases, str(tmp_path)), nprocs=world)
    return {r: torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)}
