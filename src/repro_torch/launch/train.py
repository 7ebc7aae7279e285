"""Training launcher: ``python -m repro_torch.launch.train --arch qwen2-0.5b --steps 100``.

Trains the *reduced* config by default; ``--full`` trains the published
widths and depth (qwen2-0.5b fits one H100). Wires together: config
registry -> model -> data pipeline -> train step -> checkpoint manager, with
resume-from-latest and periodic saves. Weights are drawn on the host from
``--seed`` (so every device starts from the same ones); the rest runs on
``--device`` (default the card, ``cuda:0``; without CUDA
that default raises). Only the log line every 10 steps reads values back
from the device; batches go up through pinned memory without a sync.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch qwen2-0.5b --steps 20
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from repro_torch.config.registry import get_arch, list_archs
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.training import (
    CheckpointManager,
    SyntheticTokenPipeline,
    cosine_schedule,
    make_train_step,
    train_state_init,
)
from repro_torch.utils.logging import get_logger

log = get_logger("launch.train")


def batch_to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``; to a card through pinned
    memory, asynchronously."""
    if device.type == "cpu":
        return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(device, non_blocking=True)
            for k, v in batch.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", action="store_true", help="int8 grad compression + error feedback")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--full", action="store_true", help="full (non-reduced) config")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda:0", help="torch device (default cuda:0)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    model = build_model(cfg, device, generator=torch.Generator().manual_seed(args.seed))
    state = train_state_init(model, compression=args.compression)
    mgr = CheckpointManager(Path(args.ckpt_dir) / cfg.name)
    start_step = 0
    if args.resume and mgr.latest_step() is not None:
        state, start_step, _ = mgr.restore(state)
        log.info("resumed from step %d", start_step)

    pipe = SyntheticTokenPipeline(cfg, args.batch, args.seq, seed=args.seed)
    sched = cosine_schedule(args.lr, args.warmup, args.steps)
    step_fn = make_train_step(model, sched, microbatches=args.microbatches, compression=args.compression)

    t0 = time.time()
    tokens_per_step = args.batch * args.seq
    metrics = {}
    for step in range(start_step, args.steps):
        state, metrics = step_fn(state, batch_to_device(pipe.get_batch(step), device))
        if step % 10 == 0 or step == args.steps - 1:
            log.info(
                "step %4d loss %.4f gnorm %.3f lr %.2e (%.1f tok/s)",
                step, float(metrics["loss"]), float(metrics["gnorm"]),
                float(metrics["lr"]), tokens_per_step * (step - start_step + 1) / (time.time() - t0),
            )
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, state, extra={"arch": cfg.name})
    mgr.save(args.steps, state, extra={"arch": cfg.name})
    return {"final_loss": float(metrics["loss"]) if metrics else None, "steps": args.steps,
            "device": str(device)}


if __name__ == "__main__":
    main()
