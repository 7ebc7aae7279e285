"""Serving launcher: batched LM inference on a reduced config.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

Weights are drawn from ``--seed``. The model and the engine run on
``--device`` (default the card, ``cuda:0``; without CUDA that default
raises).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.config.registry import get_arch, list_archs
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serving import Request, ServeEngine
from repro_torch.utils.logging import get_logger

log = get_logger("launch.serve")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda:0", help="torch device (default cuda:0)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch).reduced()
    if not cfg.has_decode:
        raise SystemExit(f"{args.arch} is encoder-only: no decode serving")
    device = resolve_device(args.device)
    model = build_model(cfg, device, generator=torch.Generator(device).manual_seed(args.seed))
    engine = ServeEngine(model, max_batch=args.max_batch)

    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, int(rng.integers(4, 12))).tolist()
        engine.submit(Request(f"req-{i}", prompt, max_new_tokens=args.max_new,
                              temperature=args.temperature))

    t0 = time.time()
    results = engine.run(torch.Generator(device).manual_seed(args.seed))
    dt = time.time() - t0
    total_tokens = sum(len(r.tokens) for r in results)
    for r in results[:4]:
        log.info("%s: prompt %d tokens -> %s...", r.request_id, r.prompt_len, r.tokens[:8])
    log.info("%d requests, %d tokens in %.2fs (%.1f tok/s) on %s",
             len(results), total_tokens, dt, total_tokens / max(dt, 1e-9), device)
    return {"requests": len(results), "tokens": total_tokens, "seconds": dt,
            "device": str(device)}


if __name__ == "__main__":
    main()
