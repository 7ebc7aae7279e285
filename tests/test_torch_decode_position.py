"""The decode step's position read on the device, and the decode path each
model takes, on the CPU.

A 0-d int64 position tensor (what a CUDA graph of the step reads, filled
before each replay) must give the logits and K/V caches of the int position
bit for bit, in every family whose decode writes a K/V cache. Off the card a
decode step always runs eagerly, and the model counts it so.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.config import get_arch
from repro_torch.models import build_model

STEPS = 12
# the reduced configs whose decode reads ``pos``: dense, the VLM's text
# decode, a sliding window (the window's lower mask), the repeat-based
# baseline (``attn_grouped=False``), MoE, and the hybrid's shared attention
CASES = {
    "dense": ("qwen2-0.5b", {}),
    "vlm": ("llava-next-34b", {}),
    "sliding window": ("h2o-danube-1.8b", {}),
    "repeated kv": ("qwen2-0.5b", {"attn_grouped": False}),
    "moe": ("olmoe-1b-7b", {}),
    "hybrid": ("zamba2-2.7b", {}),
}


def _model(arch, **overrides):
    cfg = dataclasses.replace(get_arch(arch).reduced(), **overrides)
    return build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0))


def _prompt(cfg, rng, B=3, S=24):
    batch = {"tokens": rng.integers(1, cfg.vocab_size, (B, S))}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal((B, 8, cfg.d_model)).astype(np.float32)
    return batch


def _prefilled(model, horizon, seed=1):
    """A prefilled cache grown by ``horizon`` positions, its prompt length
    and the first greedy tokens."""
    batch = _prompt(model.cfg, np.random.default_rng(seed))
    logits, cache = model.prefill(batch)
    P = batch["tokens"].shape[1] + (batch["patch_embeds"].shape[1] if "patch_embeds" in batch else 0)
    return model.grow_cache(cache, P, P + horizon), P, logits.argmax(-1)


@pytest.mark.parametrize("case", list(CASES))
@torch.no_grad()
def test_tensor_position_decodes_bitwise_as_int(case):
    arch, overrides = CASES[case]
    model = _model(arch, **overrides)
    cache, P, tok = _prefilled(model, STEPS + 2)
    by_int = {name: t.clone() for name, t in cache.items()}
    by_tensor = {name: t.clone() for name, t in cache.items()}
    for step in range(STEPS):
        want, by_int = model._decode_step(tok, by_int, P + step)
        got, by_tensor = model._decode_step(tok, by_tensor, torch.tensor(P + step))
        assert torch.equal(got, want), (case, step)
        for name in by_int:
            assert torch.equal(by_tensor[name], by_int[name]), (case, step, name)
        tok = want.argmax(-1)
    # the steps wrote their positions and nothing past them
    assert by_tensor["k"][..., P + STEPS - 1, :, :].any()
    assert not by_tensor["k"][..., P + STEPS:, :, :].any()


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llava-next-34b", "falcon-mamba-7b"])
def test_decode_off_the_card_runs_eagerly_and_counts_it(arch):
    model = _model(arch)
    cache, P, tok = _prefilled(model, 3)
    for step in range(3):
        logits, cache = model.decode_step(tok, cache, P + step)
        tok = logits.argmax(-1)
    assert (model.decode_graphs_captured, model.decode_steps_replayed, model.decode_steps_eager) == (0, 0, 3)
    assert not model._graphable() and model._held_cache(3, P, P + 64) is None and not model._decode_graphs
