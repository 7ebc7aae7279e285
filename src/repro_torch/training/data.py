"""Training data pipeline.

Two sources, one interface (an iterator of per-step batch dicts):

* :class:`SyntheticTokenPipeline` — deterministic seeded token streams per
  family (LM tokens/labels, encoder frames/masks, VLM patches+text), sharded
  by (host_index, host_count) exactly like a multi-host input pipeline would
  shard a file set;
* :class:`DeidImagePipeline` — the platform integration: consumes
  de-identified studies from a researcher :class:`StudyStore` bucket and
  yields VLM patch-embedding batches (the paper's downstream-AI use case;
  see examples/deid_to_training_torch.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.config.model import ModelConfig


@dataclass
class SyntheticTokenPipeline:
    cfg: ModelConfig
    batch: int                 # per-host batch
    seq: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.get_batch(step)
            step += 1

    def _tokens(self, rng: np.random.Generator, shape) -> np.ndarray:
        # Zipfian marginals (natural-language-like): learnable structure so
        # example training runs demonstrably beat the uniform ln(V) baseline
        z = rng.zipf(1.3, size=shape)
        return np.minimum(z - 1, self.cfg.vocab_size - 1).astype(np.int32)

    def get_batch(self, step: int) -> Dict[str, np.ndarray]:
        # per-(host, step) stream: hosts never overlap, restarts reproduce
        rng = np.random.default_rng((self.seed, self.host_index, step))
        cfg, B, S = self.cfg, self.batch, self.seq
        if cfg.family == "encoder":
            return {
                "frame_embeds": rng.normal(size=(B, S, cfg.d_model)).astype(np.float32),
                "mask": rng.random((B, S)) < 0.3,
                "labels": self._tokens(rng, (B, S)),
            }
        if cfg.family == "vlm":
            si = S // 2
            tokens = self._tokens(rng, (B, S - si + 1))
            return {
                "tokens": tokens[:, :-1],
                "patch_embeds": rng.normal(size=(B, si, cfg.d_model)).astype(np.float32),
                "labels": tokens[:, 1:],
            }
        toks = self._tokens(rng, (B, S + 1))
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class DeidImagePipeline:
    """De-identified pixels -> patch embeddings for the VLM backbone.

    Patches are cut from scrubbed images (16x16), normalized, and projected
    to d_model with a fixed random (seeded) projection standing in for the
    frozen vision tower the assignment stubs out.
    """

    def __init__(self, cfg: ModelConfig, patch: int = 16, seed: int = 0) -> None:
        self.cfg = cfg
        self.patch = patch
        rng = np.random.default_rng(seed)
        self.proj = rng.normal(size=(patch * patch, cfg.d_model)).astype(np.float32) / patch

    def patches_from_image(self, pixels: np.ndarray, max_patches: int) -> np.ndarray:
        p = self.patch
        H, W = pixels.shape[:2]
        img = pixels[: H // p * p, : W // p * p].astype(np.float32)
        maxv = float(img.max()) or 1.0
        img = img / maxv
        tiles = img.reshape(H // p, p, W // p, p).transpose(0, 2, 1, 3).reshape(-1, p * p)
        return (tiles[:max_patches] @ self.proj).astype(np.float32)

    def batch_from_datasets(self, datasets, batch: int, seq: int, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng(0)
        cfg = self.cfg
        si = seq // 2
        st = seq - si
        embeds = np.zeros((batch, si, cfg.d_model), np.float32)
        for b in range(batch):
            ds = datasets[b % len(datasets)]
            pt = self.patches_from_image(ds.pixels, si)
            embeds[b, : len(pt)] = pt
        tokens = rng.integers(0, cfg.vocab_size, (batch, st + 1), dtype=np.int32)
        return {"tokens": tokens[:, :-1], "patch_embeds": embeds, "labels": tokens[:, 1:]}
