"""Batched serving engine: synchronized prefill + decode over request batches.

Serving model: requests queue up, the engine packs up to ``max_batch`` of
them, left-pads prompts to a common length, prefills once, then decodes
synchronously (one token per step for the whole batch) with greedy or
temperature sampling. Per-sequence stop tokens mask finished rows.

Positions are batch-synchronized (one ``pos`` for the batch). The engine runs
on its model's device; temperature sampling draws from a ``torch.Generator``
on that device. The engine calls ``prefill`` once a batch and
``decode_step`` once a step; between them the model grows the prefill's
cache to the decode horizon (``Model.grow_cache``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from torch.distributed.tensor import DTensor

from repro_torch.models.model import Model


@dataclass
class Request:
    request_id: str
    prompt_tokens: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0  # 0 = greedy


@dataclass
class BatchResult:
    request_id: str
    tokens: List[int]
    prompt_len: int


class ServeEngine:
    def __init__(self, model: Model, *, max_batch: int = 8, stop_token: int = -1) -> None:
        self.model = model
        self.max_batch = max_batch
        self.stop_token = stop_token
        self._pending: List[Request] = []
        self.steps_executed = 0

    def submit(self, req: Request) -> None:
        self._pending.append(req)

    def _generator(self) -> torch.Generator:
        return torch.Generator(self.model.device).manual_seed(0)

    # ------------------------------------------------------------- serving
    def step(self, generator: Optional[torch.Generator] = None) -> List[BatchResult]:
        """Process at most one pending batch and return its results (empty
        when the queue is idle): the event-loop entry point."""
        if not self._pending:
            return []
        batch = self._pending[: self.max_batch]
        self._pending = self._pending[self.max_batch:]
        return self._run_batch(batch, generator if generator is not None else self._generator())

    def run(self, generator: Optional[torch.Generator] = None) -> List[BatchResult]:
        """Drain pending requests in batches; returns completed results."""
        generator = generator if generator is not None else self._generator()
        results: List[BatchResult] = []
        while self._pending:
            results.extend(self.step(generator))
        return results

    def _run_batch(self, reqs: List[Request], generator: torch.Generator) -> List[BatchResult]:
        B = len(reqs)
        P = max(len(r.prompt_tokens) for r in reqs)
        max_new = max(r.max_new_tokens for r in reqs)

        # right-align prompts into a (B, P) buffer (pad id 0; positions match
        # the synchronized-pos contract because all rows share the pad length)
        toks = np.zeros((B, P), np.int64)
        for i, r in enumerate(reqs):
            toks[i, P - len(r.prompt_tokens):] = r.prompt_tokens

        # prefill on prompt, then grow the cache to the full horizon
        logits, cache = self.model.prefill({"tokens": torch.from_numpy(toks)})
        cache = self.model.grow_cache(cache, P, P + max_new)

        out: List[List[int]] = [[] for _ in range(B)]
        done = np.zeros(B, bool)
        cur = self._sample(logits, reqs, generator)
        for i in range(B):
            out[i].append(int(cur[i]))
        for step in range(1, max_new):
            logits, cache = self.model.decode_step(torch.from_numpy(cur), cache, P + step - 1)
            cur = self._sample(logits, reqs, generator)
            self.steps_executed += 1
            for i in range(B):
                if not done[i]:
                    tok = int(cur[i])
                    out[i].append(tok)
                    if tok == self.stop_token or len(out[i]) >= reqs[i].max_new_tokens:
                        done[i] = True
            if done.all():
                break
        return [
            BatchResult(r.request_id, out[i][: r.max_new_tokens], len(r.prompt_tokens))
            for i, r in enumerate(reqs)
        ]

    @staticmethod
    def _grow_cache(cache: Dict[str, torch.Tensor], P: int, total: int, model: Model) -> Dict[str, torch.Tensor]:
        """``model.grow_cache``, under the engine's former name."""
        return model.grow_cache(cache, P, total)

    @staticmethod
    def _sample(logits: torch.Tensor, reqs: List[Request], generator: torch.Generator) -> np.ndarray:
        temps = np.array([r.temperature for r in reqs], np.float32)
        if isinstance(logits, DTensor):
            logits = logits.full_tensor()
        greedy = torch.argmax(logits, dim=-1).cpu().numpy()
        if (temps == 0).all():
            return greedy
        t = torch.from_numpy(np.maximum(temps, 1e-6)).to(logits.device)
        probs = torch.softmax(logits / t[:, None], dim=-1)
        sampled = torch.multinomial(probs, 1, generator=generator)[:, 0].cpu().numpy()
        return np.where(temps == 0, greedy, sampled)
