"""The benchmark's frozen arithmetic: the card's peaks, and the operations
and bytes of the work a window did, counted from shapes (never from which
kernels ran), so a change to the program cannot move the yardstick.

Peaks: NVIDIA H100 SXM data sheet, dense rates, at its 700 W limit.
"""
from __future__ import annotations

from typing import Dict, Sequence

PEAK_FLOPS_BF16 = 989e12   # FLOP/s, tensor cores, dense
HBM_BYTES_PER_S = 3.35e12  # bytes/s


def _dims(config: dict):
    d, H, KV = config["hidden_size"], config["num_attention_heads"], config["num_key_value_heads"]
    hd = d // H
    return (d, H, KV, hd, config["intermediate_size"], config["vocab_size"],
            config["num_hidden_layers"])


def matmul_params(config: dict) -> int:
    """Parameters that enter a matmul once per token: every layer's
    projections and MLP, and the (tied) output head; the embedding lookup
    is not a matmul."""
    d, H, KV, hd, f, V, L = _dims(config)
    layer = d * H * hd + 2 * d * KV * hd + H * hd * d + 3 * d * f
    return L * layer + d * V


def train_flops(config: dict, B: int, S: int) -> Dict[str, int]:
    """Model FLOPs of one train step: 6 x the matmul parameters x tokens
    (forward 2, backward 4) plus causal attention's QK^T and PV over the
    S(S+1)/2 pairs a head keeps, three times over (forward, backward); what
    remat recomputes is not counted."""
    d, H, KV, hd, f, V, L = _dims(config)
    attn_fwd = L * B * H * 4 * hd * S * (S + 1) // 2
    return {"model_flops": 6 * matmul_params(config) * B * S + 3 * attn_fwd}


def prefill_flops(config: dict, lengths: Sequence[int]) -> int:
    """Forward FLOPs of prompts of these lengths: 2 x matmul params per
    token, and causal attention over each prompt's own tokens. Only the
    last position's head product is needed; the head is counted once a
    prompt."""
    d, H, KV, hd, f, V, L = _dims(config)
    per_token = matmul_params(config) - d * V
    total = 0
    for n in lengths:
        total += 2 * per_token * n + 2 * d * V + L * H * 4 * hd * n * (n + 1) // 2
    return total


def decode_flops(config: dict, contexts: Sequence[int]) -> int:
    """FLOPs of one decode step over rows whose new token attends to
    ``contexts`` positions (itself included)."""
    d, H, KV, hd, f, V, L = _dims(config)
    return sum(2 * matmul_params(config) + L * H * 4 * hd * c for c in contexts)


def deid_min_bytes(pixel_bytes: int, payload_bytes: int, recompress: bool) -> int:
    """The least the de-identification of these pixels moves through device
    memory: every source pixel read once, and what the stage must produce
    written once: the compressed stream when it recompresses, the blanked
    pixels when it does not."""
    return pixel_bytes + (payload_bytes if recompress else pixel_bytes)
