"""The frozen arithmetic of a granitemoehybrid stack (a ``layered`` config):
its model FLOPs and its expert layers' least time, counted from the
configuration's shapes (never from the kernels that ran), at the card's
peaks of ``yardstick.py``.

A token's matmul FLOPs are 2 x the parameters it multiplies: each layer's
mixer projections (Mamba-2 ``in_proj``/``out_proj``, or attention's q, k, v,
o), its router, its ``num_experts_per_tok`` routed experts and its shared
expert; the head once a prompt in prefill and once a row in decode. Beside
them: the state-space layer's terms at the published chunk, and causal
attention over each prompt's own tokens.
"""
from __future__ import annotations

from typing import Sequence

from portbench.yardstick import HBM_BYTES_PER_S, PEAK_FLOPS_BF16


def _dims(c: dict):
    d, H = c["hidden_size"], c["num_attention_heads"]
    di = c["mamba_expand"] * d
    return (d, H, c["num_key_value_heads"], d // H, di, c["mamba_d_state"], c["mamba_n_heads"],
            c["mamba_d_head"], c["intermediate_size"], c["shared_intermediate_size"],
            c["num_local_experts"], c["num_experts_per_tok"], c["vocab_size"])


def layer_counts(c: dict):
    """(mamba layers, attention layers)."""
    t = c["layer_types"]
    return t.count("mamba"), t.count("attention")


def active_matmul_params(c: dict) -> int:
    """Parameters a token multiplies below the head, over all layers."""
    d, H, KV, hd, di, N, SH, P, f, fs, E, k, V = _dims(c)
    nm, na = layer_counts(c)
    ffn = d * E + k * 3 * d * f + 3 * d * fs
    mamba = d * (2 * di + 2 * N + SH) + di * d
    attn = d * H * hd + 2 * d * KV * hd + H * hd * d
    return (nm + na) * ffn + nm * mamba + na * attn


def _ssd_prompt(c: dict, n: int) -> int:
    """One Mamba-2 layer's state-space FLOPs over a prompt of n tokens in
    chunks of ``mamba_chunk_size``: within a chunk of q, C B^T and the
    masked product with x over its q(q+1)/2 pairs; across chunks, each
    chunk's state (B^T x) and its read-out (C h), 2 x H x P x N a token each."""
    d, H, KV, hd, di, N, SH, P, f, fs, E, k, V = _dims(c)
    Q, total = c["mamba_chunk_size"], 0
    for c0 in range(0, n, Q):
        q = min(Q, n - c0)
        total += 2 * (N + SH * P) * q * (q + 1) // 2 + 4 * q * SH * P * N
    return total


def prefill_flops(c: dict, lengths: Sequence[int]) -> int:
    """Forward FLOPs of prompts of these lengths (padding not counted)."""
    d, H, KV, hd, di, N, SH, P, f, fs, E, k, V = _dims(c)
    nm, na = layer_counts(c)
    per_token = 2 * active_matmul_params(c)
    return sum(per_token * n + nm * _ssd_prompt(c, n) + na * H * 4 * hd * n * (n + 1) // 2 + 2 * d * V
               for n in lengths)


def decode_flops(c: dict, contexts: Sequence[int]) -> int:
    """FLOPs of one decode step over rows whose new token attends to
    ``contexts`` positions (itself included): the matmuls, each mamba
    layer's state update and read-out (4 x H x P x N), attention over the
    context, the head."""
    d, H, KV, hd, di, N, SH, P, f, fs, E, k, V = _dims(c)
    nm, na = layer_counts(c)
    row = 2 * active_matmul_params(c) + nm * 4 * SH * P * N + 2 * d * V
    return sum(row + na * H * 4 * hd * ctx for ctx in contexts)


def expert_bound_s(c: dict, tokens: int, experts_used: int) -> float:
    """The least time of expert layer calls over ``tokens`` tokens whose
    pairs reached ``experts_used`` experts (each summed over the calls, as
    ``MoeCounters`` counts them on the device): the routed experts' FLOPs
    (gate, up, down of k experts a token) at the bf16 peak, or the bytes
    they must move at the HBM rate, whichever is larger: the weights of
    each expert a call used read once, and each pair's row read and
    written once in bf16. Over the calls of one phase this is the sum of
    each call's own least time where they all lie on one side of the ridge
    (prefill's calls of 16,384 tokens above it, decode's of 32 below), and
    less than that sum otherwise."""
    d, H, KV, hd, di, N, SH, P, f, fs, E, k, V = _dims(c)
    flops = 2 * tokens * k * 3 * d * f
    nbytes = experts_used * 3 * d * f * 2 + k * tokens * 2 * d * 2
    return max(flops / PEAK_FLOPS_BF16, nbytes / HBM_BYTES_PER_S)
