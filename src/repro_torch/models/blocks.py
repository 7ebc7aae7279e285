"""Per-family transformer blocks (param specs + apply fns).

Params arrive as nested dicts of tensors, one layer's slice of the stacked
parameters (``Model`` loops over the stacked leading axis). A full-sequence
layer returns its K/V (the prefill's cache; the loss drops them)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config.model import ModelConfig
from repro_torch.launch.act_sharding import add_residual, constrain, merge_dims, split_dim
from repro_torch.models.attention import (
    Position,
    chunked_attention,
    chunked_attention_repeat,
    decode_attention,
    decode_attention_repeat,
    over_local_heads,
    update_kv_cache,
)
from repro_torch.models.layers import apply_rope, matmul, mlp_apply, mlp_specs, rms_norm, rope_freqs
from repro_torch.models import ssm
from repro_torch.models.moe import moe_apply, moe_apply_dropless, moe_specs, shared_expert, shared_specs
from repro_torch.models.spec import TensorSpec


# ------------------------------------------------------------- attention core
def attn_specs(cfg: ModelConfig, d_in: Optional[int] = None) -> dict:
    d = d_in or cfg.d_model
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = {
        "wq": TensorSpec((d, H * hd), ("embed", "heads")),
        "wk": TensorSpec((d, KV * hd), ("embed", "kv")),
        "wv": TensorSpec((d, KV * hd), ("embed", "kv")),
        "wo": TensorSpec((H * hd, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = TensorSpec((H * hd,), ("heads",), init="zeros")
        s["bk"] = TensorSpec((KV * hd,), ("kv",), init="zeros")
        s["bv"] = TensorSpec((KV * hd,), ("kv",), init="zeros")
    return s


def _qkv(p: dict, cfg: ModelConfig, x: torch.Tensor):
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = matmul(x, p["wq"])
    k = matmul(x, p["wk"])
    v = matmul(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return split_dim(q, -1, (H, hd)), split_dim(k, -1, (KV, hd)), split_dim(v, -1, (KV, hd))


def attn_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """Full-sequence attention. positions: (S,) absolute positions.
    Returns (out, (k, v)), k and v after RoPE."""
    S = x.shape[1]
    q, k, v = _qkv(p, cfg, x)
    if cfg.rope_theta:
        cos, sin = rope_freqs(positions, cfg.hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    # SP -> TP boundary: gather sequence, shard heads (Megatron-SP layout)
    q = constrain(q, "attn_q")
    k = constrain(k, "attn_kv")
    v = constrain(v, "attn_kv")
    chunk = min(cfg.attn_chunk, S)
    if cfg.attn_grouped:
        p_dtype = torch.bfloat16 if (cfg.attn_p_bf16 and cfg.dtype == "bfloat16") else torch.float32
        core = lambda q, k, v: chunked_attention(q, k, v, causal=cfg.causal, window=cfg.sliding_window,
                                                 chunk=chunk, p_dtype=p_dtype, scale=cfg.softmax_scale)
    else:  # A/B baseline
        core = lambda q, k, v: chunked_attention_repeat(q, k, v, causal=cfg.causal,
                                                        window=cfg.sliding_window, chunk=chunk,
                                                        scale=cfg.softmax_scale)
    out = over_local_heads(core, q, k, v)
    return matmul(merge_dims(out, 2), p["wo"]), (k, v)


def attn_decode_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, pos: Position):
    """x: (B, d_in) single token; caches (B, S, KV, hd), written at ``pos``."""
    q, k, v = _qkv(p, cfg, x[:, None])
    if cfg.rope_theta:
        at = pos.view(1) if isinstance(pos, torch.Tensor) else torch.full((1,), pos, device=x.device)
        cos, sin = rope_freqs(at, cfg.hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    k_cache, v_cache = update_kv_cache(k_cache, v_cache, k[:, 0], v[:, 0], pos)
    dec = decode_attention if cfg.attn_grouped else decode_attention_repeat
    out = dec(q[:, 0], k_cache, v_cache, pos, window=cfg.sliding_window, scale=cfg.softmax_scale)
    return matmul(merge_dims(out, 1), p["wo"]), k_cache, v_cache


# ------------------------------------------------------------- dense layers
def dense_layer_specs(cfg: ModelConfig) -> dict:
    return {
        "ln1": TensorSpec((cfg.d_model,), ("embed",), init="ones"),
        "attn": attn_specs(cfg),
        "ln2": TensorSpec((cfg.d_model,), ("embed",), init="ones"),
        "mlp": mlp_specs(cfg),
    }


def dense_layer_prefill(lp, cfg, x, positions):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    att, kv = attn_apply(lp["attn"], cfg, h, positions)
    x = add_residual(x, att)
    x = add_residual(x, mlp_apply(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps)))
    return x, kv


def dense_layer_decode(lp, cfg, x, k_cache, v_cache, pos):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    att, k_cache, v_cache = attn_decode_apply(lp["attn"], cfg, h, k_cache, v_cache, pos)
    x = add_residual(x, att)
    x = add_residual(x, mlp_apply(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps)))
    return x, k_cache, v_cache


# --------------------------------------------------------------- moe layers
def moe_layer_specs(cfg: ModelConfig) -> dict:
    return {
        "ln1": TensorSpec((cfg.d_model,), ("embed",), init="ones"),
        "attn": attn_specs(cfg),
        "ln2": TensorSpec((cfg.d_model,), ("embed",), init="ones"),
        "moe": moe_specs(cfg),
    }


def moe_layer_prefill(lp, cfg, x, positions):
    """Returns (x, (k, v), aux)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    att, kv = attn_apply(lp["attn"], cfg, h, positions)
    x = add_residual(x, att)
    ff, aux = moe_apply(lp["moe"], cfg, rms_norm(x, lp["ln2"], cfg.norm_eps))
    return add_residual(x, ff), kv, aux


def moe_layer_decode(lp, cfg, x, k_cache, v_cache, pos):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    att, k_cache, v_cache = attn_decode_apply(lp["attn"], cfg, h, k_cache, v_cache, pos)
    x = add_residual(x, att)
    ff, _ = moe_apply(lp["moe"], cfg, rms_norm(x, lp["ln2"], cfg.norm_eps)[:, None])
    return add_residual(x, ff[:, 0]), k_cache, v_cache


# ------------------------------------------------- zamba2 shared attention
def shared_attn_specs(cfg: ModelConfig) -> dict:
    """One set of weights, applied n_shared_attn() times (zamba trick). Input
    is concat(hidden, initial_embeds) -> 2*d_model."""
    d2 = 2 * cfg.d_model
    attn = attn_specs(cfg, d_in=d2)
    # output projection returns to the residual stream width (d_model)
    attn["wo"] = TensorSpec((cfg.n_heads * cfg.hd, cfg.d_model), ("heads", "embed"))
    return {
        "ln": TensorSpec((d2,), ("embed",), init="ones"),
        "attn": attn,
        "ln2": TensorSpec((d2,), ("embed",), init="ones"),
        "mlp": {
            "gate": TensorSpec((d2, cfg.d_ff), ("embed", "mlp")),
            "up": TensorSpec((d2, cfg.d_ff), ("embed", "mlp")),
            "down": TensorSpec((cfg.d_ff, cfg.d_model), ("mlp", "embed")),
        },
    }


def _shared_mlp(sp, cfg, x, e0):
    return add_residual(x, mlp_apply(sp["mlp"], rms_norm(torch.cat([x, e0], dim=-1), sp["ln2"], cfg.norm_eps)))


def shared_attn_prefill(sp, cfg, x, e0, positions):
    cat = torch.cat([x, e0], dim=-1)
    att, kv = attn_apply(sp["attn"], cfg, rms_norm(cat, sp["ln"], cfg.norm_eps), positions)
    return _shared_mlp(sp, cfg, add_residual(x, att), e0), kv


def shared_attn_decode(sp, cfg, x, e0, k_cache, v_cache, pos):
    cat = torch.cat([x, e0], dim=-1)
    att, k_cache, v_cache = attn_decode_apply(
        sp["attn"], cfg, rms_norm(cat, sp["ln"], cfg.norm_eps), k_cache, v_cache, pos
    )
    return _shared_mlp(sp, cfg, add_residual(x, att), e0), k_cache, v_cache


# -------------------------------------------- layered (granitemoehybrid)
def layered_layer_specs(cfg) -> dict:
    """What every layer of a ``layered`` stack holds whatever its mixer:
    the two norms, the routed experts and the shared expert. The mixers'
    own weights stack by kind (``mamba``, ``attn``)."""
    return {
        "ln1": TensorSpec((cfg.d_model,), ("embed",), init="ones"),
        "ln2": TensorSpec((cfg.d_model,), ("embed",), init="ones"),
        "moe": moe_specs(cfg),
        "shared": shared_specs(cfg),
    }


def _scaled_add(x: torch.Tensor, y: torch.Tensor, r: float) -> torch.Tensor:
    """``x + r * y`` in float32, rounded once to ``x``'s type."""
    return (x.float() + r * y.float()).to(x.dtype)


def _layered_ffn(lp, cfg, x):
    """x + r * (experts + shared expert) of the normed ``x``; every pair
    routed (``moe_apply_dropless``)."""
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    ff = moe_apply_dropless(lp["moe"], cfg, h).float() + shared_expert(lp["shared"], h).float()
    return _scaled_add(x, ff, cfg.residual_multiplier)


def layered_layer_prefill(lp, mp, kind, cfg, x, positions):
    """One layer over a full sequence: (x, state) with the mixer's state
    for the decode cache: (ssm state, normed input) of a mamba layer, whose
    conv tail the model cuts; (k, v) of an attention layer."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if kind == "mamba":
        out, h_last = ssm.mamba2_forward(mp, cfg, h)
        state = (h_last, h)
    else:
        out, state = attn_apply(mp, cfg, h, positions)
    return _layered_ffn(lp, cfg, _scaled_add(x, out, cfg.residual_multiplier)), state


def layered_layer_decode(lp, mp, kind, cfg, x, cache_a, cache_b, pos):
    """One layer for one new token: (x, cache_a, cache_b), the mixer's
    cache entries (ssm state and conv buffer, or k and v) updated."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if kind == "mamba":
        out, cache_a, cache_b = ssm.mamba2_decode(mp, cfg, h, cache_a, cache_b)
    else:
        out, cache_a, cache_b = attn_decode_apply(mp, cfg, h, cache_a, cache_b, pos)
    return _layered_ffn(lp, cfg, _scaled_add(x, out, cfg.residual_multiplier)), cache_a, cache_b
