"""Shared layers: RMSNorm, RoPE, gated MLP, embeddings, chunked CE loss.

``matmul`` and ``einsum`` promote their operands to a common dtype first:
float32 activations meet bfloat16 weights in every reduced config, and
``torch.matmul`` refuses mixed dtypes where ``jnp`` promotes. A bfloat16
config keeps bfloat16 products (accumulated in float32 by the library).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.config.model import ModelConfig
from repro_torch.launch.act_sharding import ModelAxis, captured, constrain, gather_batch_axes, local_block
from repro_torch.models.spec import TensorSpec


def _common(*ops: torch.Tensor) -> list:
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return [o.to(dt) for o in ops]


def _fit_input(a: torch.Tensor, w: DTensor) -> torch.Tensor:
    """``a`` laid out so that ``a @ w`` moves no part of the weight: over a
    mesh axis that shards w's columns, a's rows are whole (the SP -> TP
    gather of the activation); over one that shards w's rows, a's columns
    are sharded alike; elsewhere a keeps its layout."""
    want = list(a.placements)
    for i, p in enumerate(w.placements):
        if isinstance(p, Shard) and p.dim == w.ndim - 1:
            want[i] = Replicate()
        elif isinstance(p, Shard) and p.dim == w.ndim - 2:
            want[i] = Shard(a.ndim - 1)
    return a.redistribute(a.device_mesh, want) if want != list(a.placements) else a


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``, ``b`` a weight: on a mesh, an FSDP-sharded weight is
    gathered over the batch axes at its use (``gather_batch_axes``)."""
    if isinstance(a, DTensor) and isinstance(b, DTensor):
        b = gather_batch_axes(b)
        a = _fit_input(a, b)
    return torch.matmul(*_common(a, b))


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, *_common(*ops))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


# ----------------------------------------------------------------- RoPE
def rope_freqs(positions: torch.Tensor, head_dim: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) int -> (cos, sin) of shape (..., head_dim/2) f32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (S, hd/2) or broadcastable."""
    half = x.shape[-1] // 2
    if isinstance(x, DTensor) and not isinstance(cos, DTensor):
        # the tables take part replicated, in backward too (no mixed op)
        rep = [Replicate()] * x.device_mesh.ndim
        cos, sin = (DTensor.from_local(t, x.device_mesh, rep, run_check=False) for t in (cos, sin))
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    c = cos[None, :, None, :].float()
    s = sin[None, :, None, :].float()
    return torch.cat([x1f * c - x2f * s, x2f * c + x1f * s], dim=-1).to(x.dtype)


# -------------------------------------------------------------- gated MLP
def mlp_specs(cfg: ModelConfig, d_in: int | None = None) -> dict:
    d = d_in or cfg.d_model
    return {
        "gate": TensorSpec((d, cfg.d_ff), ("embed", "mlp")),
        "up": TensorSpec((d, cfg.d_ff), ("embed", "mlp")),
        "down": TensorSpec((cfg.d_ff, d), ("mlp", "embed")),
    }


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(matmul(x, p["gate"])) * matmul(x, p["up"])
    h = constrain(h, "inner")  # SP -> TP boundary: d_ff sharded, S gathered
    return matmul(h, p["down"])


# ------------------------------------------------------------- embeddings
def embed_specs(cfg: ModelConfig) -> dict:
    # GPT-2-style 0.02 init; with tied embeddings this also keeps head logits
    # in a sane range at init (scale-1.0 embeddings blow the tied CE up)
    specs = {"tok": TensorSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        specs["head"] = TensorSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return specs


def embed_tokens(p: dict, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if isinstance(p["tok"], DTensor):
        # F.embedding, not indexing: on a vocab-sharded table DTensor looks
        # the rows up where they live (a masked partial sum), no gather;
        # the sum is taken at once, as the pending mask serves one reduction
        out = F.embedding(tokens, gather_batch_axes(p["tok"]))
        whole = [Replicate() if q.is_partial() else q for q in out.placements]
        return out.redistribute(out.device_mesh, whole).to(dtype)
    return p["tok"][tokens].to(dtype)


def head_matrix(p: dict, cfg: ModelConfig) -> torch.Tensor:
    return p["tok"].T if cfg.tie_embeddings else p["head"]


# ------------------------------------------------- chunked cross-entropy
def _ce_chunk(xs: torch.Tensor, head: torch.Tensor, ls: torch.Tensor):
    """(sum of lse - gold over the valid labels, their count) of one chunk;
    its logits are float32."""
    logits = constrain(matmul(xs, head).float(), "logits")     # (B, C, V)
    if isinstance(logits, DTensor):
        return _ce_on_shards(logits, ls)
    m = torch.amax(logits, dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.sum(torch.exp(logits - m), dim=-1))
    gold = torch.gather(logits, -1, ls.clamp_min(0)[..., None])[..., 0]
    valid = ls >= 0
    return torch.sum(torch.where(valid, lse - gold, 0.0)), torch.sum(valid)


def _ce_on_shards(logits: DTensor, ls: torch.Tensor):
    """``_ce_chunk``'s sums on a mesh, on local shards: each rank holds its
    rows and its slice [v0, v1) of the vocab; the max, the exp-sum and the
    gold logit are reduced over ``model`` and the two sums over the batch's
    axes (DTensor's masked gather of a vocab-sharded dim does not serve the
    gold logit's squeeze). The max only shifts the exponent: no gradient
    flows through it."""
    tp = ModelAxis(logits)
    local = tp.local(logits, 2)
    size, offset = local_block(logits.shape, tp.mesh, tp.layout(2))
    v0, nv = offset[2], size[2]
    labels = tp.whole_rows(ls) if isinstance(ls, DTensor) else ls
    m = tp.pmax(torch.amax(local.detach(), dim=-1, keepdim=True))
    lse = m[..., 0] + torch.log(tp.psum(torch.sum(torch.exp(local - m), dim=-1)))
    idx = labels.clamp_min(0) - v0
    mine = (idx >= 0) & (idx < nv)
    gold = torch.gather(local, -1, idx.clamp(0, max(nv - 1, 0))[..., None])[..., 0]
    gold = tp.psum(torch.where(mine, gold, 0.0))
    valid = labels >= 0
    return (tp.batch_sum(torch.sum(torch.where(valid, lse - gold, 0.0))),
            tp.batch_sum(torch.sum(valid).float()))


def chunked_ce_loss(
    x: torch.Tensor,           # (B, S, d) final hidden states
    head: torch.Tensor,        # (d, V)
    labels: torch.Tensor,      # (B, S) int; -1 = ignore
    chunk: int,
) -> torch.Tensor:
    """Sequence-chunked softmax CE: never materializes (B, S, V) logits.
    While autograd records, each chunk is checkpointed: the backward pass
    recomputes its logits, so one chunk's logits are live at a time."""
    B, S, d = x.shape
    if S % chunk and not isinstance(x, DTensor):
        # on a mesh the last chunk is short instead (torch 2.11's DTensor
        # pads a sequence-sharded tensor into a malformed layout)
        pad = chunk - S % chunk
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
        S += pad
    grad = torch.is_grad_enabled()
    # the recompute in backward runs under the forward's activation rules
    ce_chunk = captured(_ce_chunk, placed=isinstance(x, DTensor)) if grad else _ce_chunk
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        xs, ls = x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if grad:
            t, n = checkpoint(ce_chunk, xs, head, ls, use_reentrant=False, preserve_rng_state=False)
        else:
            t, n = _ce_chunk(xs, head, ls)
        total = total + t
        count = count + n
    return total / torch.clamp_min(count, 1.0)
