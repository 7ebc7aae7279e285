"""Plain float32 reference of a Qwen2 decoder (arXiv:2407.10671): its
forward pass, and the gap of served tokens' logits below its best.

Each layer: RMSNorm, attention with biased Q/K/V projections, rotary
position embedding on the two halves of each head, grouped-query attention
(query head h reads key/value head h // (heads / kv_heads)), causal softmax
at 1/sqrt(head_dim), an output projection, a residual add; RMSNorm, a gated
SiLU MLP, a residual add. A final RMSNorm and the tied embedding as the
output head. Weights are a dict keyed by parameter name (``layers.*``
stacked over the layers); plain ``torch`` only, TF32 off.

``quant`` selects the control's arithmetic: ``None`` is float32; ``"fp8"``
holds what the program holds in bfloat16 in float8 e4m3 instead, each
tensor with its own scale: the weights, both operands of every product,
the residual stream between layers, the attention probabilities. It is the
step below bfloat16 that a faster version would take.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

Weights = Dict[str, torch.Tensor]


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _q(t: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with a per-tensor scale (``quant``
    ``"fp8"``), or as it is."""
    if quant is None:
        return t
    scale = 448.0 / t.abs().amax().clamp_min(1e-12)
    return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


def _mm(a: torch.Tensor, w: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    return _q(a, quant) @ _q(w, quant)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    half = x.shape[-1] // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = pos.float()[:, None] * inv                      # (S, half)
    c, s = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def hidden(w: Weights, cfg: dict, tokens: torch.Tensor, quant: Optional[str] = None) -> torch.Tensor:
    """Final normed hidden states (B, S, d) of ``tokens`` (B, S)."""
    L, H, KV, hd = cfg["layers"], cfg["heads"], cfg["kv_heads"], cfg["head_dim"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    B, S = tokens.shape
    if quant is not None:
        w = {n: _q(t, quant) for n, t in w.items()}
    x = _q(w["embed.tok"][tokens.long()], quant)
    pos = torch.arange(S, device=tokens.device)
    mask = torch.ones(S, S, dtype=torch.bool, device=tokens.device).tril()
    G = H // KV
    for i in range(L):
        h = _rms(x, w["layers.ln1"][i], eps)
        q = (_mm(h, w["layers.attn.wq"][i], quant) + w["layers.attn.bq"][i]).view(B, S, H, hd)
        k = (_mm(h, w["layers.attn.wk"][i], quant) + w["layers.attn.bk"][i]).view(B, S, KV, hd)
        v = (_mm(h, w["layers.attn.wv"][i], quant) + w["layers.attn.bv"][i]).view(B, S, KV, hd)
        q, k = _q(_rope(q, pos, theta), quant), _q(_rope(k, pos, theta), quant)
        k = k.repeat_interleave(G, dim=2)
        v = _q(v, quant).repeat_interleave(G, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        p = _q(torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1), quant)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, H * hd)
        x = _q(x + _mm(o, w["layers.attn.wo"][i], quant), quant)
        h = _rms(x, w["layers.ln2"][i], eps)
        g = torch.nn.functional.silu(_mm(h, w["layers.mlp.gate"][i], quant))
        x = _q(x + _mm(g * _mm(h, w["layers.mlp.up"][i], quant), w["layers.mlp.down"][i], quant), quant)
    return _q(_rms(x, w["ln_f"], eps), quant)


def logits(w: Weights, cfg: dict, tokens: torch.Tensor, quant: Optional[str] = None,
           start: int = 0) -> torch.Tensor:
    """(B, S - start, V) float32 logits of positions ``start``.. of ``tokens``."""
    x = hidden(w, cfg, tokens, quant)[:, start:]
    return _mm(x, w["embed.tok"].T, quant)


def served_gaps(w: Weights, cfg: dict, rows: Sequence[dict], quant: Optional[str] = None,
                pick: Optional[str] = None) -> List[float]:
    """For each served row (``tokens``: the sequence the engine processed,
    prompt then the served tokens; ``served``: the served tokens; ``first``:
    the position whose logits chose the first of them): by how much the
    served token's float32 logit lies below the best one, at every served
    position. With ``pick`` set to a quant, the token that arithmetic puts
    first takes the served token's place (the control)."""
    gaps: List[float] = []
    with torch.no_grad():
        for row in rows:
            toks = row["tokens"][None]
            ref = logits(w, cfg, toks, None, start=row["first"])[0]
            n = len(row["served"])
            ref = ref[:n]
            if pick is not None:
                chosen = logits(w, cfg, toks, pick, start=row["first"])[0][:n].argmax(-1)
            else:
                chosen = torch.as_tensor(row["served"], device=ref.device)
            best = ref.max(-1).values
            got = ref.gather(-1, chosen[:, None].long())[:, 0]
            gaps.extend((best - got).tolist())
    return gaps
