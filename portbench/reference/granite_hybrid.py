"""Plain float32 reference of a granitemoehybrid decoder (IBM Granite 4.0-H,
``model_type`` ``granitemoehybrid``): its forward pass and logits over
whole sequences.

Written from the published configuration and layer equations. Each layer
``i`` of ``layer_types``:

    h  = x + residual_multiplier * mixer_i(rms_norm(x))
    x' = h + residual_multiplier * (moe(rms_norm(h)) + shared(rms_norm(h)))

* Mamba-2 mixer (``"mamba"``): ``in_proj`` to z | x B C | dt (one group);
  a causal depthwise convolution over x B C with bias, then SiLU;
  ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the state-space
  layer as its full quadratic form over the whole sequence,
  ``y = (L o C B^T) (x dt) + D x`` with ``L[i, j] = exp(sum_{j<t<=i} dt_t A)``
  per head (not chunked, so independent of the program's chunked SSD); the
  gated RMSNorm ``norm(y * silu(z))`` over all of d_inner; ``out_proj``.
* Attention mixer (``"attention"``): GQA (query head h reads key/value head
  h // (heads / kv_heads)), no bias, no positional encoding
  (``position_embedding_type: nope``), causal softmax at
  ``attention_multiplier``.
* ``moe``: router logits, the top ``num_experts_per_tok``, a softmax over
  those; a loop over the experts, each a gated SiLU MLP on exactly the
  tokens that chose it (no capacity), weighted by its gate.
* ``shared``: one gated SiLU MLP of ``shared_intermediate_size`` on every
  token.
* The embedding times ``embedding_multiplier``; a final RMSNorm; the tied
  embedding as the head, its logits divided by ``logits_scaling``.

Departures: the program computes the router's softmax over all experts and
renormalises the top k, which is the same softmax over the top k logits;
rows are whole sequences run one at a time (no cache, no batching). Plain
``torch`` only, TF32 off (``qwen2.no_tf32``).

Weights: ``top`` holds ``embed.tok`` and ``ln_f``; ``layer_weights(i)``
returns layer ``i``'s float32 weights (``ln1``, ``ln2``, ``moe.*``,
``shared.*``, and ``mamba.*`` or ``attn.*``), drawn when it is called: the
forward runs layer by layer over all rows, so one layer's weights are held
at a time.

``quant`` selects the control's arithmetic: ``None`` is float32; ``"fp8"``
holds what the program holds in bfloat16 in float8 e4m3 instead, each
tensor with its own scale: the weights, both operands of every product, the
residual stream between layers, the attention probabilities. The router
and the state-space arithmetic, float32 in the program, stay float32.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from portbench.reference.qwen2 import _mm, _q, _rms, no_tf32  # noqa: F401  (no_tf32: the drivers' entry)

Weights = Dict[str, torch.Tensor]


def _dims(cfg: dict) -> dict:
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"d": d, "H": H, "KV": cfg["num_key_value_heads"], "hd": d // H,
            "di": cfg["mamba_expand"] * d, "N": cfg["mamba_d_state"], "P": cfg["mamba_d_head"],
            "SH": cfg["mamba_n_heads"], "K": cfg["mamba_d_conv"], "E": cfg["num_local_experts"],
            "k": cfg["num_experts_per_tok"], "eps": cfg["rms_norm_eps"]}


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (H, S) -> (H, S, S): ``out[h, i, j] = sum_{j<t<=i} a[h, t]`` for
    i >= j (each a sum of the terms themselves, not a difference of
    prefix sums), -inf above the diagonal."""
    S = a.shape[-1]
    strict = torch.ones(S, S, dtype=torch.bool, device=a.device).tril(-1)
    out = torch.cumsum(a[:, :, None].expand(-1, S, S).masked_fill(~strict, 0.0), dim=1)
    return out.masked_fill(~torch.ones(S, S, dtype=torch.bool, device=a.device).tril(), float("-inf"))


def mamba2(w: Weights, cfg: dict, x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """The Mamba-2 mixer over one whole sequence x (S, d)."""
    m = _dims(cfg)
    di, N, H, P, K = m["di"], m["N"], m["SH"], m["P"], m["K"]
    S = x.shape[0]
    z, xbc, dt = torch.split(_mm(x, w["mamba.in_proj"], quant), [di, di + 2 * N, H], dim=-1)
    xp = F.pad(xbc.T, (K - 1, 0))                                       # (C, S + K - 1)
    conv = sum(xp[:, t:t + S] * w["mamba.conv_w"][t][:, None] for t in range(K)).T
    xs, Bm, Cm = torch.split(F.silu(conv + w["mamba.conv_b"]), [di, N, N], dim=-1)
    dt = F.softplus(dt + w["mamba.dt_b"])                               # (S, H)
    A = -torch.exp(w["mamba.A_log"])                                    # (H,)
    X = xs.reshape(S, H, P)
    L = torch.exp(_segsum((dt * A).T))                                  # (H, S, S)
    M = L * (Cm @ Bm.T)[None]
    y = torch.bmm(M, (X * dt[..., None]).transpose(0, 1)).transpose(0, 1)  # (S, H, P)
    y = (y + w["mamba.D"][None, :, None] * X).reshape(S, di) * F.silu(z)
    return _mm(_rms(y, w["mamba.norm"], m["eps"]), w["mamba.out_proj"], quant)


def attention(w: Weights, cfg: dict, x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """Causal GQA over one whole sequence x (S, d), no positional encoding."""
    m = _dims(cfg)
    H, KV, hd = m["H"], m["KV"], m["hd"]
    S = x.shape[0]
    q = _q(_mm(x, w["attn.wq"], quant).view(S, H, hd), quant)
    k = _q(_mm(x, w["attn.wk"], quant).view(S, KV, hd), quant).repeat_interleave(H // KV, dim=1)
    v = _q(_mm(x, w["attn.wv"], quant).view(S, KV, hd), quant).repeat_interleave(H // KV, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) * cfg["attention_multiplier"]
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    p = _q(torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1), quant)
    o = torch.einsum("hqk,khd->qhd", p, v).reshape(S, H * hd)
    return _mm(o, w["attn.wo"], quant)


def _mlp(h: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
         quant: Optional[str]) -> torch.Tensor:
    return _mm(F.silu(_mm(h, gate, quant)) * _mm(h, up, quant), down, quant)


def experts(w: Weights, cfg: dict, h: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """The routed experts over tokens h (S, d): each expert on the tokens
    that chose it, no capacity."""
    m = _dims(cfg)
    top, idx = torch.topk(h @ w["moe.router"], m["k"], dim=-1)
    gates = torch.softmax(top, dim=-1)                                  # (S, k)
    out = torch.zeros_like(h)
    for e in range(m["E"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = _mlp(h[tok], w["moe.gate"][e], w["moe.up"][e], w["moe.down"][e], quant)
        out.index_add_(0, tok, y * gates[tok, slot][:, None])
    return out


def hidden(top: Weights, layer_weights: Callable[[int], Weights], cfg: dict,
           rows: Sequence[torch.Tensor], quant: Optional[str] = None) -> List[torch.Tensor]:
    """Final normed hidden states (S, d) of each row of token ids (S,),
    layer by layer over all rows."""
    m = _dims(cfg)
    r, eps = cfg["residual_multiplier"], m["eps"]
    emb = _q(top["embed.tok"], quant)
    xs = [_q(emb[t.long()] * cfg["embedding_multiplier"], quant) for t in rows]
    for i, kind in enumerate(cfg["layer_types"]):
        w = layer_weights(i)
        if quant is not None:
            w = {n: t if n == "moe.router" else _q(t, quant) for n, t in w.items()}
        mixer = mamba2 if kind == "mamba" else attention
        for j, x in enumerate(xs):
            x = _q(x + r * mixer(w, cfg, _rms(x, w["ln1"], eps), quant), quant)
            h = _rms(x, w["ln2"], eps)
            ff = experts(w, cfg, h, quant) + _mlp(h, w["shared.gate"], w["shared.up"], w["shared.down"], quant)
            xs[j] = _q(x + r * ff, quant)
        del w
    return [_q(_rms(x, top["ln_f"], eps), quant) for x in xs]


def logits(top: Weights, layer_weights: Callable[[int], Weights], cfg: dict,
           rows: Sequence[torch.Tensor], starts: Sequence[int], quant: Optional[str] = None
           ) -> List[torch.Tensor]:
    """(S - start, V) float32 logits of positions ``start``.. of each row."""
    hs = hidden(top, layer_weights, cfg, rows, quant)
    emb = _q(top["embed.tok"], quant)
    return [_mm(h[s:], emb.T, quant) / cfg["logits_scaling"] for h, s in zip(hs, starts)]
