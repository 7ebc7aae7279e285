"""Mixture-of-Experts FFN: top-k router + capacity-bounded scatter dispatch.

  1. router logits -> softmax -> top-k experts per token, weights renormalized;
  2. position-in-expert via cumsum over each row's flattened (token, choice)
     lattice; tokens beyond ``capacity = cf * S * k / E`` are dropped;
  3. scatter tokens into a dense (B, E, C, d) buffer, grouped-matmul the
     expert FFNs;
  4. gather back with combine weights; aux load-balance loss (Switch-style).

Dispatch is row-local: position-in-expert and the scatter/gather stay within
each sequence, with per-row capacity ``S*k*cf/E``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from repro_torch.config.model import ModelConfig
from repro_torch.launch.act_sharding import ModelAxis, constrain
from repro_torch.models.layers import einsum, matmul
from repro_torch.models.spec import TensorSpec


def moe_specs(cfg: ModelConfig) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": TensorSpec((d, E), ("embed", None), dtype=torch.float32),
        "gate": TensorSpec((E, d, f), ("experts", "embed", "mlp")),
        "up": TensorSpec((E, d, f), ("experts", "embed", "mlp")),
        "down": TensorSpec((E, f, d), ("experts", "mlp", "embed")),
    }


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(n_tokens * cfg.experts_per_token * cfg.capacity_factor / cfg.n_experts)
    return max(c, cfg.experts_per_token)


def _route(p: dict, cfg: ModelConfig, xt: torch.Tensor):
    """Router probabilities and the renormalized top-k (gates, experts)."""
    probs = torch.softmax(matmul(xt.float(), p["router"]).float(), dim=-1)
    gate_vals, expert_idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
    return probs, gate_vals, expert_idx


def _dispatch(cfg: ModelConfig, x: torch.Tensor, gate_vals: torch.Tensor, expert_idx: torch.Tensor):
    """Row-local dispatch of x (B, S, d): (ex_in (B, E, C, d), slot, keep),
    slot and keep (B, S*k) the buffer row of each (token, choice)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    C = capacity(cfg, S)  # per-row capacity
    dev = x.device

    # position-in-expert within each row's (S*k) dispatch lattice
    flat_e = expert_idx.reshape(B, S * k)                                # (B, S*k)
    onehot = F.one_hot(flat_e, E)                                        # (B, S*k, E)
    pos = ((torch.cumsum(onehot, dim=1) - 1) * onehot).sum(-1)           # (B, S*k)
    keep = pos < C
    slot = torch.where(keep, flat_e * C + pos, E * C)                    # (B, S*k)

    # row-local scatter to (B, E*C+1, d); spill row dropped
    tok_idx = torch.arange(S, device=dev).repeat_interleave(k)           # (S*k,)
    vals = x[:, tok_idx]                                                 # (B, S*k, d)
    rows = torch.arange(B, device=dev)[:, None]
    buf = torch.zeros((B, E * C + 1, d), dtype=x.dtype, device=dev)
    buf[rows, slot] = vals
    return buf[:, : E * C].reshape(B, E, C, d), slot, keep


def _combine(ex_out: torch.Tensor, gate_vals: torch.Tensor, slot: torch.Tensor,
             keep: torch.Tensor) -> torch.Tensor:
    """Row-local gather of the expert outputs (B, E*C, d) + combine."""
    B, _, d = ex_out.shape
    Sk = slot.shape[1]
    k = gate_vals.shape[-1]
    ex_out = torch.cat([ex_out, torch.zeros((B, 1, d), dtype=ex_out.dtype, device=ex_out.device)], dim=1)
    gathered = torch.gather(ex_out, 1, slot[..., None].expand(B, Sk, d))  # (B, S*k, d)
    w = (gate_vals.reshape(B, Sk) * keep).float()[..., None]
    return (gathered.float() * w).reshape(B, Sk // k, k, d).sum(dim=2)


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar)."""
    if isinstance(x, DTensor):
        return _moe_apply_on_shards(p, cfg, x)
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    C = capacity(cfg, S)
    dev = x.device

    probs, gate_vals, expert_idx = _route(p, cfg, x)                     # (B, S, k)

    # aux load-balance loss (Switch): E * sum_e f_e * P_e
    me = probs.mean(dim=(0, 1))                                          # (E,)
    ce = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, expert_idx.reshape(-1), torch.ones(B * S * k, dtype=torch.float32, device=dev)
    ) / (B * S * k)
    aux = E * torch.sum(me * ce) * cfg.router_aux_weight

    ex_in, slot, keep = _dispatch(cfg, x, gate_vals, expert_idx)
    ex_in = constrain(ex_in, "moe_in")

    # grouped expert FFN (batched over rows; weights broadcast)
    h = F.silu(einsum("becd,edf->becf", ex_in, p["gate"])) * einsum("becd,edf->becf", ex_in, p["up"])
    h = constrain(h, "moe_hidden")
    ex_out = einsum("becf,efd->becd", h, p["down"]).reshape(B, E * C, d)
    return _combine(ex_out, gate_vals, slot, keep).to(x.dtype), aux


def _moe_apply_on_shards(p: dict, cfg: ModelConfig, x: DTensor) -> Tuple[DTensor, torch.Tensor]:
    """``moe_apply`` on a mesh. The routing, the dispatch and the combine run
    on each rank's whole rows (the batch stays sharded, the sequence is
    gathered: the SP -> TP boundary), and the aux loss's two sums are
    all-reduced over the batch's axes. The expert FFN runs on local shards
    laid out by ``moe_in`` / ``moe_hidden``: expert-parallel (the expert
    weights sharded at dim 0), each rank runs its experts and their outputs
    are all-gathered; TP inside each expert (sharded at the mlp dim), each
    rank runs its slice of every expert and the down products are
    all-reduced."""
    tp = ModelAxis(x)
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    C = capacity(cfg, S)
    xl = tp.whole_rows(x)
    dev = xl.device
    probs, gate_vals, expert_idx = _route({"router": tp.param(p["router"], None)[0]}, cfg, xl)
    sums = tp.batch_sum(torch.cat([probs.sum(dim=(0, 1)), torch.zeros(E, dtype=torch.float32, device=dev)
                                   .index_add_(0, expert_idx.reshape(-1),
                                               torch.ones(expert_idx.numel(), dtype=torch.float32, device=dev))]))
    aux = E * torch.sum(sums[:E] / (B * S) * (sums[E:] / (B * S * k))) * cfg.router_aux_weight
    ex_in, slot, keep = _dispatch(cfg, xl, gate_vals, expert_idx)
    ex_in = constrain(tp.wrap(ex_in), "moe_in")

    where = p["gate"].placements[tp.m]
    ep = isinstance(where, Shard) and where.dim == 0
    dim = 0 if ep else 2 if isinstance(where, Shard) else None
    gate, up = tp.param(p["gate"], dim)[0], tp.param(p["up"], dim)[0]
    down = tp.param(p["down"], None if dim is None else 0 if ep else 1)[0]
    # TP inside the experts: each rank runs its own slice of every expert
    xin = tp.local(ex_in, 1) if ep else tp.whole_rows(ex_in, partial_grad=dim is not None)
    h = F.silu(einsum("becd,edf->becf", xin, gate)) * einsum("becd,edf->becf", xin, up)
    if dim is not None:
        hdim = 1 if ep else 3
        h = tp.local(constrain(tp.wrap(h, hdim, E if ep else p["gate"].shape[2]), "moe_hidden"), hdim)
    ex_out = einsum("becf,efd->becd", h, down)
    if ep:
        ex_out = tp.gather(ex_out, 1, E)
    elif dim is not None:
        ex_out = tp.psum(ex_out)
    out = _combine(ex_out.reshape(-1, E * C, d), gate_vals, slot, keep).to(x.dtype)
    return tp.wrap(out), aux


def moe_apply_dense_eval(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Oracle: run every expert on every token, combine with router weights
    (no capacity drops). Used by tests to validate the dispatch path."""
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    _, gate_vals, expert_idx = _route(p, cfg, xt)
    w = torch.zeros((xt.shape[0], cfg.n_experts), dtype=torch.float32, device=x.device)
    w.scatter_(1, expert_idx, gate_vals)
    h = F.silu(einsum("td,edf->tef", xt, p["gate"])) * einsum("td,edf->tef", xt, p["up"])
    y = einsum("tef,efd->ted", h, p["down"])
    out = torch.einsum("ted,te->td", y.float(), w)
    return out.reshape(B, S, d).to(x.dtype)
