"""Mixture-of-Experts FFN: top-k router + capacity-bounded scatter dispatch.

  1. router logits -> softmax -> top-k experts per token, weights renormalized;
  2. position-in-expert via cumsum over each row's flattened (token, choice)
     lattice; tokens beyond ``capacity = cf * S * k / E`` are dropped;
  3. scatter tokens into a dense (B, E, C, d) buffer, grouped-matmul the
     expert FFNs;
  4. gather back with combine weights; aux load-balance loss (Switch-style).

Dispatch is row-local: position-in-expert and the scatter/gather stay within
each sequence, with per-row capacity ``S*k*cf/E``.

``moe_apply_dropless`` is the inference path of the ``layered`` family, on
one card and off a mesh: every (token, choice) pair is routed, sorted by
expert, and the experts run as grouped GEMMs over their contiguous runs
(``grouped_mm``: the library's ``torch._grouped_mm`` on the card in bf16,
a plain loop over the experts otherwise); a shared gated-SiLU expert runs beside them
(``shared_expert``). While a model serves, ``counting`` points the MoE
layers at its ``MoeCounters``.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from repro_torch.config.model import ModelConfig
from repro_torch.launch.act_sharding import ModelAxis, constrain
from repro_torch.models.layers import einsum, matmul
from repro_torch.models.spec import TensorSpec

# the most tokens one grouped-GEMM call of the dropless path takes: a
# prefill's layer runs in calls of this many tokens, which bounds the sorted
# rows and expert outputs it holds (16,384 tokens x 10 pairs x d 4,096 in
# bf16 is 1.3 GB each)
DROPLESS_TOKENS = 16384
# the phases ``MoeCounters`` counts the dropless path's layer calls by
PHASES = ("prefill", "decode")


class MoeCounters:
    """Routing counters of a model's MoE layers while it serves, read once
    by ``read``: ``moe_pairs_routed`` (token, choice) pairs routed;
    ``moe_pairs_dropped`` of them dropped past an expert's capacity (0 on
    the dropless path by construction); ``moe_max_expert_share`` the
    largest share of one layer call's pairs on one expert; by phase
    (``prefill``, ``decode``) on the dropless path, ``expert_gemm_calls``
    grouped-GEMM launches, ``expert_tokens`` tokens through the layer calls
    and ``experts_used`` experts with a non-empty run, summed over the layer
    calls. Every count lives on the device (no layer reads one back), a 0-d
    tensor made by its first call and accumulated in place after, so that a
    decode step replayed from a CUDA graph adds to each by itself."""

    def __init__(self) -> None:
        # "pairs_routed", "dropped", (count, phase): int64 sums
        self.totals: Dict[Any, torch.Tensor] = {}
        self.max_share: Optional[torch.Tensor] = None

    def _add(self, key: Any, count, device: torch.device) -> None:
        total = self.totals.get(key)
        if total is None:
            total = self.totals[key] = torch.zeros((), dtype=torch.int64, device=device)
        total.add_(count)

    def routed(self, pairs: int, max_share: torch.Tensor, dropped: Optional[torch.Tensor] = None) -> None:
        self._add("pairs_routed", pairs, max_share.device)
        share = max_share.detach().float()
        if self.max_share is None:
            self.max_share = share.clone()
        else:
            torch.maximum(self.max_share, share, out=self.max_share)
        if dropped is not None:
            self._add("dropped", dropped, dropped.device)

    def grouped(self, phase: str, tokens: int, launches: int, used: torch.Tensor) -> None:
        """One dropless layer call of ``phase``: its tokens, its grouped-GEMM
        launches and the experts its pairs reached (on the device)."""
        for key, count in (("tokens", tokens), ("gemm_calls", launches), ("experts_used", used)):
            self._add((key, phase), count, used.device)

    def read(self) -> dict:
        n = lambda key: int(self.totals[key]) if key in self.totals else 0
        by_phase = lambda key: {ph: n((key, ph)) for ph in PHASES}
        return {"moe_pairs_routed": n("pairs_routed"),
                "moe_pairs_dropped": n("dropped"),
                "moe_max_expert_share": 0.0 if self.max_share is None else float(self.max_share),
                "expert_gemm_calls": by_phase("gemm_calls"),
                "expert_tokens": by_phase("tokens"),
                "experts_used": by_phase("experts_used")}


_COUNTING: contextvars.ContextVar = contextvars.ContextVar("moe_counting", default=(None, ""))


@contextlib.contextmanager
def counting(counters: MoeCounters, phase: str):
    """MoE layers called inside count into ``counters`` under ``phase``."""
    token = _COUNTING.set((counters, phase))
    try:
        yield
    finally:
        _COUNTING.reset(token)


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
    counters = _COUNTING.get()[0]
    if counters is not None:
        counters.routed(B * S * k, ce.max(), dropped=(~keep).sum())

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


def shared_specs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.shared_d_ff
    return {
        "gate": TensorSpec((d, f), ("embed", "mlp")),
        "up": TensorSpec((d, f), ("embed", "mlp")),
        "down": TensorSpec((f, d), ("mlp", "embed")),
    }


def moe_apply_dropless(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (..., d) -> (..., d), every (token, choice) pair routed (no
    capacity, no drop), in calls of at most ``DROPLESS_TOKENS`` tokens. No
    step of it reads a value back to the host."""
    xt = x.reshape(-1, x.shape[-1])
    parts = [_dropless_rows(p, cfg, xt[t0:t0 + DROPLESS_TOKENS])
             for t0 in range(0, xt.shape[0], DROPLESS_TOKENS)]
    return (parts[0] if len(parts) == 1 else torch.cat(parts)).reshape(x.shape)


def _dropless_rows(p: dict, cfg: ModelConfig, xt: torch.Tensor) -> torch.Tensor:
    """The routed experts over tokens ``xt`` (T, d): the pairs sorted by
    expert (a stable sort: within an expert, in token order), each expert's
    run through the gated-SiLU FFN as grouped GEMMs (``expert_ffn``), and
    the outputs weighted by their gates and summed into the tokens' rows in
    float32."""
    T, d = xt.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    _, gates, experts = _route(p, cfg, xt)                               # (T, k)
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)
    offsets = torch.searchsorted(flat[order], torch.arange(E + 1, device=xt.device, dtype=flat.dtype))
    y = expert_ffn(xt[order // k], offsets, p["gate"], p["up"], p["down"])
    pairs = torch.empty_like(y)
    pairs[order] = y                                                     # back to (token, choice) order
    out = torch.bmm(gates[:, None, :], pairs.view(T, k, d).float())[:, 0]
    counters, phase = _COUNTING.get()
    if counters is not None:
        counts = offsets[1:] - offsets[:-1]
        counters.routed(T * k, counts.max().float() / (T * k))
        counters.grouped(phase, T, 3, (counts > 0).sum())
    return out.to(xt.dtype)


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Each expert's run of rows times its own weight:
    ``y[offsets[e]:offsets[e + 1]] = x[offsets[e]:offsets[e + 1]] @ w[e]``,
    for ``x`` (M, K) sorted by expert, ``w`` (E, K, N) and ``offsets``
    (E + 1,) on ``x``'s device -> (M, N) in ``x``'s type. On a CUDA tensor
    in bf16 the library's grouped GEMM (``library_grouped_mm``), otherwise
    the plain version."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        return library_grouped_mm(x, w, offsets)
    return grouped_mm_ref(x, w, offsets)


def library_grouped_mm(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """``grouped_mm`` as one launch of ``torch._grouped_mm`` (bf16 operands,
    f32 sums, one rounding): it takes the runs' ends, read on the device,
    so nothing is synchronised with the host."""
    return torch._grouped_mm(x, w, offs=offsets[1:].to(torch.int32))


def grouped_mm_ref(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """The plain version of ``grouped_mm``: a loop over the experts (their
    bounds read on the host), each run times its weight in float32, rounded
    once to ``x``'s type."""
    out = x.new_zeros((x.shape[0], w.shape[-1]))
    bounds = offsets.tolist()
    for e in range(w.shape[0]):
        a, b = bounds[e], bounds[e + 1]
        if a < b:
            out[a:b] = (x[a:b].float() @ w[e].float()).to(out.dtype)
    return out


def expert_ffn(x: torch.Tensor, offsets: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
               down: torch.Tensor) -> torch.Tensor:
    """The gated-SiLU experts over rows sorted by expert: three grouped
    GEMMs, ``silu(x gate) * (x up)`` taken in float32 and rounded once."""
    h = F.silu(grouped_mm(x, gate, offsets).float()) * grouped_mm(x, up, offsets).float()
    return grouped_mm(h.to(x.dtype), down, offsets)


def shared_expert(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The always-on gated-SiLU expert of every token."""
    return matmul(F.silu(matmul(x, p["gate"])) * matmul(x, p["up"]), p["down"])
