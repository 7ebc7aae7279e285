"""GQA attention: KV-chunked online-softmax prefill + cached decode.

The reference's formulation, kept as written:

* **Chunked online-softmax attention**: the O(S^2) logits tensor is never
  materialized. Query chunks and, for each, the key chunks it sees are
  Python loops; for causal masks the loop is triangular (fully masked
  tiles are never computed) and sliding windows bound the key-chunk range.
* **Grouped GQA einsums**: Q is reshaped to (B, S, KV, G, hd) and contracted
  against (B, S, KV, hd) K/V, which are never repeated to n_heads.
* **Score/probability precision**: scores and softmax statistics are f32
  (the operands are widened to f32 first, as the reference asks of its
  einsums with ``preferred_element_type``); the post-exp probabilities are
  rounded to ``p_dtype`` (bf16 in bf16 configs) before the PV product.

``F.scaled_dot_product_attention`` is not used: the bf16-probability
numerics are part of the reference.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels.decode_attn.ops import decode_attn

NEG_INF = -1e30
# a decode step's position: an int, or a 0-d int64 tensor on the cache's
# device (the CUDA-graph path's, filled before each replay)
Position = Union[int, torch.Tensor]


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd). Oracle/A-B path only."""
    KV = k.shape[2]
    if KV == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // KV, dim=2)


def _chunk(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, S, ...) -> (S/size, B, size, ...)."""
    B, S = x.shape[:2]
    return x.reshape((B, S // size, size) + tuple(x.shape[2:])).transpose(0, 1)


def _k_range(qi: int, nq: int, chunk: int, causal: bool, window: int) -> Tuple[int, int]:
    hi = (qi + 1) if causal else nq
    lo = max(0, (qi * chunk - window) // chunk) if window else 0
    return lo, hi


def _tile_mask(qi: int, ki: int, chunk: int, causal: bool, window: int,
               rows: torch.Tensor) -> Optional[torch.Tensor]:
    """Keep-mask of tile (qi, ki); None when no tile needs masking."""
    if not causal and not window:
        return None
    qpos = qi * chunk + rows[:, None]
    kpos = ki * chunk + rows[None, :]
    keep = torch.ones((chunk, chunk), dtype=torch.bool, device=rows.device)
    if causal:
        keep &= kpos <= qpos
    if window:
        keep &= kpos > qpos - window
    return keep


def chunked_attention(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, S, KV, hd)
    v: torch.Tensor,  # (B, S, KV, hd)
    *,
    causal: bool,
    window: int = 0,     # 0 = unbounded
    chunk: int = 1024,
    p_dtype: torch.dtype = torch.float32,  # bf16 for bf16 configs (cfg.attn_p_bf16)
    scale: Optional[float] = None,         # softmax scale; None: 1/sqrt(hd)
) -> torch.Tensor:
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    chunk = min(chunk, S)
    assert S % chunk == 0, (S, chunk)
    nq = S // chunk
    scale = 1.0 / (hd ** 0.5) if scale is None else scale

    kf = _chunk(k, chunk)  # (n, B, C, KV, hd) — grouped: no repeat to H
    vf = _chunk(v, chunk)
    qf = _chunk(q.reshape(B, S, KV, G, hd), chunk)  # (n, B, C, KV, G, hd)
    rows = torch.arange(chunk, device=q.device)

    out_chunks = []
    for qi in range(nq):
        lo, hi = _k_range(qi, nq, chunk, causal, window)
        qb = (qf[qi] * scale).to(q.dtype).float()  # (B, C, KV, G, hd)
        m = torch.full((B, chunk, KV, G), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, chunk, KV, G), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, chunk, KV, G, hd), dtype=torch.float32, device=q.device)
        for ki in range(lo, hi):
            s = torch.einsum("bqkgd,bckd->bqkgc", qb, kf[ki].float())
            mask = _tile_mask(qi, ki, chunk, causal, window, rows)
            if mask is not None:
                s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None]).to(p_dtype)  # stored compactly
            alpha = torch.exp(m - m_new)
            pf = p.float()
            l = l * alpha + torch.sum(pf, dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqkgc,bckd->bqkgd", pf, vf[ki].to(p_dtype).float())
            m = m_new
        out_chunks.append((acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype))

    out = torch.stack(out_chunks, dim=1)  # (B, nq, C, KV, G, hd)
    return out.reshape(B, S, H, hd)


def over_local_heads(fn: Callable, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``fn(q, k, v)`` -> (B, S, H, hd) on each rank's own query heads.

    On DTensors the attention core runs on local shards: q (B, S, H, hd)
    keeps its batch and head sharding, k and v (B, S, KV, hd) their batch
    sharding with every KV head on every rank (the ``attn_q`` / ``attn_kv``
    layouts; other layouts are brought to these). A rank whose heads cover
    whole KV groups contracts against those groups' K/V; one whose heads
    split a group takes each head's K/V (G = 1), which is the same per-head
    arithmetic. Needs no collective."""
    if not isinstance(q, DTensor):
        return fn(q, k, v)
    mesh = q.device_mesh
    q_pl = tuple(p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate() for p in q.placements)
    kv_pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in q_pl)
    q = q.redistribute(mesh, q_pl) if q.placements != q_pl else q
    k, v = (t.redistribute(mesh, kv_pl) if t.placements != kv_pl else t for t in (k, v))
    from repro_torch.launch.act_sharding import local_block

    local, offset = local_block(q.shape, mesh, q_pl)
    H, KV = q.shape[2], k.shape[2]
    G, h0, n = H // KV, offset[2], local[2]
    ql = q.to_local()
    # a rank that holds some of the heads uses its own heads' K/V: their
    # gradients are pending a sum over the ranks
    grad = tuple(Partial() if p == Replicate() and isinstance(qp, Shard) else p
                 for p, qp in zip(kv_pl, q_pl)) if n < H else None
    kl, vl = k.to_local(grad_placements=grad), v.to_local(grad_placements=grad)
    if n < H:
        if h0 % G == 0 and n % G == 0:
            kl, vl = kl[:, :, h0 // G:(h0 + n) // G], vl[:, :, h0 // G:(h0 + n) // G]
        else:
            idx = torch.arange(h0, h0 + n, device=ql.device) // G
            kl, vl = kl[:, :, idx], vl[:, :, idx]
    out = fn(ql, kl, vl)
    return DTensor.from_local(out, mesh, q_pl, run_check=False, shape=q.shape, stride=q.stride())


def _decode_core(qg: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, pos: Position,
                 window: int, scale: float, reduce=lambda s: s) -> torch.Tensor:
    """(B, KV, G, hd) attention of one new token against the caches;
    ``reduce`` sums the scores over the ranks when hd is sharded. ``pos``
    is an int or a 0-d int64 tensor on the caches' device (the same mask)."""
    S = k_cache.shape[1]
    # grouped: contract against the cache directly (no repeat materialization)
    s = reduce(torch.einsum("bkgd,bskd->bkgs", (qg * scale).float(), k_cache.float()))
    idx = torch.arange(S, device=qg.device)
    keep = idx <= pos
    if window:
        keep &= idx > pos - window
    s = torch.where(keep[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(), v_cache.float())


def _seq_dims(cache: DTensor) -> list:
    """The mesh dims that shard a cache's sequence (dim 1)."""
    return [i for i, p in enumerate(cache.placements) if isinstance(p, Shard) and p.dim == 1]


def _decode_on_shards(qg: DTensor, k_cache: DTensor, v_cache: DTensor, pos: int, window: int,
                      scale: float) -> DTensor:
    """``_decode_core`` on each rank's shards of a cache laid out by
    ``cache_shardings`` (batch, and kv heads or head dim, sharded): the
    query follows the cache's layout, and with the head dim sharded the
    scores are all-reduced over its axes before the softmax. A cache
    sharded along the sequence (``long_500k``'s ``cache_seq``) gives each
    rank its positions' scores, with the window and ``pos`` masks at their
    global positions, and the ranks' softmaxes are combined by log-sum-exp:
    an all-reduce of the running max, then of the exp-sums and of the
    weighted values."""
    from repro_torch.launch.act_sharding import contiguous_stride, local_block

    mesh = k_cache.device_mesh
    seq = _seq_dims(k_cache)
    to_q = {0: Shard(0), 2: Shard(1), 3: Shard(3)}
    q_pl, part, s_pl = [], [], []
    for p in k_cache.placements:
        if isinstance(p, Shard) and p.dim == 1:
            q_pl.append(Replicate())
            part.append(Shard(3))
            s_pl.append(Shard(3))
            continue
        if isinstance(p, Shard) and p.dim not in to_q:
            raise ValueError(f"decode over a cache sharded at dim {p.dim} is not supported")
        q_pl.append(to_q[p.dim] if isinstance(p, Shard) else Replicate())
        part.append(Partial() if isinstance(p, Shard) and p.dim == 3 else q_pl[-1])
        s_pl.append(Replicate() if isinstance(part[-1], Partial) else part[-1])
    q_pl, part, s_pl = tuple(q_pl), tuple(part), tuple(s_pl)
    qg = qg.redistribute(mesh, q_pl) if tuple(qg.placements) != q_pl else qg
    if tuple(v_cache.placements) != tuple(k_cache.placements):
        v_cache = v_cache.redistribute(mesh, k_cache.placements)
    B, KV, G, _ = qg.shape
    s_shape = (B, KV, G, k_cache.shape[1])

    def reduce(s):
        if s_pl == part:
            return s
        return DTensor.from_local(s, mesh, part, run_check=False, shape=s_shape, stride=contiguous_stride(s_shape)
                                  ).redistribute(mesh, s_pl).to_local()

    ql, kl, vl = qg.to_local(), k_cache.to_local(), v_cache.to_local()
    if not seq:
        out = _decode_core(ql, kl, vl, pos, window, scale, reduce)
    else:
        def combine(t, layout, shape, op):
            pl = tuple(Partial(op) if i in seq else p for i, p in enumerate(layout))
            whole = tuple(Replicate() if i in seq else p for i, p in enumerate(layout))
            return DTensor.from_local(t, mesh, pl, run_check=False, shape=shape, stride=contiguous_stride(shape)
                                      ).redistribute(mesh, whole).to_local()

        s0 = local_block(k_cache.shape, mesh, k_cache.placements)[1][1]
        s = reduce(torch.einsum("bkgd,bskd->bkgs", (ql * scale).float(), kl.float()))
        idx = s0 + torch.arange(kl.shape[1], device=ql.device)
        keep = idx <= pos
        if window:
            keep &= idx > pos - window
        s = torch.where(keep[None, None, None, :], s, NEG_INF)
        m = combine(torch.amax(s, dim=-1), s_pl, (B, KV, G), "max")
        p = torch.exp(s - m[..., None])
        total = combine(torch.sum(p, dim=-1), s_pl, (B, KV, G), "sum")
        acc = combine(torch.einsum("bkgs,bskd->bkgd", p.to(vl.dtype).float(), vl.float()), q_pl,
                      tuple(qg.shape), "sum")
        out = acc / total[..., None]
    return DTensor.from_local(out, mesh, q_pl, run_check=False, shape=qg.shape, stride=contiguous_stride(qg.shape))


def decode_attention(
    q: torch.Tensor,        # (B, H, hd) — single new token
    k_cache: torch.Tensor,  # (B, S, KV, hd)
    v_cache: torch.Tensor,  # (B, S, KV, hd)
    pos: Position,          # index of the new token
    *,
    window: int = 0,
    scale: Optional[float] = None,  # softmax scale; None: 1/sqrt(hd)
) -> torch.Tensor:
    """On DTensors the attention runs on each rank's shards of the cache
    (``_decode_on_shards``); on one device it is the ``decode_attn`` op:
    the CUDA kernel on the card, ``_decode_core`` on the CPU."""
    from repro_torch.launch.act_sharding import constrain, merge_dims, split_dim

    B, S, KV, hd = k_cache.shape
    H = q.shape[1]
    G = H // KV
    # pin the query to the cache's TP layout (kv- or hd-sharded, see
    # launch/shardings.cache_shardings) before the einsums
    qg = constrain(split_dim(q, 1, (KV, G)), "decode_q")
    scale = 1.0 / (hd ** 0.5) if scale is None else scale
    if isinstance(k_cache, DTensor):
        out = _decode_on_shards(qg, k_cache, v_cache, pos, window, scale)
    else:
        out = decode_attn(qg, k_cache, v_cache, pos, window=window, scale=scale)
    out = constrain(out, "decode_q")
    return merge_dims(out, 1).to(q.dtype)


def update_kv_cache(
    k_cache: torch.Tensor,  # (B, S, KV, hd)
    v_cache: torch.Tensor,
    k_new: torch.Tensor,    # (B, KV, hd)
    v_new: torch.Tensor,
    pos: Position,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Writes the new token's K/V at ``pos`` in place; returns the caches.
    A cache sharded along the sequence is written only on the ranks that
    hold position ``pos`` (an int there). A 0-d tensor ``pos`` is read on
    the device, where a captured step reads it."""
    if isinstance(k_cache, DTensor) and _seq_dims(k_cache):
        _write_on_owner(k_cache, k_new, pos)
        _write_on_owner(v_cache, v_new, pos)
        return k_cache, v_cache
    if isinstance(pos, torch.Tensor):
        k_cache.index_copy_(1, pos.view(1), k_new.to(k_cache.dtype)[:, None])
        v_cache.index_copy_(1, pos.view(1), v_new.to(v_cache.dtype)[:, None])
        return k_cache, v_cache
    k_cache[:, pos] = k_new.to(k_cache.dtype)
    v_cache[:, pos] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def _write_on_owner(cache: DTensor, new: torch.Tensor, pos: int) -> None:
    """``cache[:, pos] = new`` on the ranks whose block of the sequence holds
    ``pos``: ``new`` (B, KV, hd) is brought to the cache's layout without its
    sequence dim (a collective every rank takes part in), then written into
    the owners' local blocks."""
    from repro_torch.launch.act_sharding import local_block

    mesh = cache.device_mesh
    row = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else
                Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1 else p for p in cache.placements)
    new = new.to(cache.dtype)
    if tuple(new.placements) != row:
        new = new.redistribute(mesh, row)
    local, offset = local_block(cache.shape, mesh, cache.placements)
    if offset[1] <= pos < offset[1] + local[1]:
        cache.to_local()[:, pos - offset[1]] = new.to_local()


def reference_attention(q, k, v, *, causal, window=0):
    """O(S^2) oracle for tests (repeat-based, f32 throughout)."""
    B, S, H, hd = q.shape
    kf = _repeat_kv(k, H)
    vf = _repeat_kv(v, H)
    s = torch.einsum("bqhd,bkhd->bhqk", (q / (hd ** 0.5)).float(), kf.float())
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    keep = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        keep &= kpos <= qpos
    if window:
        keep &= kpos > qpos - window
    s = torch.where(keep[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf.float()).to(q.dtype)


# --------------------------------------------------------------- A/B pair
def chunked_attention_repeat(q, k, v, *, causal, window=0, chunk=1024, scale=None):
    """Repeat-based GQA baseline behind ``cfg.attn_grouped=False``: K/V
    repeated to n_heads before the einsums, f32 probabilities; equal to the
    grouped path at f32. ``scale`` as in ``chunked_attention``."""
    B, S, H, hd = q.shape
    chunk = min(chunk, S)
    nq = S // chunk
    scale = 1.0 / (hd ** 0.5) if scale is None else scale
    kf = _chunk(_repeat_kv(k, H), chunk)
    vf = _chunk(_repeat_kv(v, H), chunk)
    qf = _chunk(q, chunk)
    rows = torch.arange(chunk, device=q.device)
    out_chunks = []
    for qi in range(nq):
        lo, hi = _k_range(qi, nq, chunk, causal, window)
        qb = (qf[qi] * scale).float()
        m = torch.full((B, chunk, H), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, chunk, H), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, chunk, H, hd), dtype=torch.float32, device=q.device)
        for ki in range(lo, hi):
            s = torch.einsum("bqhd,bkhd->bqhk", qb, kf[ki].float())
            mask = _tile_mask(qi, ki, chunk, causal, window, rows)
            if mask is not None:
                s = torch.where(mask[None, :, None, :], s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + torch.sum(p, dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bqhk,bkhd->bqhd", p, vf[ki].float())
            m = m_new
        out_chunks.append((acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype))
    return torch.stack(out_chunks, dim=1).reshape(B, S, H, hd)


def decode_attention_repeat(q, k_cache, v_cache, pos, *, window=0, scale=None):
    """Repeat-based decode baseline behind ``cfg.attn_grouped=False``."""
    B, S, KV, hd = k_cache.shape
    H = q.shape[1]
    kf = _repeat_kv(k_cache, H)
    vf = _repeat_kv(v_cache, H)
    scale = 1.0 / (hd ** 0.5) if scale is None else scale
    s = torch.einsum("bhd,bkhd->bhk", (q * scale).float(), kf.float())
    idx = torch.arange(S, device=q.device)
    keep = idx <= pos
    if window:
        keep &= idx > pos - window
    s = torch.where(keep[None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p, vf.float()).to(q.dtype)
