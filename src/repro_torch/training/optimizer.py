"""AdamW + schedules, written by hand over the parameter tree.

States mirror the parameter tree, laid out as the parameters are (on a
mesh, DTensors sharded alike: ``opt_state_shardings``); m and v ride in f32 beside bf16
parameters, and the f32 master copy lives in the optimizer state (standard
mixed precision). The update follows the reference's order of operations,
``master - lr * (mhat / (sqrt(vhat) + eps) + wd * master)``, then casts the
new master to ``param_dtype``: every parameter, the f32-specified SSM and
router leaves too, is bf16 after the first update, as in the reference.
``torch.optim.AdamW`` is not used: it decays and bias-corrects in another
order and keeps no f32 master copy.

Trees are nested dicts of tensors; leaves are visited in sorted-key order,
the order ``jax.tree.leaves`` gives, so sums over leaves add in the same
order.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Tuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Any       # f32, param-tree
    v: Any       # f32, param-tree
    master: Any  # f32 master copy of params


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves of a nested dict in sorted-key order (``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """The inverse of :func:`tree_leaves` over the structure of ``like``."""
    return _unflatten(like, iter(leaves))


def _unflatten(node: Any, it) -> Any:
    # not a closure over itself: that cycle would hold ``leaves`` (a step's
    # gradients or new weights) until the cyclic collector runs
    if isinstance(node, dict):
        return {k: _unflatten(node[k], it) for k in sorted(node)}
    return next(it)


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def adamw_init(params) -> AdamWState:
    device = tree_leaves(params)[0].device
    with torch.no_grad():
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            m=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
            v=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
            master=tree_map(lambda p: p.detach().float().clone(), params),
        )


def clip_by_global_norm(grads, max_norm: float):
    """-> (f32 grads scaled to a global norm of at most ``max_norm``, the
    global norm before clipping). No host sync. On DTensors the squares'
    sums are reduced over every mesh axis that shards a gradient."""
    leaves = tree_leaves(grads)
    total = sum(torch.sum(torch.square(g.float())) for g in leaves)
    gnorm = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), gnorm


@torch.no_grad()
def adamw_update(
    grads,
    state: AdamWState,
    lr: torch.Tensor,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    param_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[Any, AdamWState]:
    """-> (new parameters in ``param_dtype``, new state)."""
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t

    def upd(g, m, v, master):
        g = g.float()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        new_master = master - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * master)
        return m, v, new_master

    new_m, new_v, new_ma = [], [], []
    for g, m, v, ma in zip(tree_leaves(grads), tree_leaves(state.m), tree_leaves(state.v),
                           tree_leaves(state.master)):
        m2, v2, ma2 = upd(g, m, v, ma)
        new_m.append(m2)
        new_v.append(v2)
        new_ma.append(ma2)
    params = tree_unflatten(grads, [ma.to(param_dtype) for ma in new_ma])
    return params, AdamWState(
        step=step,
        m=tree_unflatten(grads, new_m),
        v=tree_unflatten(grads, new_v),
        master=tree_unflatten(grads, new_ma),
    )


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """step (int tensor) -> f32 learning rate: linear warmup, then cosine
    decay to 0 at ``total``."""
    def lr_at(step: torch.Tensor) -> torch.Tensor:
        t = step.float()
        warm = base_lr * t / max(warmup, 1)
        prog = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * prog))
        return torch.where(t < warmup, warm, cos)

    return lr_at
