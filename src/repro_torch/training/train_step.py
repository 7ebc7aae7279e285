"""Train step factory: loss -> grads -> (optional compression) -> AdamW.

    state = train_state_init(model, generator, compression=False)
    step = make_train_step(model, cosine_schedule(3e-4, 20, 100))
    state, metrics = step(state, batch)   # metrics: loss, gnorm, lr, step

The model owns its weights: ``TrainState.params`` is the model's parameter
tree (its ``nn.Parameter`` objects, keyed as the reference's tree), and a
step writes the new weights into them in place. Knobs:

  * **microbatching** — gradient accumulation in f32 over microbatches (a
    Python loop in place of the reference's ``lax.scan``), loss averaged;
  * **gradient compression** — int8 + error feedback on the gradients
    (state rides in ``TrainState.comp``);
  * global-norm clipping, then AdamW with an f32 master copy.

A step never syncs the host with the device: every metric is a tensor.

On a mesh (a model placed by ``launch.shardings.place_model``, its state
laid out by ``opt_state_shardings``) the step runs on DTensors: each
gradient is brought to its parameter's layout (an FSDP leaf's is
reduce-scattered, a replicated leaf's all-reduced), the update is pointwise
over identically sharded trees, microbatches split each rank's own rows,
and the metrics come out as plain tensors equal on every rank.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.distributed.compression import CompressionState, int8_compress, int8_decompress
from repro_torch.launch.act_sharding import contiguous_stride
from repro_torch.models.model import Model
from repro_torch.models.spec import tree_init
from repro_torch.training.optimizer import (
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    tree_leaves,
    tree_map,
    tree_unflatten,
)


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    comp: Optional[Any]  # CompressionState tree or None


@torch.no_grad()
def train_state_init(model: Model, generator: Optional[torch.Generator] = None,
                     compression: bool = False) -> TrainState:
    """Draw the model's weights from ``generator`` (in place; None keeps
    the weights it has) and start AdamW and, with ``compression``, the
    error-feedback residuals from them."""
    params = model.params()
    if generator is not None:
        fresh = tree_init(model.param_specs(), generator, model.device)
        for p, new in zip(tree_leaves(params), tree_leaves(fresh)):
            p.data = new
    comp = None
    if compression:
        comp = tree_map(lambda p: CompressionState(torch.zeros_like(p, dtype=torch.float32)), params)
    return TrainState(params, adamw_init(params), comp)


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int):
    """``n`` microbatches of consecutive rows; a DTensor batch is split on
    each rank's own rows (its batch stays sharded, no collective)."""
    def split(x):
        if isinstance(x, DTensor):
            local = x.to_local()
            shape = (x.shape[0] // n,) + tuple(x.shape[1:])
            return [DTensor.from_local(part, x.device_mesh, x.placements, run_check=False, shape=shape,
                                       stride=contiguous_stride(shape)) for part in split(local)]
        B = x.shape[0]
        assert B % n == 0, (B, n)
        return x.reshape((n, B // n) + tuple(x.shape[1:]))

    parts = {k: split(v if isinstance(v, DTensor) else torch.as_tensor(v)) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _as_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient in its parameter's layout (the reduce-scatter or the
    all-reduce of a DTensor gradient that is pending a sum)."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A metric as a plain tensor: a DTensor's value, replicated."""
    if isinstance(t, DTensor):
        return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim).to_local()
    return t


def make_train_step(
    model: Model,
    lr_schedule: Callable[[torch.Tensor], torch.Tensor],
    *,
    microbatches: int = 1,
    grad_clip: float = 1.0,
    compression: bool = False,
    weight_decay: float = 0.1,
):
    """Returns train_step(state, batch) -> (state, metrics)."""

    def grads_of(params, mb):
        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None
        loss, _ = model.loss(mb)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else _as_param(p.grad, p) for p in leaves]
        for p in leaves:
            p.grad = None
        return loss.detach(), tree_unflatten(params, grads)

    def train_step(state: TrainState, batch: Dict[str, Any]):
        with model._placed():
            return _step(state, batch)

    def _step(state: TrainState, batch: Dict[str, Any]):
        if microbatches == 1:
            loss, grads = grads_of(state.params, batch)
        else:
            gsum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), state.params)
            lsum = torch.zeros((), dtype=torch.float32, device=model.device)
            for mb in _split_microbatches(batch, microbatches):
                l, g = grads_of(state.params, mb)
                gsum = tree_map(lambda a, b: a + b.float(), gsum, g)
                lsum = lsum + l
            grads = tree_map(lambda g: g / microbatches, gsum)
            loss = lsum / microbatches

        comp_state = state.comp
        if compression and comp_state is not None:
            # int8 + error feedback on the data-parallel gradient path
            def comp_one(g, cs):
                q, scale, cs2 = int8_compress(g, cs)
                return int8_decompress(q, scale), cs2

            outs = [comp_one(g, c) for g, c in zip(tree_leaves(grads), tree_leaves(comp_state))]
            grads = tree_unflatten(grads, [o[0] for o in outs])
            comp_state = tree_unflatten(grads, [o[1] for o in outs])

        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        lr = lr_schedule(state.opt.step)
        params, opt = adamw_update(grads, state.opt, lr, weight_decay=weight_decay)
        _write_params(state.params, params)
        out_metrics = {"loss": _plain(loss), "gnorm": _plain(gnorm), "lr": lr, "step": opt.step}
        return TrainState(state.params, opt, comp_state), out_metrics

    return train_step


@torch.no_grad()
def _write_params(params, new) -> None:
    """New weights into the model's parameters, in place; a parameter whose
    dtype changes (an f32-specified leaf after its first update) takes the
    new tensor's storage (a DTensor's by a swap: ``.data`` of a DTensor
    would change its dtype and keep its old local tensor)."""
    for p, n in zip(tree_leaves(params), tree_leaves(new)):
        if p.dtype == n.dtype:
            p.copy_(n)
        elif isinstance(p, DTensor):
            torch.utils.swap_tensors(p, torch.nn.Parameter(n, requires_grad=p.requires_grad))
        else:
            p.data = n
