"""Model assembly: specs, losses, prefill and decode steps for every family.

    model = build_model(cfg, device)      # weights drawn from a seeded generator
    specs = model.param_specs()           # TensorSpec tree (shapes + logical axes)
    loss, metrics = model.loss(batch)     # forward
    logits, cache = model.prefill(batch)
    logits, cache = model.decode_step(tokens, cache, pos)

A ``layered`` model (``LayeredConfig``) runs Mamba-2 or attention per its
``layer_types``, each followed by dropless routed experts and a shared
expert; its decode step reads nothing back to the host.

``Model.grow_cache`` turns a prefill's cache into the cache the decode
steps run on, for every family and placement, by the axes of its
``cache_specs``. On one card, a dense, VLM or layered model holds a decode
cache for each batch shape it serves (every leaf of its ``cache_specs``); a
decode step on that cache is captured as a CUDA graph at its first step and
replayed for every later one. Every other decode runs the same body eagerly.

Parameters are registered as stacked tensors under the dotted paths of the
reference's parameter tree (``layers.attn.wq`` of shape (L, d, H*hd),
``groups.mamba.in_proj``, ``shared.attn.wq``, ...); the layer loops run in
Python over views of the stacked leading axis (``unbind``: one autograd node
a leaf, whose backward stacks the layers' gradients once).

Under autograd the loss honours ``cfg.remat`` per layer (per group for the
hybrid), as the reference's ``jax.checkpoint`` does: ``"full"`` keeps only
each layer's input and recomputes the layer in the backward pass,
``"dots"`` keeps the outputs of the plain (non-batched) matmuls and
recomputes the rest, ``"none"`` keeps everything. Without grad (prefill,
decode, an eval loss) nothing is checkpointed. ``cfg.scan_unroll`` does
nothing. Decode writes its cache in place.

On a mesh (``launch.shardings.place_model``) the parameters are DTensors;
inputs, caches and steps follow them, and the ``constrain`` calls pin the
activations where the reference's do (``launch.act_sharding``).
"""
from __future__ import annotations

import contextlib
import functools
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.config.model import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.act_sharding import add_residual, captured, constrain, implicitly_replicated
from repro_torch.models import blocks, moe, ssm
from repro_torch.models.layers import chunked_ce_loss, embed_specs, embed_tokens, head_matrix, matmul, rms_norm
from repro_torch.models.spec import SpecTree, TensorSpec, tree_abstract, tree_init, tree_items, tree_map

ACT_DTYPE = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the most decode caches, each with its graph, a model holds; the least
# recently used goes first
DECODE_GRAPHS = 4
# the fewest new positions a batch decodes for a cache (and graph) to be
# made for it: a capture costs about what 30 eager steps lose to replays
# (0.55 s at 32 x 2,304 on an H100, where a step replays 18 ms faster)
DECODE_GRAPH_MIN_NEW = 32


def _stack(specs: SpecTree, n: int, axis: str = "layers") -> SpecTree:
    return tree_map(lambda s: TensorSpec((n,) + s.shape, (axis,) + s.axes, s.dtype, s.init, s.scale),
                    specs)


def _at(tree: Dict[str, Any], *idx: int) -> Dict[str, Any]:
    """One layer's slice of a stacked parameter tree (views)."""
    return tree_map(lambda t: t[idx], tree)


def _unstack(tree: Dict[str, Any]) -> List[Dict[str, Any]]:
    """A stacked tree's per-index views along its leading axis."""
    parts = tree_map(lambda t: t.unbind(0), tree)
    n = len(next(leaf for _, leaf in tree_items(parts)))
    return [tree_map(lambda ts: ts[i], parts) for i in range(n)]


# the plain matmuls: what ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``
# keeps (a batched einsum lowers to bmm and is recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn: Callable, policy: str, placed: bool = False) -> Callable:
    """``fn`` under the config's remat policy while autograd records. The
    checkpointed body takes with it the activation rules in force now and,
    on a mesh (``placed``), DTensor's implicit replication: its recompute in
    the backward pass runs the forward's ops and collectives."""
    if policy == "none" or not torch.is_grad_enabled():
        return fn
    kw: Dict[str, Any] = dict(use_reentrant=False, preserve_rng_state=False)
    if policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    elif policy != "full":
        raise ValueError(f"unknown remat policy {policy!r}")
    body = captured(fn, placed=placed)
    return lambda *args: checkpoint(body, *args, **kw)


def _module(tree: Dict[str, Any]) -> nn.Module:
    """A module whose children are the sub-trees and whose parameters are
    the leaves, so ``named_parameters`` yields the tree's dotted paths."""
    node = nn.Module()
    _register(node, tree)
    return node


def _register(node: nn.Module, tree: Dict[str, Any]) -> None:
    for key, val in tree.items():
        if isinstance(val, dict):
            node.add_module(key, _module(val))
        else:
            node.register_parameter(key, nn.Parameter(val))


def _tree(node: nn.Module) -> Dict[str, Any]:
    out: Dict[str, Any] = dict(node.named_parameters(recurse=False))
    out.update({name: _tree(child) for name, child in node.named_children()})
    return out


def param_specs(cfg: ModelConfig) -> SpecTree:
    """The TensorSpec tree of every parameter (no allocation)."""
    specs: SpecTree = {"embed": embed_specs(cfg), "ln_f": TensorSpec((cfg.d_model,), ("embed",), init="ones")}
    if cfg.family in ("dense", "vlm"):
        specs["layers"] = _stack(blocks.dense_layer_specs(cfg), cfg.n_layers)
    elif cfg.family == "encoder":
        specs["layers"] = _stack(blocks.dense_layer_specs(cfg), cfg.n_layers)
        specs["mask_emb"] = TensorSpec((cfg.d_model,), ("embed",))
        specs["head"] = TensorSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    elif cfg.family == "moe":
        specs["layers"] = _stack(blocks.moe_layer_specs(cfg), cfg.n_layers)
    elif cfg.family == "ssm":
        layer = {"ln": TensorSpec((cfg.d_model,), ("embed",), init="ones"), "mamba": ssm.mamba1_specs(cfg)}
        specs["layers"] = _stack(layer, cfg.n_layers)
    elif cfg.family == "hybrid":
        G, A = cfg.n_shared_attn(), cfg.attn_every
        layer = {"ln": TensorSpec((cfg.d_model,), ("embed",), init="ones"), "mamba": ssm.mamba2_specs(cfg)}
        specs["groups"] = _stack(_stack(layer, A, axis="sublayers"), G)
        specs["shared"] = blocks.shared_attn_specs(cfg)
    elif cfg.family == "layered":
        specs["layers"] = _stack(blocks.layered_layer_specs(cfg), cfg.n_layers)
        if cfg.n_mamba:
            specs["mamba"] = _stack(ssm.mamba2_specs(cfg), cfg.n_mamba)
        if cfg.n_attn:
            specs["attn"] = _stack(blocks.attn_specs(cfg), cfg.n_attn)
    else:
        raise ValueError(cfg.family)
    if cfg.family == "encoder":
        # encoder consumes frame embeddings; token table unused -> drop it
        specs["embed"] = {}
    return specs


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> SpecTree:
    """TensorSpec tree for a decode cache of ``cache_len`` tokens."""
    dt = ACT_DTYPE[cfg.dtype]
    KV, hd, K = cfg.n_kv_heads, cfg.hd, cfg.ssm_conv

    def kv(n: int) -> TensorSpec:
        return TensorSpec((n, batch, cache_len, KV, hd),
                          ("layers", "act_batch", "cache_seq", "kv", "hd"), dt, init="zeros")

    if cfg.family in ("dense", "vlm", "moe"):
        return {"k": kv(cfg.n_layers), "v": kv(cfg.n_layers)}
    if cfg.family == "ssm":
        return {
            "ssm": TensorSpec((cfg.n_layers, batch, cfg.d_inner, cfg.ssm_state),
                              ("layers", "act_batch", "ssm_inner", None), torch.float32, init="zeros"),
            "conv": TensorSpec((cfg.n_layers, batch, K - 1, cfg.d_inner),
                               ("layers", "act_batch", None, "ssm_inner"), dt, init="zeros"),
        }
    if cfg.family == "hybrid":
        G, A = cfg.n_shared_attn(), cfg.attn_every
        return {
            "ssm": TensorSpec((G, A, batch, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state),
                              ("layers", "sublayers", "act_batch", "ssm_heads", None, None),
                              torch.float32, init="zeros"),
            "conv": TensorSpec((G, A, batch, K - 1, cfg.d_inner + 2 * cfg.ssm_state),
                               ("layers", "sublayers", "act_batch", None, "ssm_inner"), dt, init="zeros"),
            "k": kv(G),
            "v": kv(G),
        }
    if cfg.family == "layered":
        out = {}
        if cfg.n_mamba:
            out["ssm"] = TensorSpec((cfg.n_mamba, batch, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state),
                                    ("layers", "act_batch", "ssm_heads", None, None), torch.float32,
                                    init="zeros")
            out["conv"] = TensorSpec((cfg.n_mamba, batch, K - 1, cfg.d_inner + 2 * cfg.ssm_state),
                                     ("layers", "act_batch", None, "ssm_inner"), dt, init="zeros")
        if cfg.n_attn:
            out["k"], out["v"] = kv(cfg.n_attn), kv(cfg.n_attn)
        return out
    raise ValueError(cfg.family)


class _DecodeGraph:
    """A decode cache held at one address, and the CUDA graph of a decode
    step on it with its static inputs (the tokens, the position) and output
    (the logits); captured at the cache's first step."""

    def __init__(self, cache: Dict[str, torch.Tensor], batch: int, device: torch.device) -> None:
        self.cache = cache
        self.tokens = torch.zeros(batch, dtype=torch.long, device=device)
        self.pos = torch.zeros((), dtype=torch.long, device=device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None
        # what the graph holds fixed beside the cache: see ``Model._graph_stamp``
        self.stamp: tuple = ()

    def holds(self, cache: Dict[str, torch.Tensor]) -> bool:
        return set(cache) == set(self.cache) and all(cache[n] is t for n, t in self.cache.items())

    def capture(self, step: Callable[[], torch.Tensor], stamp: tuple) -> torch.Tensor:
        """Runs ``step`` once eagerly on a side stream of the cache's card,
        so that lazy initialisation stays out of the graph, then records it
        on that stream; returns the eager run's logits. The eager run is the
        step itself: recording runs nothing, so a state leaf advances once."""
        device = self.tokens.device
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            logits = step()
        current.wait_stream(side)
        logits.record_stream(current)
        self.graph, self.stamp = torch.cuda.CUDAGraph(), stamp
        with torch.cuda.graph(self.graph, stream=side):
            self.logits = step()
        return logits


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device: DeviceLike = None, *,
                 generator: Optional[torch.Generator] = None, init: bool = True) -> None:
        """Weights drawn from ``generator`` (default: seed 0 on ``device``,
        which defaults to ``cuda:0``); with ``init=False`` the parameters
        are allocated and left uninitialised, for the caller to fill. On
        ``device="meta"`` the parameters are meta tensors (no allocation),
        to be placed on a mesh by ``launch.shardings.place_model``."""
        super().__init__()
        self.cfg = cfg
        self.dtype = ACT_DTYPE[cfg.dtype]
        # set by ``place_model``: the mesh the parameters are DTensors on
        self.mesh = None
        # decode steps by path: graphs captured, steps replayed, steps run eagerly
        self.decode_graphs_captured = 0
        self.decode_steps_replayed = 0
        self.decode_steps_eager = 0
        self._decode_graphs: "OrderedDict[tuple, _DecodeGraph]" = OrderedDict()
        # routing counters of the MoE layers while the model serves
        self.moe_stats = moe.MoeCounters()
        if device is not None and torch.device(device).type == "meta":
            _register(self, self.abstract_params())
            return
        dev = resolve_device(device)
        if not init:
            _register(self, tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device=dev),
                                     self.param_specs()))
            return
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        _register(self, tree_init(self.param_specs(), generator, dev))

    @property
    def device(self) -> torch.device:
        return self.ln_f.device

    def _placed(self):
        """Plain tensors made inside a placed model's step (positions,
        masks, RoPE tables, buffers) take part as replicated DTensors."""
        return implicitly_replicated() if self.mesh is not None else contextlib.nullcontext()

    def params(self) -> Dict[str, Any]:
        """The parameters as a nested dict, keyed as the reference's tree."""
        return _tree(self)

    # ================================================================ specs
    def param_specs(self) -> SpecTree:
        return param_specs(self.cfg)

    def abstract_params(self) -> Dict[str, Any]:
        return tree_abstract(self.param_specs())

    def _input(self, x) -> torch.Tensor:
        """An input on the model's device; on a mesh, a DTensor with its
        batch over the data axes, or replicated where the batch is one row
        (``launch.shardings.input_shardings``)."""
        if isinstance(x, DTensor):
            return x
        x = torch.as_tensor(x, device=self.device)
        if self.mesh is None:
            return x
        from repro_torch.launch.shardings import batch_pspec, to_placements

        spec = batch_pspec(self.mesh, x.ndim) if x.ndim and x.shape[0] > 1 else ()
        return distribute_tensor(x, self.mesh, to_placements(spec, self.mesh), src_data_rank=None)

    def _embed(self, params, batch) -> torch.Tensor:
        x = self._embed_tokens(params, self._input(batch["tokens"]).long())
        if self.cfg.family == "vlm":
            x = torch.cat([self._input(batch["patch_embeds"]).to(self.dtype), x], dim=1)
        return x

    def _embed_tokens(self, params, tokens) -> torch.Tensor:
        """Token embeddings; a ``layered`` stack scales them by its
        ``embedding_multiplier`` in float32."""
        if self.cfg.family != "layered":
            return embed_tokens(params["embed"], tokens, self.dtype)
        x = embed_tokens(params["embed"], tokens, torch.float32)
        return (x * self.cfg.embedding_multiplier).to(self.dtype)

    def _head(self, params, x) -> torch.Tensor:
        """Float32 logits of the normed hidden states ``x``; a ``layered``
        stack divides them by its ``logits_scaling``."""
        logits = matmul(x, head_matrix(params["embed"], self.cfg)).float()
        return logits / self.cfg.logits_scaling if self.cfg.family == "layered" else logits

    def moe_counters(self) -> dict:
        """The MoE layers' routing counters (``moe.MoeCounters``), read back
        from the device once."""
        return self.moe_stats.read()

    def _positions(self, S: int) -> torch.Tensor:
        return torch.arange(S, dtype=torch.int32, device=self.device)

    # ================================================================ loss
    def loss(self, batch: Dict[str, Any]) -> Tuple[torch.Tensor, Dict]:
        """Chunked CE (+ the MoE aux loss); differentiable, ``cfg.remat``
        applied per layer while autograd records."""
        with self._placed():
            return self._loss(batch)

    def _loss(self, batch: Dict[str, Any]) -> Tuple[torch.Tensor, Dict]:
        cfg, params = self.cfg, self.params()
        labels = self._input(batch["labels"]).long()
        if cfg.family == "encoder":
            frames = self._input(batch["frame_embeds"]).to(self.dtype)
            mask = self._input(batch["mask"]).bool()
            x = torch.where(mask[..., None], params["mask_emb"].to(self.dtype), frames)
            labels = torch.where(mask, labels, -1)  # predict only masked frames
        else:
            x = self._embed(params, batch)
        x, aux, _ = self._stack_forward(params, x, self._positions(x.shape[1]), want_cache=False)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        if cfg.family == "encoder":
            head = params["head"]
        else:
            head = head_matrix(params["embed"], cfg)
            if cfg.family == "layered":
                head = head / cfg.logits_scaling
            # loss only over the text region (labels for patches are ignored)
            x = x[:, x.shape[1] - labels.shape[1]:]
        ce = chunked_ce_loss(x, head, labels, cfg.loss_chunk)
        return ce + aux, {"ce": ce, "aux": aux}

    # ============================================================= backbone
    def _stack_forward(self, params, x, positions, *, want_cache: bool):
        """The layer stack over a full sequence: (x, aux, cache); the cache
        (sized to the sequence) is filled only when ``want_cache``. Each
        layer (hybrid: each group) runs under ``cfg.remat``."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        cache: Dict[str, Any] = {}
        # the residual stream's layout between blocks; the reference pins it
        # in the loss and the encoder's forward, not in a decoder's prefill
        res = (lambda t: t) if want_cache else (lambda t: constrain(t, "residual"))
        x = res(x)
        if cfg.family in ("dense", "vlm", "encoder", "moe"):
            if cfg.family == "moe":
                def body(h, lp):
                    return blocks.moe_layer_prefill(lp, cfg, h, positions)
            else:
                def body(h, lp):
                    h, kv = blocks.dense_layer_prefill(lp, cfg, h, positions)
                    return h, kv, None

            layer = _remat(body, cfg.remat, self.mesh is not None)
            ks, vs = [], []
            for lp in _unstack(params["layers"]):
                x, (k, v), a = layer(x, lp)
                x = res(x)
                if a is not None:
                    aux = aux + a
                if want_cache:
                    ks.append(k)
                    vs.append(v)
            if want_cache:
                cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
        elif cfg.family == "ssm":
            def body(h, lp):
                pre = rms_norm(h, lp["ln"], cfg.norm_eps)
                out, h_last = ssm.mamba1_forward(lp["mamba"], cfg, pre)
                return add_residual(h, out), h_last, self._conv_tail(pre, lp["mamba"]) if want_cache else None

            layer = _remat(body, cfg.remat, self.mesh is not None)
            hs, convs = [], []
            for lp in _unstack(params["layers"]):
                x, h_last, conv = layer(x, lp)
                x = res(x)
                if want_cache:
                    hs.append(h_last)
                    convs.append(conv)
            if want_cache:
                cache = {"ssm": torch.stack(hs), "conv": torch.stack(convs)}
        elif cfg.family == "hybrid":
            e0 = x  # concat-skip source (zamba trick)
            G, A = cfg.n_shared_attn(), cfg.attn_every

            def group(h, subs):
                hs, convs = [], []
                for lp in subs:
                    pre = rms_norm(h, lp["ln"], cfg.norm_eps)
                    out, h_last = ssm.mamba2_forward(lp["mamba"], cfg, pre)
                    if want_cache:
                        hs.append(h_last)
                        convs.append(self._conv_tail(pre, lp["mamba"]))
                    h = res(add_residual(h, out))
                h, kv = blocks.shared_attn_prefill(params["shared"], cfg, h, e0, positions)
                return res(h), hs, convs, kv

            layer = _remat(group, cfg.remat, self.mesh is not None)
            hs, convs, ks, vs = [], [], [], []
            for gp in _unstack(params["groups"]):
                x, h_g, c_g, (k, v) = layer(x, _unstack(gp))
                if want_cache:
                    hs.extend(h_g)
                    convs.extend(c_g)
                    ks.append(k)
                    vs.append(v)
            if want_cache:
                stack2 = lambda ts: torch.stack(ts).reshape((G, A) + tuple(ts[0].shape))
                cache = {"ssm": stack2(hs), "conv": stack2(convs),
                         "k": torch.stack(ks), "v": torch.stack(vs)}
        elif cfg.family == "layered":
            state = {"ssm": [], "conv": [], "k": [], "v": []}
            mixers = {kind: _unstack(params[key]) for kind, key in (("mamba", "mamba"), ("attention", "attn"))
                      if key in params}
            for i, (lp, kind) in enumerate(zip(_unstack(params["layers"]), cfg.layer_types)):
                mp = mixers[kind][cfg.mixer_index(i)]
                layer = _remat(lambda h, lp, mp, kind=kind: blocks.layered_layer_prefill(lp, mp, kind, cfg, h,
                                                                                         positions),
                               cfg.remat, self.mesh is not None)
                x, (a, b) = layer(x, lp, mp)
                if want_cache and kind == "mamba":
                    state["ssm"].append(a)
                    state["conv"].append(self._conv_tail(b, mp))
                elif want_cache:
                    state["k"].append(a)
                    state["v"].append(b)
            if want_cache:
                cache = {n: torch.stack(ts) for n, ts in state.items() if ts}
        else:
            raise ValueError(cfg.family)
        return x, aux, cache

    def _conv_tail(self, pre, mp):
        """Last K-1 conv inputs of a mamba layer (``mp`` its parameters),
        for the decode conv buffer."""
        cfg = self.cfg
        proj = matmul(pre[:, -(cfg.ssm_conv - 1):], mp["in_proj"])
        if cfg.family in ("hybrid", "layered"):
            return proj[..., cfg.d_inner: 2 * cfg.d_inner + 2 * cfg.ssm_state]
        return proj[..., : cfg.d_inner]

    # ============================================================== prefill
    @torch.no_grad()
    def prefill(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Process a prompt; returns (last-token logits, cache). The cache is
        sized to the prompt length (callers pad prompts to cache size). An
        encoder returns its (B, S, V) frame logits and no cache."""
        with self._placed(), moe.counting(self.moe_stats, "prefill"):
            return self._prefill(batch)

    def _prefill(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg, params = self.cfg, self.params()
        if cfg.family == "encoder":
            x = self._input(batch["frame_embeds"]).to(self.dtype)
        else:
            x = self._embed(params, batch)
        x, _, cache = self._stack_forward(params, x, self._positions(x.shape[1]),
                                          want_cache=cfg.family != "encoder")
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        if cfg.family == "encoder":
            return matmul(x, params["head"]).float(), {}
        return self._head(params, x[:, -1]), cache

    # =============================================================== decode
    @torch.no_grad()
    def decode_step(self, tokens, cache: Dict[str, torch.Tensor], pos: int):
        """One autoregressive step. tokens: (B,) ints; pos: the new token's
        index. Returns (logits (B, V) f32, cache), the cache updated in place.
        On a cache the model holds (``grow_cache``) the step replays a
        CUDA graph of ``_decode_step``; the logits returned are the
        caller's own."""
        entry = self._held(cache)
        if entry is not None:
            return self._decode_replay(entry, tokens, int(pos))
        self.decode_steps_eager += 1
        with self._placed(), moe.counting(self.moe_stats, "decode"):
            return self._decode_step(tokens, cache, pos)

    def _graphable(self) -> bool:
        """Whether the decode step can replay as a CUDA graph: a dense, VLM
        or layered model (a step with no host read) on one card, with no
        mesh."""
        return (self.mesh is None and self.cfg.family in ("dense", "vlm", "layered")
                and self.device.type == "cuda")

    def _held_cache(self, batch: int, P: int, total: int) -> Optional[Dict[str, torch.Tensor]]:
        """The cache (every leaf of ``cache_specs``, of ``total`` positions)
        the model holds for a batch of ``batch`` that decodes from position
        ``P``, where its step replays as a graph (``_graphable``): the one
        held for that shape, or, where the batch decodes at least
        ``DECODE_GRAPH_MIN_NEW`` positions, a new one (the least recently
        used past ``DECODE_GRAPHS`` is dropped with its graph and memory
        pool). None elsewhere. One batch at a time decodes in it; its values
        are ``grow_cache``'s to write."""
        if not self._graphable():
            return None
        key = (batch, total)
        entry = self._decode_graphs.pop(key, None)
        if entry is None:
            if total - P < DECODE_GRAPH_MIN_NEW:
                return None
            while len(self._decode_graphs) >= DECODE_GRAPHS:
                self._decode_graphs.popitem(last=False)
            cache = {n: torch.empty(s.shape, dtype=s.dtype, device=self.device)
                     for n, s in self.cache_specs(batch, total).items()}
            entry = _DecodeGraph(cache, batch, self.device)
        self._decode_graphs[key] = entry
        return entry.cache

    def _held(self, cache: Dict[str, torch.Tensor]) -> Optional[_DecodeGraph]:
        """The held decode cache ``cache`` is, if any, outside a capture."""
        if not self._graphable() or torch.cuda.is_current_stream_capturing():
            return None
        return next((entry for entry in self._decode_graphs.values() if entry.holds(cache)), None)

    def _graph_stamp(self) -> tuple:
        """What a captured step holds fixed beside its cache: every
        parameter's address (a train step may swap a parameter's storage)
        and the matmul precision flags."""
        mm = torch.backends.cuda.matmul
        return ((mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction)
                + tuple(p.data_ptr() for p in self.parameters()))

    def _decode_replay(self, entry: _DecodeGraph, tokens, pos: int):
        """``_decode_step`` on a held cache through its graph: run and
        captured at the first step (or anew where the stamp moved), then
        replayed; a replay adds one step's MoE counts into the device
        counters by itself."""
        with torch.cuda.device(self.device):
            entry.tokens.copy_(torch.as_tensor(tokens))
            entry.pos.fill_(pos)
            stamp = self._graph_stamp()
            if entry.graph is None or entry.stamp != stamp:
                with moe.counting(self.moe_stats, "decode"):
                    logits = entry.capture(lambda: self._decode_step(entry.tokens, entry.cache, entry.pos)[0],
                                           stamp)
                self.decode_graphs_captured += 1
                return logits, entry.cache
            self.decode_steps_replayed += 1
            entry.graph.replay()
            return entry.logits.clone(), entry.cache

    def _decode_step(self, tokens, cache: Dict[str, torch.Tensor], pos):
        """The decode step's body. ``pos`` is an int, or (off a mesh) a 0-d
        int tensor on the model's device, which the step reads there: the
        same operations and values as the int."""
        cfg, params = self.cfg, self.params()
        assert cfg.has_decode, f"{cfg.name} is encoder-only"
        if isinstance(pos, torch.Tensor) and self.mesh is None and pos.device == self.device:
            pos = pos.long()
        else:
            pos = int(pos)
        x = self._embed_tokens(params, self._input(tokens).long())  # (B, d)

        if cfg.family in ("dense", "vlm", "moe"):
            layer_fn = blocks.moe_layer_decode if cfg.family == "moe" else blocks.dense_layer_decode
            for i in range(cfg.n_layers):
                x, _, _ = layer_fn(_at(params["layers"], i), cfg, x, cache["k"][i], cache["v"][i], pos)
        elif cfg.family == "ssm":
            for i in range(cfg.n_layers):
                lp = _at(params["layers"], i)
                out, cache["ssm"][i], cache["conv"][i] = ssm.mamba1_decode(
                    lp["mamba"], cfg, rms_norm(x, lp["ln"], cfg.norm_eps), cache["ssm"][i], cache["conv"][i])
                x = add_residual(x, out)
        elif cfg.family == "hybrid":
            # concat-skip uses the *current* token's embedding (matches the
            # per-position e0 stream in the full forward pass)
            e0 = x
            for g in range(cfg.n_shared_attn()):
                for a in range(cfg.attn_every):
                    lp = _at(params["groups"], g, a)
                    out, cache["ssm"][g, a], cache["conv"][g, a] = ssm.mamba2_decode(
                        lp["mamba"], cfg, rms_norm(x, lp["ln"], cfg.norm_eps),
                        cache["ssm"][g, a], cache["conv"][g, a])
                    x = add_residual(x, out)
                x, _, _ = blocks.shared_attn_decode(params["shared"], cfg, x, e0, cache["k"][g],
                                                    cache["v"][g], pos)
        elif cfg.family == "layered":
            for i, kind in enumerate(cfg.layer_types):
                j, lp = cfg.mixer_index(i), _at(params["layers"], i)
                if kind == "mamba":
                    x, cache["ssm"][j], cache["conv"][j] = blocks.layered_layer_decode(
                        lp, _at(params["mamba"], j), kind, cfg, x, cache["ssm"][j], cache["conv"][j], pos)
                else:  # K/V written in place
                    x, _, _ = blocks.layered_layer_decode(lp, _at(params["attn"], j), kind, cfg, x,
                                                          cache["k"][j], cache["v"][j], pos)
        else:
            raise ValueError(cfg.family)

        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return self._head(params, x), cache

    # ================================================================ cache
    def cache_specs(self, batch: int, cache_len: int) -> SpecTree:
        return cache_specs(self.cfg, batch, cache_len)

    def grow_cache(self, cache: Dict[str, torch.Tensor], P: int, total: int) -> Dict[str, torch.Tensor]:
        """The decode cache of ``total`` positions grown from a prefill's
        ``cache`` of ``P``: a leaf whose spec has the ``cache_seq`` axis
        takes the prompt in its first ``P`` positions along it and zeros
        after; every other leaf is copied whole. The batch is read along
        ``act_batch``. The cache grown into is the one the model holds for
        the batch's shape (``_held_cache``; it still holds an earlier batch's
        values, so the zeros are written too), else ``init_cache``'s. An
        encoder has no cache: ``{}``."""
        if not cache:
            return {}
        axes = {name: spec.axes for name, spec in self.cache_specs(1, P).items()}
        name, t = next(iter(cache.items()))
        batch = t.shape[axes[name].index("act_batch")]
        held = self._held_cache(batch, P, total)
        grown = held if held is not None else self.init_cache(batch, total)
        for name, t in cache.items():
            if "cache_seq" not in axes[name]:
                grown[name].copy_(t)
                continue
            seq = axes[name].index("cache_seq")
            grown[name].narrow(seq, 0, P).copy_(t)
            if held is not None:
                grown[name].narrow(seq, P, total - P).zero_()
        return grown

    def init_cache(self, batch: int, cache_len: int) -> Dict[str, torch.Tensor]:
        """Zeros; on a mesh, DTensors placed by ``cache_shardings``."""
        if self.mesh is not None:
            from repro_torch.launch.shardings import cache_rules, place_zeros

            rules = cache_rules(self.cfg, self.mesh, batch)
            return tree_map(lambda s: place_zeros(s, rules, self.mesh), self.cache_specs(batch, cache_len))
        return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=self.device),
                        self.cache_specs(batch, cache_len))

    # ============================================================ input specs
    def input_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """Meta-tensor stand-ins for every model input of a cell (no
        allocation)."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
        i32 = torch.int32
        if shape.kind == "decode":  # one new token against a cache of S
            return {"tokens": meta((B,), i32), "pos": meta((), i32),
                    "cache": tree_abstract(self.cache_specs(B, S))}
        if cfg.family == "encoder":
            out = {"frame_embeds": meta((B, S, cfg.d_model), self.dtype)}
            if shape.kind == "train":
                out.update(mask=meta((B, S), torch.bool), labels=meta((B, S), i32))
            return out
        if cfg.family == "vlm":
            si = S // 2
            out = {"tokens": meta((B, S - si), i32), "patch_embeds": meta((B, si, cfg.d_model), self.dtype)}
        else:
            out = {"tokens": meta((B, S), i32)}
        if shape.kind == "train":
            out["labels"] = meta(out["tokens"].shape, i32)
        return out


def build_model(cfg: ModelConfig, device: DeviceLike = None, *,
                generator: Optional[torch.Generator] = None, init: bool = True) -> Model:
    return Model(cfg, device, generator=generator, init=init)
