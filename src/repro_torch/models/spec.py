"""TensorSpec trees: shapes + logical sharding axes for every parameter.

Model code labels each tensor dim ("vocab", "embed", "heads", "experts",
...). The same spec tree drives real initialization (``tree_init``), the
parameters a :class:`~repro_torch.models.model.Model` registers, and the
decode caches. Weights default to bfloat16, activations follow
``cfg.dtype``: a float32 config multiplies float32 activations by bfloat16
weights, promoted to float32 at each product.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Tuple

import torch


@dataclass(frozen=True)
class TensorSpec:
    shape: Tuple[int, ...]
    axes: Tuple[str | None, ...]  # logical axis name per dim (None = replicated)
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"  # normal | zeros | ones | ssm_a | ssm_dt
    scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)

    def abstract(self) -> torch.Tensor:
        """A meta tensor of the spec's shape and dtype (no allocation)."""
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


SpecTree = Dict[str, Any]  # nested dicts of TensorSpec


def tree_items(tree: Dict[str, Any], prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(dotted path, leaf) of a nested dict, in key order. A leaf is
    anything that is not a dict: a TensorSpec, a tensor, an array."""
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from tree_items(val, path + ".")
        else:
            yield path, val


def tree_map(fn: Callable[[Any], Any], tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def tree_abstract(specs: SpecTree) -> Dict[str, Any]:
    return tree_map(lambda s: s.abstract(), specs)


def _init_one(spec: TensorSpec, generator: torch.Generator) -> torch.Tensor:
    gdev = generator.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=gdev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=gdev)
    if spec.init == "ssm_a":
        # mamba A_log init: A = -exp(A_log) stable negatives, log(1..N) pattern
        n = spec.shape[-1]
        base = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=gdev))
        return base.expand(spec.shape).to(spec.dtype).contiguous()
    if spec.init == "ssm_dt":
        # dt bias init so softplus(dt) spans ~[1e-3, 1e-1]
        u = torch.rand(spec.shape, generator=generator, dtype=torch.float32, device=gdev)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        inv = dt + torch.log(-torch.expm1(-dt))
        return inv.to(spec.dtype)
    out = torch.randn(spec.shape, generator=generator, dtype=torch.float32, device=gdev)
    return (out * spec.scale).to(spec.dtype)


def tree_init(specs: SpecTree, generator: torch.Generator, device=None) -> Dict[str, Any]:
    """Real weights for every leaf, drawn in leaf order from ``generator`` on
    its own device and placed on ``device`` (default: the generator's)."""
    dev = generator.device if device is None else torch.device(device)
    return tree_map(lambda s: _init_one(s, generator).to(dev), specs)


def tree_logical_axes(specs: SpecTree) -> Dict[str, Any]:
    return tree_map(lambda s: s.axes, specs)


def param_count(specs: SpecTree) -> int:
    return sum(math.prod(s.shape) for _, s in tree_items(specs))
