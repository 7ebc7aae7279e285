"""Architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

import importlib
from typing import Callable, Dict, List

from repro_torch.config.model import ModelConfig

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}

# configs are one module per arch under repro.configs (deliverable f)
_ARCH_MODULES = [
    "qwen1_5_110b",
    "qwen2_0_5b",
    "glm4_9b",
    "h2o_danube_1_8b",
    "mixtral_8x22b",
    "olmoe_1b_7b",
    "llava_next_34b",
    "zamba2_2_7b",
    "hubert_xlarge",
    "falcon_mamba_7b",
]


def register_arch(arch_id: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[arch_id] = fn
        return fn

    return deco


def _load_all() -> None:
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_arch(arch_id: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def list_archs() -> List[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)
