"""PyTorch/CUDA port of the de-identification engine.

Mirrors the layout of the JAX package (``dicom``, ``obs``, ``audit``,
``detect``, ``core``, ``kernels``) and imports nothing of it. The device
hot path (``core.batch``) runs hand-written CUDA kernels for Hopper
(``csrc/*.cu``) on CUDA tensors and their plain PyTorch versions on CPU
tensors; entry points default to ``cuda:0``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
