"""Device meshes with the reference's axis names.

A function, not a module-level constant, so importing this module touches
no process group. ``make_mesh`` is the counterpart of ``jax.make_mesh``: a
``DeviceMesh`` over the default process group, whose world size must be
the product of ``shape``.

Topology of the reference's target:
  single-pod: (data=16, model=16)       = 256 chips
  multi-pod:  (pod=2, data=16, model=16) = 512 chips; 'pod' is pure DP over
  the slower inter-node links, a separate axis so that its all-reduces are
  scheduled and counted apart.

The sharding rules (``launch/shardings.py``) read only axis names and
sizes, so they also take an :class:`AbstractMesh`, which needs no process
group at all.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes without devices (``jax.sharding.AbstractMesh``)."""

    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a stand-in with
    ``axis_names`` and a ``shape`` dict."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def make_mesh(shape: Sequence[int], axes: Sequence[str], device_type: str = "cuda") -> DeviceMesh:
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_smoke_mesh(device_type: str = "cuda") -> DeviceMesh:
    """1-device mesh with the production axis names: the sharding-rule code
    paths run on it in a world of one."""
    return make_mesh((1, 1), ("data", "model"), device_type)


def mesh_info(mesh) -> dict:
    axes = mesh_axes(mesh)
    n = 1
    for size in axes.values():
        n *= size
    return {"axes": axes, "n_devices": n, "multi_pod": "pod" in axes}
