"""Meshes: the reference's production meshes and small host meshes, and
the ``Env`` of a mesh.

``make_production_mesh`` is a function (importing this module touches no
process group): single-pod (16, 16) = 256 ranks as (data, model); the
multi-pod variant adds a leading "pod" axis for 2 x 256 = 512, the pod
axis joining data parallelism.  Without ``device_type`` a mesh is abstract
(names and sizes, for the sharding rules); with it, it is attached to the
initialised world, which must have the mesh's size
(``distributed/mesh.py``).
"""

from __future__ import annotations

from typing import Optional

from ..distributed.mesh import Mesh
from ..models.common import DeviceLike, Env, resolve_device


def _mesh(shape, axes, device_type: Optional[str]) -> Mesh:
    if device_type is None:
        return Mesh(shape, axes)
    return Mesh.attach(shape, axes, device_type)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_host_mesh(data: int = 2, model: int = 4, *,
                   device_type: Optional[str] = None) -> Mesh:
    """A small (data, model) mesh over the ranks of one host."""
    return _mesh((data, model), ("data", "model"), device_type)


def env_for_mesh(mesh: Optional[Mesh], device: DeviceLike = None,
                 **overrides) -> Env:
    """Env with batch axes = every non-"model" axis, tp = "model"."""
    dev = resolve_device(device)
    if mesh is None:
        return Env(dev, **overrides)
    axes = tuple(mesh.axis_names)
    batch_axes = tuple(a for a in axes if a != "model")
    tp = "model" if "model" in axes else None
    return Env(dev, mesh=mesh, batch_axes=batch_axes, tp_axis=tp, **overrides)
