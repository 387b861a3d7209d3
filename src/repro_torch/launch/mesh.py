"""Production mesh builders (single-pod 16x16, multi-pod 2x16x16, the
pipeline lane's ("pipe", "data", "model")) on ``DeviceMesh`` (port of
``repro.launch.mesh``).  Functions, not module constants: importing this
module touches no process group.

``make_mesh`` needs an initialised default process group of
``prod(shape)`` ranks; the JAX package's faked host devices
(``launch/hostdevices.py``) have no counterpart here, the world size of
the process group takes their place.  ``AbstractMesh`` carries the axis
names and sizes only, for the sharding rules with no process group (the
JAX package's ``AbstractMesh``).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes with no devices behind them."""
    shape: tuple
    mesh_dim_names: tuple

    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def production_shape(*, multi_pod: bool = False) -> tuple:
    """(shape, axes) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def pp_shape(*, pipe: int = 4) -> tuple:
    """(shape, axes) of the pipeline lane's mesh over 256 devices."""
    return (pipe, 256 // pipe // 16, 16), ("pipe", "data", "model")


def make_mesh(shape, axes, device_type: str = "cuda"):
    """``DeviceMesh`` of ``shape`` with named dims ``axes`` over the
    default process group (the JAX package's ``_mk``)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    return make_mesh(*production_shape(multi_pod=multi_pod), device_type=device_type)


def make_pp_mesh(*, pipe: int = 4, device_type: str = "cuda"):
    """Extra lane (beyond the required meshes) for the Piper pipeline
    executor: ("pipe", "data", "model")."""
    return make_mesh(*pp_shape(pipe=pipe), device_type=device_type)


def axis_names(mesh) -> tuple:
    """A mesh's axis names: a ``DeviceMesh``'s dim names, or the
    ``axis_names`` of a ``core.strategy.Mesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def dp_axes_for(mesh) -> tuple:
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))
