"""Device meshes over the initialised default process group.

The port of ``repro/launch/mesh.py``.  FUNCTIONS (not module-level
constants), so importing this module touches no device or process-group
state.  Single pod: 256 ranks as (16, 16) ("data", "model"); multi-pod:
2 x 256 ranks as (2, 16, 16) ("pod", "data", "model").  The caller
initialises ``torch.distributed`` first (``torchrun`` on cards, gloo
processes on the CPU, or the ``fake`` backend of the dry run): a rank is
one device, as a JAX device is.

``Mesh`` wraps ``torch.distributed.device_mesh.DeviceMesh`` with the names
the reference's code reads from a ``jax.sharding.Mesh``: ``axis_names``,
``devices.shape`` and ``shape[axis]``, so ``trainstep.default_microbatches``
takes it unchanged.  ``group(axes)`` is the process group of one axis or of
several (flattened in mesh order, the order ``logical_to_spec`` names them
in), ``coord(axes)`` this rank's index in it.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# the device type of a rank by its process group's backend
_DEVICE_TYPE = {"gloo": "cpu", "nccl": "cuda", "fake": "cpu"}


class Mesh:
    """A named device mesh: the reference's ``Mesh`` interface over a
    ``DeviceMesh``."""

    def __init__(self, device_mesh: DeviceMesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.devices = device_mesh.mesh             # .shape as jax's
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.device_type = device_mesh.device_type
        self._groups = {}
        self.specs = {}       # sharding._spec's memo: (logical, shape)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.device_type})"

    def axes(self, axes) -> tuple:
        """``axes`` (a name, a tuple of names or None) as a tuple in mesh
        order."""
        if axes is None:
            return ()
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def size(self, axes=None) -> int:
        """The ranks along ``axes`` (all of the mesh's when None)."""
        n = 1
        for a in (self.axis_names if axes is None else self.axes(axes)):
            n *= self.shape[a]
        return n

    def coord(self, axes) -> int:
        """This rank's index along ``axes``, row-major in mesh order."""
        c = self.device_mesh.get_coordinate()
        i = 0
        for a in self.axes(axes):
            i = i * self.shape[a] + c[self.axis_names.index(a)]
        return i

    def group(self, axes=None):
        """The process group of the ranks that differ from this one only
        along ``axes`` (every axis when None)."""
        key = self.axis_names if axes is None else self.axes(axes)
        if key not in self._groups:
            if len(key) == 1:
                self._groups[key] = self.device_mesh.get_group(key[0])
            else:
                self._groups[key] = self.device_mesh[key]._flatten() \
                    .get_group()
        return self._groups[key]


def _device_type() -> str:
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs torch.distributed initialised first "
            "(torchrun, or init_process_group with a rank and world size)")
    return _DEVICE_TYPE.get(dist.get_backend(), "cuda")


def make_compat_mesh(shape, axes, device_type=None) -> Mesh:
    """A ``Mesh`` of ``shape`` named ``axes`` over the first
    ``prod(shape)`` ranks of the default group, its DTensors on
    ``device_type`` (default: the backend's; "cuda" for gloo ranks that
    compute on a card, since a DTensor moves its local tensor to its
    mesh's device type)."""
    shape = tuple(shape)
    backend_type = _device_type()
    return Mesh(DeviceMesh(device_type or backend_type,
                           torch.arange(math.prod(shape)).view(shape),
                           mesh_dim_names=tuple(axes)))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_compat_mesh(shape, axes)


def make_host_mesh(*, data: int = 1, model: int = 1) -> Mesh:
    """A small ("data", "model") mesh over the ranks that exist."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    assert data * model <= n, (data, model, n)
    return make_compat_mesh((data, model), ("data", "model"))
