"""Mesh construction (port of ``repro.launch.mesh``).

Single pod: (16, 16) = 256 devices, axes (data, model). Multi-pod:
(2, 16, 16) = 512 devices, axes (pod, data, model); the pod axis joins
data parallelism (batch and FSDP shard over ('pod', 'data')), so
cross-pod traffic is gradient reduction only.

A mesh is *live* when it is a ``torch.distributed`` ``DeviceMesh`` over
an initialised process group, one rank per device; the sharded steps
run on a live mesh. An :class:`AbstractMesh` holds only axis names and
sizes: layouts (partition specs, local shard shapes, the row order of
a sharded payload) are computed from it without processes, as the
reference computes them on fake devices.

Functions, not module-level meshes: importing this module touches no
device and no process group.
"""
from __future__ import annotations

from typing import Dict, Tuple


class AbstractMesh:
    """Axis names and sizes, no devices (``jax.sharding.Mesh`` without
    its device array). ``shape`` maps each axis to its size, in order."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} vs axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = {a: int(n)
                                      for a, n in zip(axis_names, shape)}

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    """A live ``DeviceMesh`` when a process group of ``prod(shape)``
    ranks is initialised (on the card when the backend is NCCL, else on
    the CPU), else an :class:`AbstractMesh`."""
    import torch.distributed as dist
    n = 1
    for s in shape:
        n *= s
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() == n:
        from torch.distributed.device_mesh import init_device_mesh
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
        return init_device_mesh(device, tuple(shape), mesh_dim_names=axes)
    return AbstractMesh(tuple(shape), axes)


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_local_mesh(data: int = 1, model: int = 1):
    """A (data, model) mesh: live over the initialised process group when
    it has ``data * model`` ranks, else abstract."""
    return _mesh((data, model), ("data", "model"))
