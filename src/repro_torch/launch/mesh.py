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
device and no process group. :func:`fake_world` makes the process group
of a dry run (``launch/dryrun.py``); the constants at the end are one
H100's, which ``analysis/roofline.py`` divides by.
"""
from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def fake_world(world_size: int):
    """A process group of ``world_size`` ranks on torch's ``fake`` backend
    (collectives return at once and move no byte), with this process as
    rank 0: the dry run's stand-in for a production cluster, on
    which :func:`make_production_mesh` returns a live ``DeviceMesh``.
    Refuses to run inside an initialised group; destroys its group on the
    way out."""
    import torch.distributed as dist
    # importing it registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_local_mesh(data: int = 1, model: int = 1):
    """A (data, model) mesh: live over the initialised process group when
    it has ``data * model`` ranks, else abstract."""
    return _mesh((data, model), ("data", "model"))


# Constants of one NVIDIA H100 SXM (80 GB HBM3, at its 700 W limit) that
# the roofline analysis (``repro_torch.analysis.roofline``) divides by.
#: bf16 dense tensor-core FLOP/s (NVIDIA H100 data sheet, SXM, without
#: sparsity). The rate of a config whose compute dtype is bf16.
PEAK_FLOPS = 989e12
#: f32 FLOP/s off the tensor cores (the same data sheet). The port turns
#: TF32 off (``launch/train.py``), so a config computing in float32 (the
#: reduced configs) is bound by this rate.
PEAK_FLOPS_F32 = 67e12
#: HBM3 bytes/s (the same data sheet).
HBM_BW = 3.35e12
#: Bytes/s per card, each way, that a production mesh's collectives
#: cross. A (16, 16) mesh is 256 cards, or 32 hosts of 8, so its rings
#: leave the host: this is one ConnectX-7 port of 400 Gb/s per card, the
#: compute fabric of an NVIDIA DGX H100 (its data sheet: eight single-port
#: ConnectX-7 at up to 400 Gb/s). NVLink 4 inside the host is 900 GB/s
#: per card, 450 GB/s each way (H100 data sheet); a mesh that fits one
#: host would divide by that instead.
ICI_BW = 400e9 / 8


def peak_flops(compute_dtype: str) -> float:
    """The peak FLOP/s of a config's compute dtype: bf16 on the tensor
    cores, else f32 off them (TF32 is off)."""
    return PEAK_FLOPS if compute_dtype == "bfloat16" else PEAK_FLOPS_F32
