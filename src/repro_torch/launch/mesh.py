"""Mesh builders (functions, not module constants — importing this module
touches no device and no process group).

Counterpart of the JAX package's ``launch/mesh.py``: ``jax.make_mesh``
becomes ``init_device_mesh`` over the process group this process has
already joined (``torch.distributed.init_process_group``: NCCL on the
cards, gloo on the CPU, or the ``fake`` backend, which has a world of any
size and moves no data).  The device type follows the group's backend:
``cuda`` under NCCL, ``cpu`` otherwise.

The production meshes, (16, 16) and (2, 16, 16), have 256 and 512 ranks:
no host of the port has that many cards, so they exist only on a fake
process group (:func:`fake_process_group`), where the sharding layer can
place tensors on them without any data moving.
"""
from __future__ import annotations

import contextlib
import math

from repro_torch.parallel.api import ShardingRules, mesh_axes

__all__ = ["make_production_mesh", "make_mesh", "default_rules", "fake_process_group"]


def make_mesh(shape, axes, *, device_type=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialized
    default process group, whose world size must be the shape's product."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(shape), tuple(axes)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group: call torch.distributed."
                           "init_process_group first (or use fake_process_group)")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"make_mesh: mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"process group has {dist.get_world_size()}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: 16x16 = 256 ranks (data, model).  Multi-pod: 2 pods =
    512 ranks (pod, data, model); the pod axis composes with data for
    hierarchical DP/FSDP (or acts as the pipeline axis, see
    parallel.pipeline).  Needs a process group of that many ranks: a fake
    one (:func:`fake_process_group`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


@contextlib.contextmanager
def fake_process_group(world_size: int, rank: int = 0):
    """A default process group of ``world_size`` ranks on the ``fake``
    backend (this process plays ``rank``; collectives return at once and
    move nothing), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_process_group: a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def default_rules(mesh, *, fsdp: bool = True, sp: bool = False) -> ShardingRules:
    """Logical-axis mapping for a mesh built by make_production_mesh (or any
    mesh with a 'data' and 'model' axis, optionally 'pod')."""
    dp = ("pod", "data") if "pod" in mesh_axes(mesh) else ("data",)
    return ShardingRules(
        dp=dp,
        tp="model",
        sp="model" if sp else None,
        ep="model",
        fsdp=dp if fsdp else None,
    )
