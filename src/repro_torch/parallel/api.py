"""Logical-axis sharding context: model code asks for logical placements,
the active context maps them to mesh axes (with divisibility guards).

Counterpart of the JAX package's ``parallel/api.py``.  Model code calls
``constrain(x, ("dp", "sp", None))`` at block boundaries; without an active
context this is a no-op (one process, one card), and so it is on a plain
tensor.  Inside ``sharding_context(mesh, rules)``, on a DTensor, it
redistributes the tensor to the placements the rules give — where JAX
places a ``with_sharding_constraint``.

A spec (:func:`logical_spec`) is per *tensor* dim, like JAX's
``PartitionSpec``: a mesh-axis name, a tuple of names, or ``None``.  DTensor
placements are per *mesh* dim; :func:`to_placements` turns the one into the
other (``Shard(d)`` on every mesh dim that dim ``d`` names, ``Replicate()``
on the rest).

Logical axes:
  dp  — data parallel (batch dims):        ("data",) or ("pod", "data")
  tp  — tensor parallel (heads/ff/vocab):  "model"
  sp  — sequence parallel (activations):   None (off) or "model"
  ep  — expert parallel:                   "model"
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional, Tuple, Union

__all__ = [
    "ShardingRules",
    "sharding_context",
    "constrain",
    "constrain_first",
    "current_rules",
    "logical_spec",
    "mesh_axes",
    "to_placements",
]

Axis = Union[None, str, Tuple[str, ...]]

_TLS = threading.local()


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    dp: Axis = ("data",)
    tp: Axis = "model"
    sp: Axis = None  # sequence-parallel activations (hillclimb knob)
    ep: Axis = "model"
    fsdp: Axis = ("data",)  # weight sharding axes (ZeRO-3); None disables

    def resolve(self, logical: Optional[str]) -> Axis:
        if logical is None:
            return None
        return getattr(self, logical)


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (or of any object whose
    ``shape`` is such a mapping, as a JAX mesh's is)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axis_size(axes: dict, axis: Axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, str):
        return axes[axis]
    return int(math.prod(axes[a] for a in axis))


def logical_spec(mesh, rules: ShardingRules, shape, wanted) -> tuple:
    """Map logical axes to a per-dim spec, dropping any axis whose size does
    not divide the corresponding dim (JAX requires exact divisibility;
    DTensor would accept an uneven shard, the port keeps JAX's layout)."""
    axes = mesh_axes(mesh)
    entries = []
    for dim, logical in zip(shape, wanted):
        axis = rules.resolve(logical)
        if axis is not None and dim % _axis_size(axes, axis) == 0 and dim > 0:
            # a one-axis tuple is that axis, as JAX's PartitionSpec stores it
            entries.append(axis[0] if isinstance(axis, tuple) and len(axis) == 1 else axis)
        else:
            entries.append(None)
    return tuple(entries)


def to_placements(mesh, spec) -> tuple:
    """DTensor placements (one per mesh dim) of a per-tensor-dim spec: mesh
    dim ``a`` gets ``Shard(d)`` when tensor dim ``d`` names it, else
    ``Replicate()``.  A dim over two axes, ``("pod", "data")``, is sharded on
    both mesh dims, major to minor as JAX lays it out; that is DTensor's
    order only when the names follow the mesh's own order, which is checked."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes(mesh))
    owner = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        order = [names.index(a) for a in group]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's axis order {names}")
        for a in group:
            if a in owner:
                raise ValueError(f"mesh axis {a!r} shards two dims of spec {spec!r}")
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate() for a in names)


@contextlib.contextmanager
def sharding_context(mesh, rules: ShardingRules):
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = (mesh, rules)
    try:
        yield
    finally:
        _TLS.ctx = prev


def current_rules():
    return getattr(_TLS, "ctx", None)


def _redistribute(x, mesh, spec):
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    placements = to_placements(mesh, spec)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def constrain(x, wanted):
    """Apply a logical-axes sharding constraint if a context is active."""
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None:
        return x
    mesh, rules = ctx
    return _redistribute(x, mesh, logical_spec(mesh, rules, x.shape, wanted))


def constrain_first(x, *options):
    """Apply the first option whose every requested axis survives the
    divisibility guard (fallback: the first option, with drops)."""
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None:
        return x
    mesh, rules = ctx
    for wanted in options:
        spec = logical_spec(mesh, rules, x.shape, wanted)
        requested = sum(1 for w in wanted if w is not None and rules.resolve(w) is not None)
        granted = sum(1 for e in spec if e is not None)
        if granted == requested:
            return _redistribute(x, mesh, spec)
    return _redistribute(x, mesh, logical_spec(mesh, rules, x.shape, options[0]))
