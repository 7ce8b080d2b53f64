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

The model's products and head reshapes go through :func:`matmul`,
:func:`einsum`, :func:`split_dim` and :func:`merge_dims`: the plain torch
op on plain tensors; on DTensors (the dry run's meta tensors,
:mod:`repro_torch.launch.dryrun`) a partition chosen as GSPMD chooses one,
computed shard by shard, which does not rest on DTensor's own rules for
those ops (they differ between torch versions and fail on some layouts).

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

import torch

__all__ = [
    "ShardingRules",
    "sharding_context",
    "constrain",
    "constrain_first",
    "split_dim",
    "merge_dims",
    "shard_index",
    "einsum",
    "matmul",
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
    # a mesh dim of one rank holds the whole dim: a replica (DTensor's view
    # rules refuse a Shard there)
    sizes = mesh_axes(mesh)
    return tuple(Shard(owner[a]) if a in owner and sizes[a] > 1 else Replicate() for a in names)


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


def split_dim(x, dim: int, n: int):
    """``x`` with dim ``dim`` (of size n*m) viewed as (n, m).

    A DTensor (the dry run's) sharded on that dim over more ranks than
    divide ``n`` (qwen2-7b's 28 heads on a 16-way model axis) is resharded
    first, as GSPMD reshards at such a reshape by itself: the mesh dims
    that shard it shard the leading (batch) dim instead where that divides
    (an all-to-all), else they replicate it (an all-gather).  On a plain
    tensor this is the plain reshape."""
    dim = dim % x.ndim
    x = _splittable(x, dim, n)
    return x.reshape(*x.shape[:dim], n, x.shape[dim] // n, *x.shape[dim + 1:])


def shard_index(mesh, dims) -> int:
    """This rank's index among the shards that the mesh dims ``dims``
    (major to minor, as DTensor nests them) cut a tensor dim into."""
    coord = mesh.get_coordinate()
    index = 0
    for i in dims:
        index = index * mesh.size(i) + coord[i]
    return index


def merge_dims(x, dim: int):
    """``x`` with dims ``dim`` and ``dim + 1`` merged (heads back into the
    model dim).  On a DTensor its gradient is resharded on the way back as
    :func:`split_dim` reshards (the backward of the merge is that split).
    Elsewhere this is the plain reshape."""
    dim = dim % x.ndim
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return _MergeDims.apply(x, dim)
    return x.reshape(*x.shape[:dim], x.shape[dim] * x.shape[dim + 1], *x.shape[dim + 2:])


def _splittable(x, dim: int, n: int):
    """``x``, resharded if it is a DTensor sharded on ``dim`` over more
    ranks than divide ``n`` (see :func:`split_dim`)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    sharded = [i for i, pl in enumerate(x.placements) if isinstance(pl, Shard) and pl.dim == dim]
    if n % math.prod(mesh.size(i) for i in sharded) == 0:
        return x
    ranks = math.prod(mesh.size(i) for i, pl in enumerate(x.placements)
                      if isinstance(pl, Shard) and pl.dim == 0)
    ranks *= math.prod(mesh.size(i) for i in sharded)
    into = Shard(0) if x.shape[0] % ranks == 0 else Replicate()
    return x.redistribute(mesh, [into if i in sharded else pl for i, pl in enumerate(x.placements)])


class _MergeDims(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.n = dim, x.shape[dim]
        return x.reshape(*x.shape[:dim], x.shape[dim] * x.shape[dim + 1], *x.shape[dim + 2:])

    @staticmethod
    def backward(ctx, g):
        g = _splittable(g, ctx.dim, ctx.n)
        return g.reshape(*g.shape[:ctx.dim], ctx.n, g.shape[ctx.dim] // ctx.n,
                         *g.shape[ctx.dim + 1:]), None


def einsum(eq: str, *operands, local=torch.einsum):
    """``local(eq, *operands)``: ``torch.einsum`` unless the caller gives
    another form of the same contraction (the attention's scores take
    theirs: bf16 products with fp32 output on the card).  On DTensors it
    runs shard by shard, with the
    operands placed the way GSPMD partitions a dot: each mesh dim shards
    one index letter, the first that an operand shards there and the
    output keeps (batch, rows or columns: the others are gathered), else
    the first summed letter an operand shards there (each rank then sums
    its slice and an all-reduce adds the slices).  The local shards are
    contracted by ``local``, and the result is the DTensor of the
    local results.  A gradient that flows into an operand lacking a mesh
    dim's letter is a partial sum on that dim (reduced on the way back).
    DTensor's own rules for the products fail on some layouts and some
    torch versions (the flattening views of a batched product)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not any(isinstance(o, DTensor) for o in operands):
        return local(eq, *operands)
    ins, out = eq.replace(" ", "").split("->")
    subs = ins.split(",")
    mesh = next(o for o in operands if isinstance(o, DTensor)).device_mesh
    ops = [o if isinstance(o, DTensor)
           else DTensor.from_local(o, mesh, [Replicate()] * mesh.ndim, run_check=False)
           for o in operands]
    size = {ch: o.shape[d] for sub, o in zip(subs, ops) for d, ch in enumerate(sub)}
    ranks: dict = {}
    letters, summed = [], []
    for i in range(mesh.ndim):
        pick = None
        for keep in (True, False):  # an output letter first, else a summed one
            for sub, o in zip(subs, ops):
                pl = o.placements[i]
                if isinstance(pl, Shard) and (sub[pl.dim] in out) == keep:
                    ch = sub[pl.dim]
                    if size[ch] % (ranks.get(ch, 1) * mesh.size(i)) == 0:
                        pick = ch
                        break
            if pick is not None:
                break
        if pick is not None:
            ranks[pick] = ranks.get(pick, 1) * mesh.size(i)
        letters.append(pick)
        summed.append(pick is not None and pick not in out)
    shards = []
    for sub, o in zip(subs, ops):
        want = [Shard(sub.index(ch)) if ch is not None and ch in sub else Replicate()
                for ch in letters]
        grads = [Partial() if ch is not None and ch not in sub else pl
                 for ch, pl in zip(letters, want)]
        shards.append(o.redistribute(mesh, want).to_local(grad_placements=grads))
    res = local(eq, *shards)
    placements = [Partial() if part else Shard(out.index(ch)) if ch is not None else Replicate()
                  for ch, part in zip(letters, summed)]
    # the shards are even (logical_spec and split_dim shard only dims the
    # axes divide): from_local works out the global shape and strides
    res = DTensor.from_local(res, mesh, placements, run_check=False)
    if any(summed):
        res = res.redistribute(mesh, [Replicate() if part else pl
                                      for pl, part in zip(placements, summed)])
    return res


def matmul(x, w):
    """``x @ w`` for ``w`` of two dims (a Linear layer's weight); on
    DTensors through :func:`einsum`."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor) and not isinstance(w, DTensor):
        return x @ w
    lead = "abcdefgh"[:x.ndim - 1]
    return einsum(f"{lead}y,yz->{lead}z", x, w)
