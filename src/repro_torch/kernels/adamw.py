"""AdamW over a whole tree of leaves as one hand-written multi-tensor CUDA
kernel for Hopper (``csrc/adamw.cu``).

Replaces no Pallas kernel: it is the port's counterpart of XLA's fusion of
the JAX package's ``repro.optim`` elementwise chain under ``jit``, which the
eager port had run as some twenty fp32 passes a leaf (about 168 bytes a
parameter).  The kernel is bound by bytes and reads each operand once: the
gradients for the global norm, then g, p, m and v, writing p, m and v (32
bytes a parameter in fp32), in three launches whatever the number of leaves:

* a norm pass over every gradient (a fixed grid of at most ``NORM_BLOCKS``
  blocks striding over the chunks; no atomics, so the norm repeats bit for
  bit);
* a one-block finish writing the norm and the clip scale to device floats;
* an update pass, one block per ``CHUNK`` elements of a leaf, each element
  in fp32 in the eager loop's order.

The chunks are numbered leaf after leaf (:func:`chunk_spans`).  A table of
the leaves (p, m, v and g pointers, lengths, dtypes, first chunks; a few
KB, in which a block finds its chunk's leaf by binary search) is uploaded
each step, since the gradients are new every step, from pinned memory on
the current stream (PyTorch's pinned-memory cache keeps a buffer until its
copy has run), and freed after the launch: nothing stays on the device
between steps.  The leaves are checked once a tree; a tree is known again
by its p, m and v pointers, lengths, dtypes and contiguity and its
gradients' dtypes, and each step's gradients are held to the tree's
lengths.  Nothing is read back to the host.

:func:`adamw_update` launches the kernel for CUDA leaves and raises on what
it does not take (mixed devices, non-contiguous leaves, dtypes other than
fp32 and bf16); leaves on any other device (the CPU, the dry run's meta
device) take :func:`adamw_plain`, the eager loop the kernel replaced, which
also clips the gradients in place.  The kernel reads the gradients and does
not write the clipped gradient back.
"""
from __future__ import annotations

import bisect
import ctypes
import functools
import operator
import threading
from collections import OrderedDict
from typing import NamedTuple

import torch

from . import _cuda

__all__ = ["adamw_update", "adamw_plain", "global_norm", "clip_scale", "first_chunks", "chunk_spans",
           "flops_bytes", "CHUNK", "NORM_BLOCKS", "launches", "leaves"]

#: elements of a leaf per work item (``csrc/adamw.cu``'s CHUNK)
CHUNK = 16384
#: the norm pass's grid: at most this many blocks (and partials)
NORM_BLOCKS = 1024
#: int64 words a leaf in the table: p, m, v, length, dtype code, first chunk, g
LEAF_WORDS = 7
_CODE = {torch.float32: 0, torch.bfloat16: 1}  # << 0 for p, << 1 for g, << 2 for m and v
#: checked trees kept (a process may train several models)
_TREES = 4

#: kernel launches so far (three an update), and the leaves they updated
launches = 0
leaves = 0
_count_lock = threading.Lock()
_trees: OrderedDict = OrderedDict()
_trees_lock = threading.Lock()
_dtype = operator.attrgetter("dtype")


def global_norm(xs) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor of ``xs``, in fp32 (0-d tensor)."""
    total = sum(torch.sum(torch.square(x.float())) for x in xs)
    return torch.sqrt(total)


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor that brings a global norm ``norm`` to at most ``max_norm``."""
    return torch.clamp(max_norm / (norm + 1e-12), max=1.0)


def first_chunks(numels) -> tuple:
    """(each leaf's first chunk, the number of chunks): every leaf cut into
    ``CHUNK``-element chunks, the last one ragged, numbered leaf after leaf;
    a leaf of no elements has none."""
    first, total = [], 0
    for n in numels:
        first.append(total)
        total += -(-n // CHUNK)
    return first, total


def chunk_spans(numels) -> list:
    """(leaf, start, end) of every chunk, as the kernel's blocks take them:
    chunk c belongs to the last leaf whose first chunk is at most c."""
    first, total = first_chunks(numels)
    spans = []
    for c in range(total):
        leaf = bisect.bisect_right(first, c) - 1
        start = (c - first[leaf]) * CHUNK
        spans.append((leaf, start, min(start + CHUNK, numels[leaf])))
    return spans


def flops_bytes(params, grads, ms) -> tuple:
    """(FLOP, bytes) of one update: 2 FLOP an element for the norm and 17
    for the update; the gradients read twice (norm, update), p, m and v
    (v in m's dtype) read and written once each."""
    n = sum(p.numel() for p in params)
    nbytes = sum(p.numel() * (2 * g.element_size() + 2 * p.element_size() + 4 * m.element_size())
                 for p, g, m in zip(params, grads, ms))
    return 19.0 * n, float(nbytes)


def adamw_plain(params, grads, ms, vs, *, lr, c1, c2, b1: float, b2: float, eps: float,
                weight_decay: float, clip_norm: float) -> torch.Tensor:
    """The eager loop the kernel replaced, on any device: clips the
    gradients in place when ``clip_norm > 0``, then updates each leaf in
    place, at most two temporaries of its size at a time.  Returns the
    global norm before clipping."""
    gnorm = global_norm(grads)
    if clip_norm > 0:
        scale = clip_scale(gnorm, clip_norm)
        for g in grads:
            if g.dtype == torch.float32:
                g.mul_(scale)
            else:
                g.copy_(g.float() * scale)
    for p, g, m, v in zip(params, grads, ms, vs):
        gf = g.float()
        mf = m if m.dtype == torch.float32 else m.float()
        vf = v if v.dtype == torch.float32 else v.float()
        mf.mul_(b1).add_(gf * (1 - b1))
        vf.mul_(b2).add_(torch.square(gf).mul_(1 - b2))
        del gf
        denom = torch.sqrt(vf / c2).add_(eps)
        upd = (mf / c1).div_(denom)
        del denom
        upd.add_(p.float() * weight_decay)
        upd.mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(upd)
        else:
            p.copy_(p.float() - upd)
        del upd
        if mf is not m:
            m.copy_(mf)
        if vf is not v:
            v.copy_(vf)
    return gnorm


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _cuda.load("adamw")
    fn = lib.repro_adamw
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_float] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = lib.repro_adamw_error_string
    err.restype = ctypes.c_char_p
    return fn, err


def _to_device(values, dtype, dev) -> torch.Tensor:
    """A host list as a device tensor: one asynchronous copy from pinned
    memory on the current stream."""
    return torch.tensor(values, dtype=dtype).pin_memory().to(dev, non_blocking=True)


class _Tree(NamedTuple):
    """A checked tree: its table but for the gradients' pointers, its chunks
    and its leaves' lengths."""
    rows: list  # LEAF_WORDS int64 a leaf, the gradient's pointer (the last) 0
    nchunks: int
    numels: tuple


def _check_leaf(i: int, leaf: tuple, dev) -> None:
    """Raise on what the kernel does not take in leaf ``i`` (p, g, m, v)."""
    for what, x in zip(("param", "grad", "m", "v"), leaf):
        if type(x) not in (torch.Tensor, torch.nn.Parameter):
            raise ValueError(f"adamw: leaf {i}'s {what} is a {type(x).__name__}; the kernel takes "
                             "plain tensors")
        if x.device != dev:
            raise ValueError(f"adamw: leaf {i}'s {what} is on {x.device}, leaf 0's param on {dev}: "
                             "the kernel takes every leaf on one CUDA device")
        if x.dtype not in _CODE:
            raise ValueError(f"adamw: leaf {i}'s {what} has dtype {x.dtype}; supported: {list(_CODE)}")
        if not x.is_contiguous():
            raise ValueError(f"adamw: leaf {i}'s {what} must be contiguous")
    p, g, m, v = leaf
    n = p.numel()
    if g.numel() != n or m.numel() != n or v.numel() != n or m.dtype != v.dtype:
        raise ValueError(f"adamw: leaf {i}: param {tuple(p.shape)}, grad {tuple(g.shape)}, m "
                         f"{tuple(m.shape)} {m.dtype}, v {tuple(v.shape)} {v.dtype} do not match")


def _tree(params, grads, ms, vs, dev) -> _Tree:
    """The checked tree, kept by what its table holds of p, m and v (each
    one's pointer, length, dtype and contiguity) and by the gradients'
    dtypes; every leaf is checked when one of them changed, so a tree built
    anew at the pointers of a freed one is checked anew."""
    pmv = (*params, *ms, *vs)
    key = (dev.index, *map(torch.Tensor.data_ptr, pmv), *map(torch.Tensor.numel, pmv),
           *map(_dtype, pmv), *map(torch.Tensor.is_contiguous, pmv), *map(_dtype, grads))
    with _trees_lock:
        got = _trees.get(key)
        if got is not None:
            _trees.move_to_end(key)
            return got
    for i, leaf in enumerate(zip(params, grads, ms, vs)):
        _check_leaf(i, leaf, dev)
    numels = tuple(p.numel() for p in params)
    first, nchunks = first_chunks(numels)
    rows = []
    for p, g, m, v, f in zip(params, grads, ms, vs, first):
        rows += (p.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(),
                 _CODE[p.dtype] | _CODE[g.dtype] << 1 | _CODE[m.dtype] << 2, f, 0)
    got = _Tree(rows, nchunks, numels)
    with _trees_lock:
        _trees[key] = got
        while len(_trees) > _TREES:
            _trees.popitem(last=False)
    return got


def _launch(params, grads, ms, vs, *, lr, c1, c2, b1, b2, eps, weight_decay, clip_norm):
    global launches, leaves
    dev = params[0].device
    for name, t in (("lr", lr), ("c1", c1), ("c2", c2)):
        if not (isinstance(t, torch.Tensor) and t.device == dev and t.dtype == torch.float32
                and t.numel() == 1):
            raise ValueError(f"adamw: {name} must be one fp32 element on {dev}")
    tree = _tree(params, grads, ms, vs, dev)
    gptrs = []
    for i, (g, n) in enumerate(zip(grads, tree.numels)):  # the gradients are new every step
        if g.numel() != n:
            raise ValueError(f"adamw: leaf {i}'s grad has {g.numel()} elements, its param {n}")
        if g.device != dev or not g.is_contiguous() or type(g) is not torch.Tensor:
            _check_leaf(i, (params[i], g, ms[i], vs[i]), dev)
        gptrs.append(g.data_ptr())
    rows = list(tree.rows)
    rows[LEAF_WORDS - 1::LEAF_WORDS] = gptrs
    table = _to_device(rows, torch.int64, dev)
    blocks = max(1, min(tree.nchunks, NORM_BLOCKS))
    partials = torch.empty(blocks, dtype=torch.float64, device=dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    fn, err = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(table.data_ptr(), len(params), tree.nchunks, partials.data_ptr(), blocks,
                out.data_ptr(), lr.data_ptr(), c1.data_ptr(), c2.data_ptr(), clip_norm, b1, 1 - b1,
                b2, 1 - b2, eps, weight_decay, stream)
    if rc != 0:
        raise RuntimeError(f"adamw kernel launch failed ({len(params)} leaves, {tree.nchunks} chunks): "
                           f"CUDA error {rc}: {err(rc).decode()}")
    with _count_lock:
        launches += 3 if tree.nchunks else 2
        leaves += len(params)
    return out[0]


def adamw_update(params, grads, ms, vs, *, lr, c1, c2, b1: float, b2: float, eps: float,
                 weight_decay: float, clip_norm: float) -> torch.Tensor:
    """One AdamW step over the leaves (four lists in one order), in place:
    the global norm of ``grads``, their clip by ``clip_norm`` (none when it
    is 0), then per element, in fp32, m = b1 m + (1 − b1) g, v = b2 v +
    (1 − b2) g², p −= lr ((m / c1) / (sqrt(v / c2) + eps) + weight_decay p).
    ``lr``, ``c1`` and ``c2`` are 0-d fp32 tensors on the leaves' device.
    Returns the global norm before clipping (0-d fp32 tensor).

    CUDA leaves launch the kernel, which does not write the clipped
    gradient back; leaves on other devices take :func:`adamw_plain`, which
    does.  A CUDA parameter takes the kernel path, which raises on any leaf
    elsewhere."""
    if not any(p.is_cuda for p in params):
        return adamw_plain(params, grads, ms, vs, lr=lr, c1=c1, c2=c2, b1=b1, b2=b2, eps=eps,
                           weight_decay=weight_decay, clip_norm=clip_norm)
    if not (len(params) == len(grads) == len(ms) == len(vs)):
        raise ValueError(f"adamw: {len(params)} params, {len(grads)} grads, {len(ms)} m, {len(vs)} v")
    return _launch(params, grads, ms, vs, lr=lr, c1=c1, c2=c2, b1=b1, b2=b2, eps=eps,
                   weight_decay=weight_decay, clip_norm=clip_norm)
