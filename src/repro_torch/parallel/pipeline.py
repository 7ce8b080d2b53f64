"""GPipe-style pipeline parallelism over a mesh axis (point-to-point hops).

Counterpart of the JAX package's ``parallel/pipeline.py``.  The stage axis
holds one stage per rank.  Microbatches flow through the classic GPipe
schedule: at tick t, stage s processes microbatch (t - s); activations hop
stage→stage+1.  Bubble fraction = (S-1)/(M+S-1).

JAX gets the backward schedule for free (``ppermute`` transposes to the
reverse permutation).  torch's point-to-point ops have no autograd, so the
hop is a :class:`torch.autograd.Function`: forward sends to s+1 and
receives from s-1, backward sends the gradient to s-1 and receives from
s+1, each as one ``batch_isend_irecv`` so that no pair of ranks can block
on each other.  Every rank runs every tick and every hop (as every device
does under ``shard_map``), with the JAX version's selects, so each rank's
graph reaches every hop and the backward hops pair up across ranks.

The outputs are broadcast by a sum, as in JAX, and are then replicated:
every rank holds the same (M, mb, ...) tensor and computes the same loss
on it.  The gradient JAX takes is that of one loss on the one logical
output, so the broadcast's backward passes the (replicated) cotangent
through unchanged.  ``torch.distributed.nn.functional.all_reduce`` would
sum it over the ranks instead — the gradient of S copies of the loss, S
times JAX's.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

__all__ = ["gpipe_apply"]


class _Hop(torch.autograd.Function):
    """Cyclic shift one stage forward: send to s+1, receive from s-1."""

    @staticmethod
    def forward(ctx, x, group, send_to: int, recv_from: int):
        ctx.group, ctx.send_to, ctx.recv_from = group, send_to, recv_from
        return _exchange(x, group, send_to, recv_from)

    @staticmethod
    def backward(ctx, grad):
        # the transpose: the gradient goes back the way the activation came
        return _exchange(grad, ctx.group, ctx.recv_from, ctx.send_to), None, None, None


class _SumToAll(torch.autograd.Function):
    """All-reduce (sum) of the stages' outputs into one replicated tensor;
    the cotangent of a replicated output is the same on every rank and
    goes back unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _exchange(x, group, send_to: int, recv_from: int):
    x = x.contiguous()
    got = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, send_to), group),
           dist.P2POp(dist.irecv, got, dist.get_global_rank(group, recv_from), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def gpipe_apply(
    mesh,
    axis: str,
    stage_fn: Callable,  # (stage_params, x_mb) -> y_mb
    stage_params,  # tensors (or a dict/list of them) with leading dim == n_stages
    x: torch.Tensor,  # (M, mb, ...) microbatched inputs (the same on every rank)
) -> torch.Tensor:
    """Run x through S pipeline stages; returns (M, mb, ...) outputs on
    every rank.  Each rank takes its stage's slice of ``stage_params``
    (index s of the leading dim), as ``shard_map`` with ``P(axis)`` hands
    each device its slice in the JAX package."""
    S = mesh.size(mesh.mesh_dim_names.index(axis))
    sid = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    M = x.shape[0]
    params_local = _tree_map(lambda a: a[sid], stage_params)
    is_first = torch.tensor(sid == 0, device=x.device)
    is_last = torch.tensor(sid == S - 1, device=x.device)
    carry = torch.zeros_like(x[0])
    ys = [torch.zeros_like(x[0]) for _ in range(M)]
    T = M + S - 1
    for t in range(T):
        # stage 0 ingests microbatch t (if still available)
        inp = torch.where(is_first, x[min(t, M - 1)], carry)
        out = stage_fn(params_local, inp)
        # last stage emits microbatch (t - (S-1))
        oidx = min(max(t - (S - 1), 0), M - 1)
        emit = torch.logical_and(is_last, torch.tensor(t >= S - 1, device=x.device))
        ys[oidx] = torch.where(emit, out, ys[oidx])
        # shift activations one stage forward; the last tick's shift feeds
        # nothing, so it is not made (on any rank)
        if t < T - 1:
            carry = out if S == 1 else _Hop.apply(out, group, (sid + 1) % S, (sid - 1) % S)
    # only the last stage's ys are the real outputs; broadcast them by a sum
    y = torch.where(is_last, torch.stack(ys), torch.zeros_like(x))
    return _SumToAll.apply(y, group)
