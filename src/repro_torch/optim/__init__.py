"""Optimizer substrate: AdamW (dtype-configurable states), schedules,
clipping — the JAX package's ``repro.optim`` with its arithmetic.

A tree is a dict of tensors (``TrainModel.params()``: name -> parameter) or
a nested dict/list of them.  ``AdamW.update`` keeps JAX's order of
operations (global-norm clip first, bias correction on ``step + 1``, weight
decay inside the step on every leaf, state kept in ``state_dtype``) but
updates the parameters and states in place under ``no_grad``, one tensor at
a time, so its temporaries are those of the largest tensor, not of the tree.
It returns the same ``params`` and ``state`` objects.  The step count and
the learning rate stay 0-d tensors on the parameters' device: nothing here
reads back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

__all__ = ["AdamW", "cosine_schedule", "clip_by_global_norm", "global_norm", "tree_leaves"]


def tree_leaves(tree) -> list:
    """The tensors of a tree in JAX's leaf order (dict keys sorted)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return type(tree)(_tree_map(fn, v) for v in tree)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (0-d tensor)."""
    leaves = tree_leaves(tree)
    total = sum(torch.sum(torch.square(x.float())) for x in leaves)
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float, *, inplace: bool = False):
    """Scale the tree so its global norm is at most ``max_norm``.  Returns
    (clipped tree, norm before clipping); ``inplace=True`` scales the leaves
    themselves and returns the same tree."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)

    def clip(x):
        if inplace:
            return x.copy_(x.float() * scale) if x.dtype != torch.float32 else x.mul_(scale)
        return (x.float() * scale).to(x.dtype)

    return _tree_map(clip, tree), norm


def cosine_schedule(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    """step -> lr (0-d fp32 tensor): linear warmup, cosine decay to
    ``floor * peak_lr``, in fp32 as the JAX schedule computes it."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)

    return lr


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable  # step -> lr  (or a float)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: Optional[str] = None  # None -> follow param dtype ("float32"/"bfloat16")
    clip_norm: float = 1.0

    def _sdt(self, p: torch.Tensor) -> torch.dtype:
        return getattr(torch, self.state_dtype) if self.state_dtype else p.dtype

    def init(self, params) -> dict:
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else "cpu"
        zeros = lambda p: torch.zeros(p.shape, dtype=self._sdt(p), device=p.device)  # noqa: E731
        return {
            "m": _tree_map(zeros, params),
            "v": _tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device),
        }

    @torch.no_grad()
    def update(self, grads, state, params):
        """One AdamW step: writes the new parameters, ``m``, ``v`` and
        ``step`` in place (the gradients are clipped in place too) and
        returns (params, state, {"grad_norm", "lr"})."""
        state["step"].add_(1)
        step = state["step"]
        lr = self.lr(step) if callable(self.lr) else self.lr
        lr = torch.as_tensor(lr, dtype=torch.float32).to(step.device)
        if self.clip_norm > 0:
            grads, gnorm = clip_by_global_norm(grads, self.clip_norm, inplace=True)
        else:
            gnorm = global_norm(grads)
        b1, b2 = self.b1, self.b2
        stepf = step.to(torch.float32)
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=step.device), stepf)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=step.device), stepf)

        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
                              tree_leaves(state["v"])):
            # at most two temporaries of this tensor's size at any time
            gf = g.float()
            mf = m if m.dtype == torch.float32 else m.float()
            vf = v if v.dtype == torch.float32 else v.float()
            mf.mul_(b1).add_(gf * (1 - b1))
            vf.mul_(b2).add_(torch.square(gf).mul_(1 - b2))
            del gf
            denom = torch.sqrt(vf / c2).add_(self.eps)
            upd = (mf / c1).div_(denom)
            del denom
            upd.add_(p.float() * self.weight_decay)
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
        return params, state, {"grad_norm": gnorm, "lr": lr.to(torch.float32)}
