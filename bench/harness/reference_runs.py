"""Runs of a configuration's plain reference after the window: three AdamW
steps of training from the seed's weights, or the logits over served
sequences.  Weights are drawn again from the seed (``weights.py``); the
reference takes nothing the program made.  Products run in float32 without
TF32 (or in the control's lower precision)."""
from __future__ import annotations

import math

import torch

from bench.reference.common import exact_matmuls

from . import weights

__all__ = ["reference_train", "reference_logits", "lr_at"]


def lr_at(step: int, peak: float, warmup: int, total: int, floor: float = 0.1) -> float:
    """The program's cosine schedule (linear warm-up, cosine decay to
    ``floor`` × peak) at 1-based ``step``."""
    if step < warmup:
        return peak * step / max(warmup, 1)
    t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * t)))


def _tensors(cell, seed, device):
    recipe = cell.reference().recipe(cell.sizes)
    index = {g: i for i, (g, _) in enumerate(recipe)}
    return recipe, index


def reference_train(cell, seed: int, batches: list, device, prec: str = "fp32") -> dict:
    """Losses, first gradient norms (before clipping) and changes after
    ``len(batches)`` AdamW steps, by leaf, of the reference trained from the
    seed's weights."""
    ref, sizes, t = cell.reference(), cell.sizes, cell.traffic
    hp = t["adamw"]
    recipe, _ = _tensors(cell, seed, device)
    P, groups = {}, {}
    for i, (g, _) in enumerate(recipe):
        vals = weights.group_values(recipe, seed, i, device)
        groups[g] = list(vals)
        for n, v in vals.items():
            P[n] = v.requires_grad_(True)

    def W(g):
        return {n: P[n] for n in groups[g]}

    names = sorted(P)
    m = {n: torch.zeros_like(P[n]) for n in names}
    v = {n: torch.zeros_like(P[n]) for n in names}
    losses, grads = [], None
    with exact_matmuls():
        for step, batch in enumerate(batches, start=1):
            loss = ref.train_loss(W, batch, sizes, prec)
            loss.backward()
            losses.append(float(loss.detach()))
            del loss
            with torch.no_grad():
                norm = torch.sqrt(sum(P[n].grad.square().sum() for n in names))
                scale = torch.clamp(hp["clip_norm"] / (norm + 1e-12), max=1.0)
                if step == 1:
                    g1 = torch.stack([P[n].grad.norm() for n in names])
                    grads = dict(zip(names, g1.tolist()))
                lr = lr_at(step, t["lr"], t["warmup"], t["total_steps"])
                c1, c2 = 1 - hp["b1"] ** step, 1 - hp["b2"] ** step
                for n in names:
                    p = P[n]
                    g = p.grad.mul_(scale)
                    m[n].mul_(hp["b1"]).add_(g, alpha=1 - hp["b1"])
                    v[n].mul_(hp["b2"]).addcmul_(g, g, value=1 - hp["b2"])
                    p.grad = None
                    upd = (m[n] / c1).div_(torch.sqrt(v[n] / c2).add_(hp["eps"]))
                    upd.add_(p, alpha=hp["weight_decay"])
                    p.sub_(upd, alpha=lr)
                    del upd, g
    del m, v
    change = {}
    with torch.no_grad():
        for i in range(len(recipe)):
            for n, p0 in weights.group_values(recipe, seed, i, device).items():
                change[n] = float((P[n] - p0).norm())
    return {"loss": losses, "grad": grads, "change": change}


@torch.no_grad()
def reference_logits(cell, seed: int, batch: dict, device, prec: str = "fp32") -> torch.Tensor:
    """Logits (B, T, padded vocab) of the reference over ``batch``, each
    group's weights drawn from the seed as the forward pass reaches it."""
    recipe, index = _tensors(cell, seed, device)
    with exact_matmuls():
        return cell.reference().forward(
            lambda g: weights.group_values(recipe, seed, index[g], device), batch, cell.sizes,
            prec)
