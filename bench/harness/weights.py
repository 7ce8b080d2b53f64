"""Weights made from ``--seed`` by the recipe of the configuration's
reference, one group (a layer, the embedding, the head) at a time.

A group is drawn with one ``torch.randn`` call on the device from a
generator seeded by (seed, group), cut into its leaves, each clamped to
[-2, 2] and scaled: so any group can be drawn again alone, by the program's
set-up and by the reference alike, and both get the same fp32 values (the
program stores them in the dtype it serves them in).
"""
from __future__ import annotations

import math

import torch

from .inputs import mix_seed

__all__ = ["group_values", "load_into", "leaf_names"]


def leaf_names(recipe: list) -> list:
    return [name for _, leaves in recipe for name, _, _ in leaves]


def group_values(recipe: list, seed: int, index: int, device) -> dict:
    """{leaf name: fp32 tensor} of group ``index`` of ``recipe`` (a list of
    (group name, [(leaf name, shape, init)]); init is ("normal", scale) or
    ("const", value))."""
    _, leaves = recipe[index]
    sizes = [math.prod(shape) if init[0] == "normal" else 0 for _, shape, init in leaves]
    gen = torch.Generator(device=device).manual_seed(mix_seed(seed, "weights", index))
    flat = torch.randn(sum(sizes), generator=gen, device=device) if sum(sizes) else None
    out, off = {}, 0
    for (name, shape, init), n in zip(leaves, sizes):
        if init[0] == "normal":
            out[name] = flat[off:off + n].view(shape).clamp_(-2.0, 2.0).mul_(init[1])
            off += n
        else:
            out[name] = torch.full(shape, float(init[1]), dtype=torch.float32, device=device)
    return out


@torch.no_grad()
def load_into(params: dict, recipe: list, seed: int) -> None:
    """Write the recipe's values into the program's parameters (by name,
    cast to each parameter's dtype).  Every parameter must be in the
    recipe with its shape, and every leaf of the recipe in the program."""
    names = leaf_names(recipe)
    if sorted(names) != sorted(params):
        missing = sorted(set(params) - set(names))
        extra = sorted(set(names) - set(params))
        raise ValueError(f"recipe and program differ: program only {missing[:5]}, "
                         f"recipe only {extra[:5]}")
    device = next(iter(params.values())).device
    for i in range(len(recipe)):
        for name, val in group_values(recipe, seed, i, device).items():
            p = params[name]
            if tuple(p.shape) != tuple(val.shape):
                raise ValueError(f"{name}: program {tuple(p.shape)}, recipe {tuple(val.shape)}")
            p.copy_(val)
