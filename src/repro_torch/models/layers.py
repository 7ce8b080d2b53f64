"""Shared layers: norms, RoPE, FFNs, embeddings — init + apply on plain
dicts of tensors, as in the JAX package's ``models/layers.py``.

Parameter trees have the JAX package's key names, so weights convert one to
one (:mod:`repro_torch.models.convert`).  Apply functions cast a weight to
the activation dtype at use where the JAX package does (``.to(dt)`` is free
when the weight is already stored in that dtype, see ``model.py``); norms
compute in fp32.  Initializers draw from an explicit ``torch.Generator`` on
an explicit device: the same distributions as ``jax.random``, not the same
numbers.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.parallel.api import matmul

__all__ = [
    "Init",
    "norm_init",
    "norm_apply",
    "linear_init",
    "linear_apply",
    "rope_apply",
    "ffn_init",
    "ffn_apply",
    "embed_init",
    "gelu",
]


class Init:
    """fp32 parameter factory: one generator, one device."""

    def __init__(self, generator: torch.Generator, device):
        self.gen = generator
        self.device = torch.device(device)

    def nrm(self, shape, scale: float) -> torch.Tensor:
        """``scale`` × a unit normal truncated to [-2, 2] (JAX's ``_nrm``)."""
        t = torch.empty(shape, dtype=torch.float32, device=self.device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=self.gen)
        return t.mul_(scale)

    def uniform(self, shape, lo: float, hi: float) -> torch.Tensor:
        t = torch.empty(shape, dtype=torch.float32, device=self.device)
        return torch.nn.init.uniform_(t, lo, hi, generator=self.gen)

    def full(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, dtype=torch.float32, device=self.device)

    def zeros(self, shape) -> torch.Tensor:
        return self.full(shape, 0.0)

    def ones(self, shape) -> torch.Tensor:
        return self.full(shape, 1.0)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh approximation, its default)."""
    return F.gelu(x, approximate="tanh")


# ------------------------------------------------------------------- norms
def norm_init(ini: Init, kind: str, d: int) -> dict:
    p = {"scale": ini.ones((d,))}
    if kind == "layernorm":
        p["bias"] = ini.zeros((d,))
    return p


def norm_apply(kind: str, p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    if kind == "layernorm":
        mu = x.mean(dim=-1, keepdim=True)
        var = (x - mu).square().mean(dim=-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:  # rmsnorm
        ms = x.square().mean(dim=-1, keepdim=True)
        y = x * torch.rsqrt(ms + eps) * p["scale"]
    return y.to(dt)


# ------------------------------------------------------------------ linear
def linear_init(ini: Init, d_in: int, d_out: int, *, bias: bool = False) -> dict:
    p = {"w": ini.nrm((d_in, d_out), 1.0 / math.sqrt(d_in))}
    if bias:
        p["b"] = ini.zeros((d_out,))
    return p


def linear_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# -------------------------------------------------------------------- RoPE
def rope_apply(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (S,) integer.  cos/sin computed on the
    fly in fp32 (no table)."""
    hd = x.shape[-1]
    half = hd // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.to(device=x.device, dtype=torch.float32)[:, None] * freqs[None, :]
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# --------------------------------------------------------------------- FFN
def ffn_init(ini: Init, kind: str, d: int, d_ff: int) -> dict:
    if kind in ("swiglu", "geglu"):
        return {
            "wi": ini.nrm((d, d_ff), 1.0 / math.sqrt(d)),
            "wg": ini.nrm((d, d_ff), 1.0 / math.sqrt(d)),
            "wo": ini.nrm((d_ff, d), 1.0 / math.sqrt(d_ff)),
        }
    if kind == "gelu":
        return {
            "wi": ini.nrm((d, d_ff), 1.0 / math.sqrt(d)),
            "bi": ini.zeros((d_ff,)),
            "wo": ini.nrm((d_ff, d), 1.0 / math.sqrt(d_ff)),
            "bo": ini.zeros((d,)),
        }
    raise ValueError(f"unknown ffn kind {kind}")


def ffn_apply(kind: str, p: dict, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    if kind in ("swiglu", "geglu"):
        act = F.silu if kind == "swiglu" else gelu
        h = act(matmul(x, p["wg"].to(dt))) * matmul(x, p["wi"].to(dt))
        return matmul(h, p["wo"].to(dt))
    if kind == "gelu":
        h = gelu(matmul(x, p["wi"].to(dt)) + p["bi"].to(dt))
        return matmul(h, p["wo"].to(dt)) + p["bo"].to(dt)
    raise ValueError(f"unknown ffn kind {kind}")


# --------------------------------------------------------------- embedding
def embed_init(ini: Init, vocab: int, d: int) -> dict:
    return {"table": ini.nrm((vocab, d), 1.0)}
