"""Plain PyTorch pieces the references share: float32 arithmetic with the
TF32 paths switched off, and the operands of every product rounded to a
stated precision.

``prec`` is "fp32" (the reference) or "fp8" (e4m3 with a scale per tensor:
the control, one step below the configurations' bfloat16).  What
the configuration holds in bfloat16 is rounded: the operands of its
products and the residual stream after each add; the rest (norms,
softmax, the scan's state, the decay) stays float32.  Under autograd the rounding passes the
gradient straight through.  Nothing here imports the program.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

__all__ = ["exact_matmuls", "rnd", "mm", "layernorm", "rope", "attention", "gelu",
           "cross_entropy", "PRECISIONS"]

PRECISIONS = ("fp32", "fp8")
_FP8_MAX = 448.0


@contextlib.contextmanager
def exact_matmuls():
    """float32 products without TF32, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _round(x: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "fp8":
        scale = x.detach().abs().amax().clamp(min=1e-30) / _FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown precision {prec!r}")


def rnd(x: torch.Tensor, prec: str) -> torch.Tensor:
    """``x`` (float32) rounded to ``prec``; the gradient passes straight."""
    if prec == "fp32":
        return x
    if x.requires_grad:
        return x + (_round(x.detach(), prec) - x).detach()
    return _round(x, prec)


def mm(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    return rnd(x, prec) @ rnd(w, prec)


def layernorm(x, scale, bias, eps: float = 1e-6):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def gelu(x):
    return F.gelu(x, approximate="tanh")


def rope(x, theta: float = 10_000.0):
    """Rotary positions 0..S-1 on x (B, S, H, hd), halves rotated."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs[None]
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, causal: bool, prec: str):
    """q (B, Sq, H, hd), k/v (B, Skv, H, hd) -> (B, Sq, H, hd): softmax of
    the scaled scores, causal with query i seeing keys 0..i."""
    hd = q.shape[-1]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    s = rnd(qh, prec) @ rnd(kh, prec).transpose(-1, -2) / math.sqrt(hd)
    if causal:
        Sq, Skv = s.shape[-2:]
        keep = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return (rnd(p, prec) @ rnd(vh, prec)).transpose(1, 2)


def cross_entropy(logits, labels, vocab_size: int):
    """Mean over the labels in [0, vocab_size) of logsumexp over every
    column (pad columns included, as the program's loss) minus the label's."""
    valid = (labels >= 0) & (labels < vocab_size)
    lab = labels.clamp(0, vocab_size - 1)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lab[..., None])[..., 0]
    v = valid.float()
    return ((lse - ll) * v).sum() / v.sum().clamp(min=1.0)
