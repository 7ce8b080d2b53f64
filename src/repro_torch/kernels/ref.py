"""Plain PyTorch oracles for the ported kernels (the ``ref.py`` contract).

Counterparts of the JAX package's ``kernels/ref.py`` for the ported
kernels: independent of the kernels' tiling and staging, so the tests hold
both the plain versions in the kernel modules and, on the card, the CUDA
kernels against them.  The two scan oracles are the exact per-token
recurrences; ``models/rglru.py`` and ``models/rwkv6.py`` use them as their
decode (T = 1) step, as the JAX package does.
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "flash_attention_ref",
    "decode_attention_ref",
    "matmul_ref",
    "lru_scan_ref",
    "rwkv_scan_ref",
]


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """q: (B,Sq,H,hd), k/v: (B,Kh,Skv,hd) -> (B,Sq,H,hd).  GQA by grouping.

    Causal masking here is ``tril(k=Skv-Sq)`` (bottom-right aligned), as in
    the JAX oracle; the kernels align top-left.  The two agree for Sq == Skv.
    """
    B, Sq, H, hd = q.shape
    Kh, Skv = k.shape[1], k.shape[2]
    g = H // Kh
    qh = q.reshape(B, Sq, Kh, g, hd).float()
    s = torch.einsum("bqkgh,bksh->bkgqs", qh, k.float())
    s = s * (1.0 / math.sqrt(hd))
    if causal:
        mask = torch.tril(torch.ones(Sq, Skv, dtype=torch.bool, device=q.device), diagonal=Skv - Sq)
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgqs,bksh->bqkgh", p.float(), v.float()).to(v.dtype)
    return o.reshape(B, Sq, H, hd)


def decode_attention_ref(q, k, v, length):
    """Single-step decode: q: (B,H,hd); k/v: (B,Kh,S,hd); length: int —
    number of valid cache entries.  -> (B,H,hd).  As in the JAX oracle, p is
    rounded to ``v.dtype`` before the P·V product (the kernels keep it fp32)."""
    B, H, hd = q.shape
    Kh, S = k.shape[1], k.shape[2]
    g = H // Kh
    qh = q.reshape(B, Kh, g, hd).float()
    s = torch.einsum("bkgh,bksh->bkgs", qh, k.float()) * (1.0 / math.sqrt(hd))
    valid = torch.arange(S, device=q.device) < length
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgs,bksh->bkgh", p.float(), v.float()).to(v.dtype)
    return o.reshape(B, H, hd)


def matmul_ref(a, b):
    """(M,K) @ (K,N) with fp32 accumulation, cast back to ``a.dtype``."""
    return (a.float() @ b.float()).to(a.dtype)


def lru_scan_ref(a, b, h0):
    """Exact per-token scan h_t = a_t h_{t-1} + b_t.  a, b: (B,T,D); h0: (B,D).
    Returns (hs (B,T,D), hT (B,D)) in the dtype the products promote to."""
    h, hs = h0, []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def rwkv_scan_ref(r, k, v, lw, u, s0):
    """Exact RWKV-6 WKV recurrence, per token, in fp32.

    r, k, v, lw: (B,T,H,hd), lw = log decay (<= 0); u: (H,hd);
    s0: (B,H,hd,hd) -> y: (B,T,H,hd) in ``r.dtype``, sT: (B,H,hd,hd) fp32."""
    rf, kf, vf, lwf = (x.float() for x in (r, k, v, lw))
    uf = u.float()
    S, ys = s0.float(), []
    for t in range(r.shape[1]):
        akv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # (B,H,hd,hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], S + uf[None, :, :, None] * akv))
        S = torch.exp(lwf[:, t])[..., :, None] * S + akv
    return torch.stack(ys, dim=1).to(r.dtype), S
