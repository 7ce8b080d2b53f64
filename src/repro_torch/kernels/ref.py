"""Plain PyTorch oracles for the ported kernels (the ``ref.py`` contract).

Counterparts of the JAX package's ``kernels/ref.py`` for the two kernels of
this slice: independent of the kernels' tiling, so the tests hold both the
plain versions in ``matmul.py`` / ``flash_attention.py`` and, on the card,
the CUDA kernels against them.
"""
from __future__ import annotations

import math

import torch

__all__ = ["flash_attention_ref", "matmul_ref"]


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


def matmul_ref(a, b):
    """(M,K) @ (K,N) with fp32 accumulation, cast back to ``a.dtype``."""
    return (a.float() @ b.float()).to(a.dtype)
