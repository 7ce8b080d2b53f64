"""Public wrappers for the ported kernels.

Gradients (``torch.autograd.Function`` here, where the JAX package uses
``jax.custom_vjp``): forward passes run the kernels (``decode_attention`` is
inference-only and has none, as in the JAX package).  The two scans'
backward passes are kernels too (``linear_scan.lru_scan_bwd`` and
``rwkv_scan_bwd``: a fixed number of launches whatever T, where the JAX
package takes ``jax.vjp`` of its per-token ``lax.scan``); on CPU tensors with
``interpret=True`` they run their plain versions.  So is flash attention's
(``flash_attention.flash_attention_bwd``: two launches a call, P recomputed
from the row logsumexp the forward saves, no S² buffer), where the JAX
package's ``_flash_bwd`` takes ``jax.vjp`` of its oracle; it is the same
gradient for every call the models make (self-attention, Sq == Skv).  No
backward here runs an oracle of :mod:`ref`.

All wrappers accept ``interpret=True``, which runs each kernel's plain
PyTorch version on CPU tensors (the CPU tests' path).  CUDA tensors launch
the CUDA kernel.

Each ``Function``'s forward and backward runs under a span
(``ops.<kernel>.fwd`` / ``.bwd``, :mod:`repro_torch.obs.trace`): a no-op
unless tracing or ``torch.profiler`` is on, then a range around the
wrapper's host time.  The backward's span opens on whichever thread autograd
runs it on (its own on the card, so there it is a root).
"""
from __future__ import annotations

import torch

from repro_torch.obs.trace import span as _span

from .decode_attention import decode_attention_fwd
from .flash_attention import flash_attention_bwd, flash_attention_fwd
from . import linear_scan
from .linear_scan import LRU_BLOCK_D, lru_scan_chunked, rwkv_scan_chunked
from .matmul import matmul_tiled

__all__ = ["flash_attention", "decode_attention", "rwkv_scan", "lru_scan", "matmul"]


# ---------------------------------------------------------- flash attention
class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_kv, interpret, grad):
        # q: (B,Sq,H,hd) layout; the kernel takes (B,H,Sq,hd) — a transposed
        # view, no copy: the kernel reads strides and writes o in q's layout.
        # The row logsumexp is asked for only when a gradient will be taken
        # (``grad``: forward runs with grad mode off, so the caller decides),
        # so inference launches what it launched before.
        knobs = {"causal": causal, "block_q": block_q, "block_kv": block_kv, "interpret": interpret}
        with _span("ops.flash.fwd", cat="kernels"):
            if not grad:
                return flash_attention_fwd(q.transpose(1, 2), k, v, **knobs).transpose(1, 2)
            o, lse = flash_attention_fwd(q.transpose(1, 2), k, v, return_lse=True, **knobs)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.knobs = knobs
        return o.transpose(1, 2)

    @staticmethod
    def backward(ctx, g):
        with _span("ops.flash.bwd", cat="kernels"):
            q, k, v, o, lse = ctx.saved_tensors
            if g.stride(-1) != 1:
                g = g.contiguous()
            dq, dk, dv = flash_attention_bwd(q.transpose(1, 2), k, v, o, lse, g.transpose(1, 2),
                                             **ctx.knobs)
        return dq.transpose(1, 2), dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal=True, block_q=128, block_kv=128, interpret=False):
    """q: (B,Sq,H,hd); k: (B,Kh,Skv,hd); v: (B,Kh,Skv,hd_v) -> (B,Sq,H,hd_v).
    A v narrower than k (latent attention's prefill) has no backward."""
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if grad and v.shape[-1] != k.shape[-1]:
        raise ValueError("flash_attention: no backward for value heads narrower than key heads "
                         f"({v.shape[-1]} < {k.shape[-1]})")
    return _Flash.apply(q, k, v, causal, block_q, block_kv, interpret, grad)


# ---------------------------------------------------------- decode attention
def decode_attention(q, k, v, valid, *, block_kv=512, interpret=False):
    """Inference-only (no gradient, as in the JAX package). q: (B,H,hd);
    k/v: (B,Kh,S,hd); valid: (B,S) int32."""
    return decode_attention_fwd(q, k, v, valid, block_kv=block_kv, interpret=interpret)


# ----------------------------------------------------------------- rwkv scan
class _Rwkv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, lw, u, s0, chunk, interpret):
        ctx.save_for_backward(r, k, v, lw, u, s0)
        ctx.interpret = interpret
        with _span("ops.rwkv.fwd", cat="kernels"):
            return rwkv_scan_chunked(r, k, v, lw, u, s0, chunk=chunk, interpret=interpret)

    @staticmethod
    def backward(ctx, gy, gs):
        with _span("ops.rwkv.bwd", cat="kernels"):
            grads = linear_scan.rwkv_scan_bwd(*ctx.saved_tensors, gy, gs, interpret=ctx.interpret)
        return (*grads, None, None)


def rwkv_scan(r, k, v, lw, u, s0, *, chunk=64, interpret=False):
    """WKV scan: r,k,v,lw (B,T,H,hd); u (H,hd); s0 (B,H,hd,hd)."""
    return _Rwkv.apply(r, k, v, lw, u, s0, chunk, interpret)


# ------------------------------------------------------------------ lru scan
class _Lru(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, h0, chunk, block_d, interpret):
        ctx.save_for_backward(a, b, h0)
        ctx.knobs = {"chunk": chunk, "block_d": block_d, "interpret": interpret}
        with _span("ops.lru.fwd", cat="kernels"):
            return lru_scan_chunked(a, b, h0, chunk=chunk, block_d=block_d, interpret=interpret)

    @staticmethod
    def backward(ctx, ghs, ghT):
        with _span("ops.lru.bwd", cat="kernels"):
            grads = linear_scan.lru_scan_bwd(*ctx.saved_tensors, ghs, ghT, **ctx.knobs)
        return (*grads, None, None, None)


def lru_scan(a, b, h0, *, chunk=128, block_d=LRU_BLOCK_D, interpret=False):
    """First-order scan h_t = a_t h_{t-1} + b_t.  a,b: (B,T,D); h0: (B,D).
    Unlike the JAX wrapper, ``block_d`` reaches the kernel."""
    return _Lru.apply(a, b, h0, chunk, block_d, interpret)


# -------------------------------------------------------------------- matmul
def matmul(a, b, *, bm=None, bn=None, bk=None, interpret=False):
    return matmul_tiled(a, b, bm=bm, bn=bn, bk=bk, interpret=interpret)
