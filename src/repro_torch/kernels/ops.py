"""Public wrappers for the ported kernels.

Gradients: forward passes run the kernels; backward passes recompute through
the plain oracles in :mod:`ref` (``torch.autograd.Function`` here, where the
JAX package uses ``jax.custom_vjp``), exactly like the JAX package's
``_flash_bwd``.  Fused backward kernels are future work.

All wrappers accept ``interpret=True``, which runs each kernel's plain
PyTorch version on CPU tensors (the CPU tests' path).  CUDA tensors launch
the CUDA kernel.
"""
from __future__ import annotations

import torch

from . import ref
from .flash_attention import flash_attention_fwd
from .matmul import matmul_tiled

__all__ = ["flash_attention", "matmul"]


# ---------------------------------------------------------- flash attention
class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_kv, interpret):
        # q: (B,Sq,H,hd) layout; the kernel takes (B,H,Sq,hd) — a transposed
        # view, no copy: the kernel reads strides and writes o in q's layout
        o = flash_attention_fwd(
            q.transpose(1, 2), k, v, causal=causal, block_q=block_q, block_kv=block_kv,
            interpret=interpret,
        )
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return o.transpose(1, 2)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            o = ref.flash_attention_ref(*leaves, causal=ctx.causal)
            dq, dk, dv = torch.autograd.grad(o, leaves, g)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal=True, block_q=128, block_kv=128, interpret=False):
    """q: (B,Sq,H,hd); k/v: (B,Kh,Skv,hd) -> (B,Sq,H,hd)."""
    return _Flash.apply(q, k, v, causal, block_q, block_kv, interpret)


# -------------------------------------------------------------------- matmul
def matmul(a, b, *, bm=128, bn=128, bk=32, interpret=False):
    return matmul_tiled(a, b, bm=bm, bn=bn, bk=bk, interpret=interpret)
