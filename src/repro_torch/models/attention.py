"""Attention: GQA/MQA/MHA, causal + sliding-window + cross, KV cache.

Port of the JAX package's ``models/attention.py``.

Cache layout (per attention instance):
    {"k": (B, Kh, W, hd), "v": (B, Kh, W, hd), "pos": (W,) int64}
``W`` = window size for local-attention layers (a ring buffer) else the
maximum sequence length.  ``pos`` holds the absolute position stored in each
slot (-1 = empty) and drives causal/window masking in prefill and decode
alike.  The batch advances in lockstep (one shared position per step).
Where the JAX package returns a new cache (``at[].set``), the port writes
the cache in place and returns the same dict.

The plain path (:func:`_sdpa`) is einsum + softmax in fp32, which the JAX
package leaves to XLA.  Its scores are the reference's product form: bf16
q and k multiplied with fp32 output (``preferred_element_type``), through
``aten::bmm.dtype`` on the card and on the dry run's meta tensors
(:func:`_scores`); that op has no CPU kernel, so on the CPU q and k are
upcast first, which gives the same values (a bf16 × bf16 product is exact
in fp32).  Under ``attn_impl="cuda"``, full-sequence attention
without a cache and without a window runs the ported flash kernel: the
training forward pass (causal) and the encoder of encoder–decoder models
(``causal=False``).  Cross-attention reads K/V precomputed from the context
(:func:`cross_kv`) through the plain path, unmasked and without rope.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ops as kops
from repro_torch.parallel.api import einsum, merge_dims, shard_index, split_dim

from .config import ExecConfig, ModelConfig
from .layers import Init, linear_apply, linear_init, rope_apply

__all__ = ["attn_init", "attn_apply", "init_attn_cache", "cross_kv"]

NEG_INF = -1e30


def attn_init(ini: Init, cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.d_head
    return {
        "wq": linear_init(ini, d, cfg.n_heads * hd, bias=cfg.qkv_bias),
        "wk": linear_init(ini, d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias),
        "wv": linear_init(ini, d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias),
        "wo": linear_init(ini, cfg.n_heads * hd, d),
    }


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int, *, window: int = 0,
                    device=None) -> dict:
    w = min(window, max_len) if window > 0 else max_len
    shape = (batch, cfg.n_kv_heads, w, cfg.d_head)
    dt = getattr(torch, cfg.compute_dtype)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "pos": torch.full((w,), -1, dtype=torch.int64, device=device),
    }


def _mask(q_pos, kv_pos, *, causal: bool, window: int):
    """(Sq, Skv) bool validity mask from absolute positions."""
    valid = (kv_pos[None, :] >= 0).expand(q_pos.shape[0], kv_pos.shape[0])
    if causal:
        valid = valid & (kv_pos[None, :] <= q_pos[:, None])
    if window > 0:
        valid = valid & (q_pos[:, None] - kv_pos[None, :] < window)
    return valid


def _bmm_fp32(a, b) -> torch.Tensor:
    """(N, M, K) × (N, K, P) bf16 -> (N, M, P) fp32: one product with fp32
    accumulation and output, on the tensor cores on the card."""
    return torch.ops.aten.bmm.dtype(a, b, torch.float32)


class _ScoresFp32(torch.autograd.Function):
    """``_bmm_fp32`` under autograd (``aten::bmm.dtype`` has no derivative).
    The backward forms the operands' gradients from the fp32 gradient of
    the scores as the upcast form's autograd does: fp32 products on fp32
    copies, rounded to the operands' dtype.  The output is not a view, so
    the scale and the mask may run in place on it."""

    @staticmethod
    def forward(ctx, a, b, shape):
        ctx.save_for_backward(a, b)
        return torch.ops.aten._unsafe_view(_bmm_fp32(a, b), shape)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.reshape(a.shape[0], a.shape[1], b.shape[2])
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype)
        return ga, gb, None


def _scores_bmm(qh, k) -> torch.Tensor:
    """qh (B, Sq, Kh, g, hd) · k (B, Kh, Skv, hd) -> fp32 (B, Kh, g, Sq, Skv)
    through :class:`_ScoresFp32` on the (B·Kh, g·Sq, hd) × (B·Kh, hd, Skv)
    views that the GQA grouping allows (a contiguous K, as the cache is,
    is not copied)."""
    B, Sq, Kh, g, hd = qh.shape
    Skv = k.shape[2]
    a = qh.permute(0, 2, 3, 1, 4).reshape(B * Kh, g * Sq, hd)
    b = k.reshape(B * Kh, Skv, hd).transpose(1, 2)
    return _ScoresFp32.apply(a, b, (B, Kh, g, Sq, Skv))


def _scores(eq: str, qh, k) -> torch.Tensor:
    """``eq`` = "bqkgh,bksh->bkgqs" with fp32 output: bf16 off the CPU by
    :func:`_scores_bmm`, elsewhere the einsum of fp32 copies (the same
    values)."""
    if qh.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 or qh.device.type == "cpu":
        return torch.einsum(eq, qh.float(), k.float())
    return _scores_bmm(qh, k)


def _sdpa(q, k, v, mask) -> torch.Tensor:
    """q: (B,Sq,H,hd), k/v: (B,Kh,Skv,hd), mask: (Sq,Skv) -> (B,Sq,H,hd).
    fp32 scores (:func:`_scores`), scaled and masked in place, and an fp32
    softmax; GQA via head grouping."""
    B, Sq, H, hd = q.shape
    Kh = k.shape[1]
    qh = split_dim(q, 2, Kh)
    scores = einsum("bqkgh,bksh->bkgqs", qh, k, local=_scores)
    scores.mul_(1.0 / math.sqrt(hd))
    scores.masked_fill_(~mask[None, None, None], NEG_INF)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = einsum("bkgqs,bksh->bqkgh", p, v)
    return out.reshape(B, Sq, H, hd)


def _sdpa_flashcost(q, k, v) -> torch.Tensor:
    """Kernel-cost surrogate for the dry run (``attn_impl="flashcost"``).

    The flash kernel cannot run on the dry run's meta tensors, so the dry
    run counts THIS instead: it reads Q/K/V once and writes O once (the
    kernel's HBM traffic: the S² tile never leaves shared memory), while
    the kernel's tensor-core FLOPs are added back analytically
    (``launch.costing.attention_traffic``).  Not a numerics path."""
    B, Sq, H, hd = q.shape
    Kh = k.shape[1]
    mk = k.mean(dim=2)  # (B,Kh,hd): touches all of K
    mv = v.mean(dim=2)
    g = H // Kh
    mk = mk.repeat_interleave(g, dim=1)[:, None]  # (B,1,H,hd)
    mv = mv.repeat_interleave(g, dim=1)[:, None]
    return q * mk + mv


def _sdpa_flash(q, k, v, *, causal: bool, exec_cfg: ExecConfig) -> torch.Tensor:
    """Flash-attention kernel path (full sequence, no cache, no window)."""
    return kops.flash_attention(q, k, v, causal=causal, block_q=exec_cfg.block_q,
                                block_kv=exec_cfg.block_kv, interpret=exec_cfg.interpret)


def _write_ring(cache: dict, slots, kc, vc, q_pos) -> None:
    """Write K/V (B,Kh,S,hd) and the positions into ring slots ``slots``,
    in place."""
    if not isinstance(cache["k"], DTensor):
        cache["k"][:, :, slots] = kc
        cache["v"][:, :, slots] = vc
        cache["pos"][slots] = q_pos.to(cache["pos"].dtype)
        return
    _write_shards(cache["k"], 2, slots, kc)
    _write_shards(cache["v"], 2, slots, vc)
    _write_shards(cache["pos"], 0, slots, q_pos.to(cache["pos"].dtype))


def _write_shards(buf, dim: int, slots, val) -> None:
    """``buf``'s entries ``slots`` along ``dim`` = ``val``, in place, for a
    DTensor cache (the dry run's): each rank writes into its shard the rows
    whose slots it holds, as GSPMD writes a sharded dynamic-update-slice,
    and no collective moves the cache.  Rows held elsewhere are aimed at
    the first row this rank writes (with its value) or, when it writes
    none, back at its own first slot (with the value there), so every
    duplicate index carries one value."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = buf.device_mesh
    on_dim = [i for i, pl in enumerate(buf.placements) if isinstance(pl, Shard) and pl.dim == dim]
    if isinstance(val, DTensor):  # like the cache on the other dims, whole along dim
        val = val.redistribute(mesh, [Replicate() if i in on_dim else pl
                                      for i, pl in enumerate(buf.placements)]).to_local()
    local = buf.to_local()
    shard = shard_index(mesh, on_dim)
    idx = slots - shard * local.shape[dim]
    mine = (idx >= 0) & (idx < local.shape[dim])
    first = torch.argmax(mine.to(torch.int32)).reshape(1)
    anyone = mine.any()
    idx = torch.where(mine, idx, torch.where(anyone, idx[first], torch.zeros_like(idx[first])))
    keep = mine.reshape([-1 if d == dim else 1 for d in range(val.ndim)])
    fill = torch.where(anyone, val.index_select(dim, first), local.narrow(dim, 0, 1))
    local.index_copy_(dim, idx, torch.where(keep, val, fill))


def cross_kv(cfg: ModelConfig, p: dict, ctx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V (B, Kh, N, hd) from context embeddings (B, N, D)."""
    B, N, _ = ctx.shape
    k = split_dim(linear_apply(p["wk"], ctx), -1, cfg.n_kv_heads)
    v = split_dim(linear_apply(p["wv"], ctx), -1, cfg.n_kv_heads)
    return k.transpose(1, 2), v.transpose(1, 2)


def attn_apply(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    *,
    q_pos: torch.Tensor,  # (Sq,) absolute positions of the query tokens
    cache: Optional[dict] = None,
    kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # cross-attn K/V
    causal: bool = True,
    window: int = 0,
    rope: bool = True,
    exec_cfg: ExecConfig = ExecConfig(),
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Self- or cross-attention with an optional KV cache.

    Modes:
      * train/encode: ``cache=None, kv=None`` — full-sequence self-attention.
      * prefill:      ``cache=empty``, Sq > 1 — fills the cache.
      * decode:       ``cache=filled``, Sq = 1 — appends one step.
      * cross:        ``kv=(k,v)`` precomputed from context; no cache update.
    """
    B, Sq, D = x.shape
    H, Kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = split_dim(linear_apply(p["wq"], x), -1, H)

    if kv is not None:  # ---------------------------------------- cross-attn
        k, v = kv
        if exec_cfg.attn_impl == "flashcost":
            out = _sdpa_flashcost(q, k, v)
        else:
            mask = torch.ones((Sq, k.shape[2]), dtype=torch.bool, device=x.device)
            out = _sdpa(q, k, v, mask)
        return linear_apply(p["wo"], merge_dims(out, 2)), cache

    kc = split_dim(linear_apply(p["wk"], x), -1, Kh)
    vc = split_dim(linear_apply(p["wv"], x), -1, Kh)
    if rope:
        q = rope_apply(q, q_pos, cfg.rope_theta)
        kc = rope_apply(kc, q_pos, cfg.rope_theta)
    kc = kc.transpose(1, 2)  # (B,Kh,Sq,hd)
    vc = vc.transpose(1, 2)

    if cache is None:  # ------------------------------------- train / encode
        if exec_cfg.attn_impl == "cuda" and window == 0:
            out = _sdpa_flash(q, kc, vc, causal=causal, exec_cfg=exec_cfg)
        elif exec_cfg.attn_impl == "flashcost":
            out = _sdpa_flashcost(q, kc, vc)
        else:
            out = _sdpa(q, kc, vc, _mask(q_pos, q_pos, causal=causal, window=window))
        return linear_apply(p["wo"], merge_dims(out, 2)), None

    # ------------------------------------------------- prefill / decode step
    W = cache["k"].shape[2]
    if Sq > 1:
        # prefill: attend over the in-flight full sequence (correct even when
        # Sq > W), then persist only the last W entries into the ring
        if exec_cfg.attn_impl == "flashcost":
            out = _sdpa_flashcost(q, kc, vc)
        else:
            out = _sdpa(q, kc, vc, _mask(q_pos, q_pos, causal=causal, window=window))
        if Sq > W:
            kc, vc, q_pos = kc[:, :, Sq - W:], vc[:, :, Sq - W:], q_pos[Sq - W:]
        _write_ring(cache, torch.remainder(q_pos, W), kc, vc, q_pos)
        return linear_apply(p["wo"], merge_dims(out, 2)), cache

    # decode: write one step into slot pos mod W, attend over the cache
    _write_ring(cache, torch.remainder(q_pos, W), kc, vc, q_pos)
    if exec_cfg.attn_impl == "flashcost":
        out = _sdpa_flashcost(q, cache["k"], cache["v"])
    else:
        out = _sdpa(q, cache["k"], cache["v"],
                    _mask(q_pos, cache["pos"], causal=causal, window=window))
    return linear_apply(p["wo"], merge_dims(out, 2)), cache
