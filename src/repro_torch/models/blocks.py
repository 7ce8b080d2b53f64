"""Block kinds: init / state-init / apply, dispatched by kind string.

Port of the JAX package's ``models/blocks.py``.  Every apply shares the
signature::

    apply_block(kind, cfg, p, x, st, *, q_pos, ctx, mode, causal, exec_cfg)
        -> (x, new_state, aux_loss)

``st`` is the block's cache/state ({} for stateless full-sequence
attention); ``ctx`` is the cross-attention context embeddings (B, N, D)
when present; ``aux_loss`` is the MoE router's (a 0-d fp32 zero for the
dense FFNs; None for the recurrent kinds, whose decode step then launches
no zero fill and no add for it).  ``layer`` (keyword, the block's index in
its stack; -1 for none) names an MoE layer's load counter.

The ``mla`` and ``mla_dense`` kinds (latent attention, :mod:`.mla`; the
config's FFN or a dense SwiGLU of ``d_ff``) have no JAX counterpart; their
norms use ``cfg.norm_eps``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .attention import attn_apply, attn_init, cross_kv, init_attn_cache
from .config import ExecConfig, ModelConfig
from .layers import Init, ffn_apply, ffn_init, norm_apply, norm_init
from .mla import init_mla_cache, mla_apply, mla_init
from .moe import moe_apply, moe_init
from .rglru import init_rglru_state, rglru_apply, rglru_init
from .rwkv6 import init_rwkv_state, rwkv_apply, rwkv_init

__all__ = ["init_block", "init_block_state", "apply_block", "BLOCK_KINDS"]

BLOCK_KINDS = ("attn", "cross", "rwkv", "rglru", "mla", "mla_dense")


def _ffn_params(ini: Init, cfg: ModelConfig) -> dict:
    if cfg.ffn == "moe":
        return moe_init(ini, cfg)
    return ffn_init(ini, cfg.ffn, cfg.d_model, cfg.d_ff)


def _apply_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor, layer: int = -1):
    if cfg.ffn == "moe":
        return moe_apply(cfg, p, x, layer)
    return ffn_apply(cfg.ffn, p, x), torch.zeros((), dtype=torch.float32, device=x.device)


def init_block(ini: Init, kind: str, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    if kind == "attn":
        return {
            "norm1": norm_init(ini, cfg.norm, d),
            "attn": attn_init(ini, cfg),
            "norm2": norm_init(ini, cfg.norm, d),
            "ffn": _ffn_params(ini, cfg),
        }
    if kind == "cross":
        return {
            "norm1": norm_init(ini, cfg.norm, d),
            "attn": attn_init(ini, cfg),
            "normx": norm_init(ini, cfg.norm, d),
            "xattn": attn_init(ini, cfg),
            "norm2": norm_init(ini, cfg.norm, d),
            "ffn": _ffn_params(ini, cfg),
        }
    if kind in ("mla", "mla_dense"):
        return {
            "norm1": norm_init(ini, cfg.norm, d),
            "attn": mla_init(ini, cfg),
            "norm2": norm_init(ini, cfg.norm, d),
            "ffn": _ffn_params(ini, cfg) if kind == "mla" else ffn_init(ini, "swiglu", d, cfg.d_ff),
        }
    if kind == "rwkv":
        return rwkv_init(ini, cfg)
    if kind == "rglru":
        return {
            "norm1": norm_init(ini, cfg.norm, d),
            "rec": rglru_init(ini, cfg),
            "norm2": norm_init(ini, cfg.norm, d),
            "ffn": ffn_init(ini, cfg.ffn if cfg.ffn != "moe" else "geglu", d, cfg.d_ff),
        }
    raise ValueError(f"unknown block kind {kind}")


def init_block_state(kind: str, cfg: ModelConfig, batch: int, max_len: int, mode: str, *,
                     window: int, device) -> dict:
    """State/cache for one block instance.  Train mode: only recurrent kinds
    carry state (zero-init); attention needs none.  A cross block also holds
    the context's K/V (``xk``, ``xv``), written at prefill and read by
    every decode step."""
    if kind in ("attn", "cross"):
        if mode == "train":
            return {}
        st = {"kv": init_attn_cache(cfg, batch, max_len, window=window, device=device)}
        if kind == "cross":
            shape = (batch, cfg.n_kv_heads, cfg.ctx_tokens, cfg.d_head)
            dt = getattr(torch, cfg.compute_dtype)
            st["xk"] = torch.zeros(shape, dtype=dt, device=device)
            st["xv"] = torch.zeros(shape, dtype=dt, device=device)
        return st
    if kind in ("mla", "mla_dense"):
        return {} if mode == "train" else {"kv": init_mla_cache(cfg, batch, max_len, device=device)}
    if kind == "rwkv":
        return init_rwkv_state(cfg, batch, device)
    if kind == "rglru":
        return init_rglru_state(cfg, batch, device)
    raise ValueError(f"unknown block kind {kind}")


def apply_block(
    kind: str,
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    st: Optional[dict],
    *,
    q_pos: torch.Tensor,
    ctx: Optional[torch.Tensor],
    mode: str,
    causal: bool,
    exec_cfg: ExecConfig,
    layer: int = -1,
) -> Tuple[torch.Tensor, dict, Optional[torch.Tensor]]:
    st = st or {}
    if kind in ("mla", "mla_dense"):
        eps = cfg.norm_eps
        h, new_kv = mla_apply(cfg, p["attn"], norm_apply(cfg.norm, p["norm1"], x, eps),
                              q_pos=q_pos, cache=st.get("kv"), causal=causal, exec_cfg=exec_cfg)
        x = x + h
        h2 = norm_apply(cfg.norm, p["norm2"], x, eps)
        if kind == "mla":
            h, aux = _apply_ffn(cfg, p["ffn"], h2, layer)
        else:
            h, aux = ffn_apply("swiglu", p["ffn"], h2), torch.zeros(
                (), dtype=torch.float32, device=x.device)
        return x + h, ({"kv": new_kv} if new_kv is not None else {}), aux
    if kind in ("attn", "cross"):
        h, new_kv = attn_apply(
            cfg, p["attn"], norm_apply(cfg.norm, p["norm1"], x), q_pos=q_pos,
            cache=st.get("kv"), causal=causal, window=cfg.window, exec_cfg=exec_cfg,
        )
        x = x + h
        new_st = {"kv": new_kv} if new_kv is not None else {}
        if kind == "cross":
            # decode reads the K/V prefill stored; prefill and train compute
            # them, and prefill writes them into the state in place
            xkv = (st["xk"], st["xv"]) if mode == "decode" else cross_kv(cfg, p["xattn"], ctx)
            if mode == "prefill" and st["xk"].shape == xkv[0].shape:
                st["xk"].copy_(xkv[0])
                st["xv"].copy_(xkv[1])
                xkv = (st["xk"], st["xv"])
            h, _ = attn_apply(
                cfg, p["xattn"], norm_apply(cfg.norm, p["normx"], x), q_pos=q_pos, kv=xkv,
                causal=False, rope=False, exec_cfg=exec_cfg,
            )
            x = x + h
            if mode != "train":
                new_st["xk"], new_st["xv"] = xkv
        h, aux = _apply_ffn(cfg, p["ffn"], norm_apply(cfg.norm, p["norm2"], x))
        return x + h, new_st, aux

    if kind == "rwkv":
        y, new_st = rwkv_apply(cfg, p, x, st, exec_cfg=exec_cfg)
        return y, new_st, None

    if kind == "rglru":
        h, new_st = rglru_apply(cfg, p["rec"], norm_apply(cfg.norm, p["norm1"], x), st,
                                exec_cfg=exec_cfg)
        x = x + h
        h = ffn_apply(cfg.ffn if cfg.ffn != "moe" else "geglu", p["ffn"],
                      norm_apply(cfg.norm, p["norm2"], x))
        return x + h, new_st, None

    raise ValueError(f"unknown block kind {kind}")
