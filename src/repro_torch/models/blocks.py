"""Block kinds: init / state-init / apply, dispatched by kind string.

Port of the JAX package's ``models/blocks.py`` for the kinds ``attn``,
``rglru`` and ``rwkv``.  ``cross`` (cross-attention) and the MoE FFN wait
for a later slice and raise ``NotImplementedError``.  Every apply shares
the signature::

    apply_block(kind, cfg, p, x, st, *, q_pos, causal, exec_cfg) -> (x, new_state)

``st`` is the block's cache/state ({} for stateless full-sequence
attention).  The JAX package's MoE auxiliary loss has no counterpart until
the MoE FFN is ported.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .attention import attn_apply, attn_init, init_attn_cache
from .config import ExecConfig, ModelConfig
from .layers import Init, ffn_apply, ffn_init, norm_apply, norm_init
from .rglru import init_rglru_state, rglru_apply, rglru_init
from .rwkv6 import init_rwkv_state, rwkv_apply, rwkv_init

__all__ = ["init_block", "init_block_state", "apply_block", "BLOCK_KINDS"]

BLOCK_KINDS = ("attn", "rwkv", "rglru")


def _unported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"block kind {kind!r} waits for a later slice of the port (cross-attention / "
        "encoder-decoder and VLM models)"
    )


def init_block(ini: Init, kind: str, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    if kind == "attn":
        return {
            "norm1": norm_init(ini, cfg.norm, d),
            "attn": attn_init(ini, cfg),
            "norm2": norm_init(ini, cfg.norm, d),
            "ffn": ffn_init(ini, cfg.ffn, d, cfg.d_ff),
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
    if kind == "cross":
        raise _unported(kind)
    raise ValueError(f"unknown block kind {kind}")


def init_block_state(kind: str, cfg: ModelConfig, batch: int, max_len: int, mode: str, *,
                     window: int, device) -> dict:
    """State/cache for one block instance.  Train mode: only recurrent kinds
    carry state (zero-init); attention needs none."""
    if kind == "attn":
        if mode == "train":
            return {}
        return {"kv": init_attn_cache(cfg, batch, max_len, window=window, device=device)}
    if kind == "rwkv":
        return init_rwkv_state(cfg, batch, device)
    if kind == "rglru":
        return init_rglru_state(cfg, batch, device)
    if kind == "cross":
        raise _unported(kind)
    raise ValueError(f"unknown block kind {kind}")


def apply_block(
    kind: str,
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    st: Optional[dict],
    *,
    q_pos: torch.Tensor,
    causal: bool,
    exec_cfg: ExecConfig,
) -> Tuple[torch.Tensor, dict]:
    st = st or {}
    if kind == "attn":
        h, new_kv = attn_apply(
            cfg, p["attn"], norm_apply(cfg.norm, p["norm1"], x), q_pos=q_pos,
            cache=st.get("kv"), causal=causal, window=cfg.window, exec_cfg=exec_cfg,
        )
        x = x + h
        new_st = {"kv": new_kv} if new_kv is not None else {}
        h = ffn_apply(cfg.ffn, p["ffn"], norm_apply(cfg.norm, p["norm2"], x))
        return x + h, new_st

    if kind == "rwkv":
        return rwkv_apply(cfg, p, x, st, exec_cfg=exec_cfg)

    if kind == "rglru":
        h, new_st = rglru_apply(cfg, p["rec"], norm_apply(cfg.norm, p["norm1"], x), st,
                                exec_cfg=exec_cfg)
        x = x + h
        h = ffn_apply(cfg.ffn if cfg.ffn != "moe" else "geglu", p["ffn"],
                      norm_apply(cfg.norm, p["norm2"], x))
        return x + h, new_st

    if kind == "cross":
        raise _unported(kind)
    raise ValueError(f"unknown block kind {kind}")
