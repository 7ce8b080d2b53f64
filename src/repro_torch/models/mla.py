"""Multi-head latent attention (MLA, DeepSeek-V2/V3; Moonlight-16B-A3B).

Keys and values come from one latent a token: ``c = RMSNorm(x W_kv_a[:, :r])``
(rank ``r = kv_lora_rank``), up-projected per head by ``W_kv_b`` to a key
part of ``d_head`` and a value of ``d_head``; a query head is ``d_head +
qk_rope_dim`` wide, and its last ``qk_rope_dim`` values meet one rope key
``k_r = rope(x W_kv_a[:, r:])`` shared by every head.  Rope rotates halves
(the port's :func:`layers.rope_apply`, theta ``cfg.rope_theta``) on the rope
dims only; the softmax scale is 1/√(d_head + qk_rope_dim).

Cache layout (per layer): ``{"kv": (B, W, r + rope), "pos": (W,) int64}``:
the normed latent and the rotated rope key, ``r + rope`` values a token
(576 at Moonlight's widths, 1152 bytes in bf16) for all heads together,
where a per-head cache would hold ``H · (2 d_head + rope)`` (5120).  ``pos``
as in :mod:`attention` (-1 = empty; the batch advances in lockstep).

* Prefill / full sequence: per-head q (d_head + rope), k (d_head + rope) and
  v (d_head) and one causal pass through the flash kernel at (192, 128)
  under ``attn_impl="cuda"`` (the plain version on CPU tensors with
  ``interpret``; ``_sdpa`` otherwise; no (S, S) scores on the kernel
  path); prefill then writes the latent and the rope key into the cache,
  in place.
* Decode (one token, ``q_pos`` read on the device, the cache written in
  place, no host read: a step is captured in a CUDA graph): the absorbed
  form.  The key up-projection is folded into the query (``q_c = q_nope
  W_uk``, one (r)-wide vector a head), the scores are ``q_c · c + q_r ·
  k_r`` over the cache in fp32, the softmax-weighted latent is taken per
  head and the value up-projection applied after it (``o = (p c) W_uv``):
  no per-head K or V is ever formed.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.obs.trace import span

from .attention import NEG_INF, _bmm_fp32, _mask, _sdpa
from .config import ExecConfig, ModelConfig
from .layers import Init, linear_apply, linear_init, norm_apply, norm_init, rope_apply

__all__ = ["mla_init", "mla_apply", "init_mla_cache"]


def mla_init(ini: Init, cfg: ModelConfig) -> dict:
    d, H, hd, r, rope = cfg.d_model, cfg.n_heads, cfg.d_head, cfg.kv_lora_rank, cfg.qk_rope_dim
    return {
        "wq": linear_init(ini, d, H * (hd + rope)),
        "wkv_a": linear_init(ini, d, r + rope),
        "kv_norm": norm_init(ini, "rmsnorm", r),
        "wkv_b": linear_init(ini, r, H * 2 * hd),
        "wo": linear_init(ini, H * hd, d),
    }


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None) -> dict:
    dt = getattr(torch, cfg.compute_dtype)
    return {
        "kv": torch.zeros((batch, max_len, cfg.kv_lora_rank + cfg.qk_rope_dim), dtype=dt,
                          device=device),
        "pos": torch.full((max_len,), -1, dtype=torch.int64, device=device),
    }


def _latent(cfg: ModelConfig, p: dict, x, q_pos):
    """The queries (B,S,H,d_head + rope), with the rope part rotated, and
    the cache entries (B,S,r + rope): the normed latent and the rotated
    rope key."""
    B, S, _ = x.shape
    H, hd, r = cfg.n_heads, cfg.d_head, cfg.kv_lora_rank
    q = linear_apply(p["wq"], x).view(B, S, H, -1)
    q = torch.cat([q[..., :hd], rope_apply(q[..., hd:], q_pos, cfg.rope_theta)], dim=-1)
    kv_a = linear_apply(p["wkv_a"], x)
    c = norm_apply("rmsnorm", p["kv_norm"], kv_a[..., :r], eps=cfg.norm_eps)
    k_r = rope_apply(kv_a[..., None, r:], q_pos, cfg.rope_theta)[:, :, 0]
    return q, torch.cat([c, k_r], dim=-1)


def _write(cache: dict, entries, q_pos) -> None:
    """Entries (B,S,r + rope) into the slots ``q_pos`` (no window: slot =
    position), in place."""
    cache["kv"][:, q_pos] = entries
    cache["pos"][q_pos] = q_pos.to(cache["pos"].dtype)


def _full(cfg: ModelConfig, p: dict, q, entries, q_pos, causal: bool, exec_cfg: ExecConfig):
    """Attention over the sequence itself in the naive form: per-head keys
    (B,S,H,d_head + rope) and values (B,S,H,d_head) up-projected from the
    latent, one causal pass -> (B,S,H,d_head)."""
    B, S, H, _ = q.shape
    hd, r = cfg.d_head, cfg.kv_lora_rank
    kv = linear_apply(p["wkv_b"], entries[..., :r]).view(B, S, H, 2 * hd)
    k = torch.cat([kv[..., :hd], entries[:, :, None, r:].expand(B, S, H, -1)], dim=-1)
    k, v = k.transpose(1, 2), kv[..., hd:].transpose(1, 2)  # (B,H,S,·) views
    if exec_cfg.attn_impl == "cuda":
        return _flash(q, k, v, causal, exec_cfg.interpret)
    return _sdpa_wide(q, k, v, _mask(q_pos, q_pos, causal=causal, window=0))


def _flash(q, k, v, causal: bool, interpret: bool):
    """The flash kernel at these widths (its tensor-core design: tiles of 64
    or 128 rows): a sequence that is not a multiple of 64 is padded at its
    end with zeros, keys and queries alike, and the padded queries' rows
    are dropped; under the causal mask no real query sees a padded key.
    ``ExecConfig.block_q`` / ``block_kv`` tune the equal-width calls and
    are not read here."""
    S = q.shape[1]
    pad = -S % 64
    if pad:
        if not causal:
            raise ValueError("mla: a full non-causal pass needs a multiple of 64 tokens")
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        k, v = F.pad(k, (0, 0, 0, pad)), F.pad(v, (0, 0, 0, pad))
    block = 128 if (S + pad) % 128 == 0 else 64
    out = kops.flash_attention(q, k, v, causal=causal, block_q=block, block_kv=block,
                               interpret=interpret)
    return out[:, :S] if pad else out


def _sdpa_wide(q, k, v, mask):
    """``attention._sdpa`` with value heads narrower than the keys: the
    scores at the keys' width, the output at the values'."""
    hd_v = v.shape[-1]
    pad = torch.zeros(v.shape[:-1] + (q.shape[-1] - hd_v,), dtype=v.dtype, device=v.device)
    return _sdpa(q, k, torch.cat([v, pad], dim=-1), mask)[..., :hd_v]


def _absorbed(cfg: ModelConfig, p: dict, q, cache: dict, q_pos):
    """One query token (B,1,H,d_head + rope) over the cache in the absorbed
    form -> (B,1,H,d_head)."""
    B, _, H, _ = q.shape
    hd, r = cfg.d_head, cfg.kv_lora_rank
    dt = q.dtype
    w = p["wkv_b"]["w"].to(dt).view(r, H, 2 * hd)
    w_uk = w[:, :, :hd].permute(1, 2, 0)  # (H, hd, r)
    w_uv = w[:, :, hd:].transpose(0, 1)  # (H, r, hd)
    q_c = torch.bmm(q[:, 0, :, :hd].transpose(0, 1), w_uk).transpose(0, 1)  # (B, H, r)
    qa = torch.cat([q_c, q[:, 0, :, hd:]], dim=-1)  # (B, H, r + rope)
    kv = cache["kv"]
    if dt == torch.bfloat16 and kv.device.type != "cpu":
        scores = _bmm_fp32(qa, kv.transpose(1, 2))
    else:
        scores = torch.bmm(qa.float(), kv.float().transpose(1, 2))  # (B, H, W)
    scores.mul_(1.0 / math.sqrt(hd + cfg.qk_rope_dim))
    valid = _mask(q_pos, cache["pos"], causal=True, window=0)  # (1, W)
    scores.masked_fill_(~valid[None], NEG_INF)
    prob = torch.softmax(scores, dim=-1).to(dt)
    o_c = torch.bmm(prob, kv[..., :r])  # (B, H, r)
    return torch.bmm(o_c.transpose(0, 1), w_uv).transpose(0, 1)[:, None]  # (B,1,H,hd)


def mla_apply(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    *,
    q_pos: torch.Tensor,
    cache: Optional[dict] = None,
    causal: bool = True,
    exec_cfg: ExecConfig = ExecConfig(),
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Latent self-attention.  Modes as :func:`attention.attn_apply`'s:
    ``cache=None`` a full sequence; a cache and Sq > 1 prefill (fills it);
    a cache and Sq = 1 one decode step (absorbed form)."""
    B, Sq, _ = x.shape
    if cache is not None and Sq == 1:
        q, entries = _latent(cfg, p, x, q_pos)
        _write(cache, entries, q_pos)
        out = _absorbed(cfg, p, q, cache, q_pos)
        return linear_apply(p["wo"], out.reshape(B, Sq, -1)), cache
    with span("mla.prefill", "model"):
        q, entries = _latent(cfg, p, x, q_pos)
        out = _full(cfg, p, q, entries, q_pos, causal, exec_cfg)
        if cache is not None:
            _write(cache, entries, q_pos)
        return linear_apply(p["wo"], out.reshape(B, Sq, -1)), cache
