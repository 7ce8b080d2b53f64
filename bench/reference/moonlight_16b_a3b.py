"""Plain reference of Moonlight-16B-A3B (DeepSeek-V3's layer,
``moonshotai/Moonlight-16B-A3B``'s config.json) as the program defines it.

Every layer: RMSNorm (eps 1e-5), multi-head latent attention in the
published, naive form (queries of 128 + 64 rope dims per head; a 512-wide
latent, RMS-normed, up-projected to every head's 128-wide key part and
value; one 64-wide rope key shared by the heads; each head's key and value
expanded, one causal pass over the whole sequence, scale 1/√192), RMSNorm,
then the first layer's dense SwiGLU (11264) or, in the other 26, the MoE:
sigmoid scores of an fp32 router, the top 6 of the scores plus a
per-expert bias (ties to the lower expert index), the chosen unbiased
scores renormalised and scaled by 2.446 as gates, each token through its
6 experts (SwiGLU 1408) one expert at a time, plus the shared experts (one
SwiGLU of 2 × 1408) on every token; a final RMSNorm and an untied head.
Departures from the published model, which the program makes and the
reference follows, are listed under ``assumed`` in the configuration's
file.  Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import attention, cross_entropy, mm, rnd, rope

__all__ = ["recipe", "forward", "train_loss", "model_flops"]


def _normal(fan_in: int) -> tuple:
    return ("normal", 1.0 / math.sqrt(fan_in))


def _swiglu_leaves(prefix: str, d: int, ff: int, out: float, experts: int = 0) -> list:
    lead = (experts,) if experts else ()
    return [(prefix + ".wi", lead + (d, ff), _normal(d)),
            (prefix + ".wg", lead + (d, ff), _normal(d)),
            (prefix + ".wo", lead + (ff, d), ("normal", out / math.sqrt(ff)))]


def recipe(sizes: dict) -> list:
    """The weights, group by group (a layer a group): the program's
    distributions, but the output projection of every residual branch
    (attention's, each SwiGLU's) scaled by 1/√(2 · n_layers), GPT-2's
    initialisation of residual layers; the router's bias from the seed at
    ``router_bias_scale``, large enough to change some selections.

    Unscaled, each branch adds as much as the stream holds, and a token
    whose top-6 a rounding flips moves by a quarter of its norm: the flips
    feed on each other from layer to layer, and no check on the logits can
    tell bf16 from fp8.  Scaled, a flip moves a token by a few per cent."""
    d, V = sizes["d_model"], sizes["padded_vocab"]
    out = 1.0 / math.sqrt(2 * sizes["n_layers"])
    H, hd, r, rope_dim = sizes["n_heads"], sizes["d_head"], sizes["kv_lora_rank"], sizes["qk_rope_dim"]
    E, f = sizes["n_experts"], sizes["d_ff_expert"]
    groups = [("embedding", [("embedding.table", (V, d), ("normal", 1.0))])]
    for i in range(sizes["n_layers"]):
        p = f"layers.{i}"
        leaves = [(p + ".norm1.scale", (d,), ("const", 1.0)),
                  (p + ".attn.wq.w", (d, H * (hd + rope_dim)), _normal(d)),
                  (p + ".attn.wkv_a.w", (d, r + rope_dim), _normal(d)),
                  (p + ".attn.kv_norm.scale", (r,), ("const", 1.0)),
                  (p + ".attn.wkv_b.w", (r, H * 2 * hd), _normal(r)),
                  (p + ".attn.wo.w", (H * hd, d), ("normal", out / math.sqrt(H * hd))),
                  (p + ".norm2.scale", (d,), ("const", 1.0))]
        if i < sizes["first_dense_layers"]:
            leaves += _swiglu_leaves(p + ".ffn", d, sizes["d_ff"], out)
        else:
            leaves += [(p + ".ffn.router", (d, E), _normal(d)),
                       (p + ".ffn.router_bias", (E,), ("normal", sizes["router_bias_scale"]))]
            leaves += _swiglu_leaves(p + ".ffn", d, f, out, E)
            leaves += _swiglu_leaves(p + ".ffn.shared", d, sizes["n_shared_experts"] * f, out)
        groups.append((p, leaves))
    groups.append(("final_norm", [("final_norm.scale", (d,), ("const", 1.0))]))
    groups.append(("lm_head", [("lm_head.w", (d, V), ("normal", d ** -0.5))]))
    return groups


def rmsnorm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale


def swiglu(x, wi, wg, wo, prec: str):
    return mm(F.silu(mm(x, wg, prec)) * mm(x, wi, prec), wo, prec)


def route(h, router, bias, top_k: int, scale: float) -> tuple:
    """(experts (T, K), gates (T, K)) of tokens h (T, d)."""
    s = torch.sigmoid(h @ router)
    experts = torch.sort(s + bias, dim=-1, descending=True, stable=True).indices[:, :top_k]
    gates = s.gather(1, experts)
    return experts, gates / gates.sum(dim=-1, keepdim=True) * scale


def moe(p: dict, h, sizes: dict, prec: str):
    """Each token through its experts, one expert at a time, plus the shared
    experts; h (T, d)."""
    E, K = sizes["n_experts"], sizes["top_k"]
    experts, gates = route(rnd(h, prec), p["ffn.router"], p["ffn.router_bias"], K,
                           sizes["routed_scale"])
    out = torch.zeros(h.shape[0], K, h.shape[1], dtype=h.dtype, device=h.device)
    for e in range(E):
        tok, slot = (experts == e).nonzero(as_tuple=True)
        if tok.numel():
            out[tok, slot] = swiglu(h[tok], p["ffn.wi"][e], p["ffn.wg"][e], p["ffn.wo"][e], prec)
    y = (out * gates[..., None]).sum(dim=1)
    return y + swiglu(h, p["ffn.shared.wi"], p["ffn.shared.wg"], p["ffn.shared.wo"], prec)


def mla(p: dict, h, sizes: dict, prec: str):
    """Latent attention, naive form: per-head keys and values expanded from
    the latent, one causal pass.  h (B, S, d)."""
    B, S, _ = h.shape
    H, hd, r = sizes["n_heads"], sizes["d_head"], sizes["kv_lora_rank"]
    theta, eps = sizes["rope_theta"], sizes["norm_eps"]
    q = mm(h, p["attn.wq.w"], prec).reshape(B, S, H, -1)
    q = torch.cat([q[..., :hd], rope(q[..., hd:], theta)], dim=-1)
    kv_a = mm(h, p["attn.wkv_a.w"], prec)
    c = rmsnorm(kv_a[..., :r], p["attn.kv_norm.scale"], eps)
    k_r = rope(kv_a[..., None, r:], theta)
    kv = mm(c, p["attn.wkv_b.w"], prec).reshape(B, S, H, 2 * hd)
    k = torch.cat([kv[..., :hd], k_r.expand(B, S, H, -1)], dim=-1)
    o = attention(q, k, kv[..., hd:], True, prec)
    return mm(o.reshape(B, S, H * hd), p["attn.wo.w"], prec)


def layer(p: dict, x, sizes: dict, prec: str, dense: bool):
    eps = sizes["norm_eps"]
    x = rnd(x + mla(p, rmsnorm(x, p["norm1.scale"], eps), sizes, prec), prec)
    h = rmsnorm(x, p["norm2.scale"], eps)
    if dense:
        y = swiglu(h, p["ffn.wi"], p["ffn.wg"], p["ffn.wo"], prec)
    else:
        y = moe(p, h.reshape(-1, h.shape[-1]), sizes, prec).reshape(h.shape)
    return rnd(x + y, prec)


def _inner(W, group: str) -> dict:
    n = len(group) + 1
    return {name[n:]: t for name, t in W(group).items()}


def forward(W, batch: dict, sizes: dict, prec: str = "fp32"):
    """Logits (B, T, padded vocab) float32 of ``batch["tokens"]``;
    ``W(group)`` gives a group's leaves by full name, drawn when asked."""
    x = rnd(W("embedding")["embedding.table"][batch["tokens"]], prec)
    for i in range(sizes["n_layers"]):
        x = layer(_inner(W, f"layers.{i}"), x, sizes, prec, i < sizes["first_dense_layers"])
    x = rmsnorm(x, W("final_norm")["final_norm.scale"], sizes["norm_eps"])
    return mm(x, W("lm_head")["lm_head.w"], prec)


def train_loss(W, batch: dict, sizes: dict, prec: str = "fp32"):
    """The mean next-token cross-entropy of ``forward``'s logits (no cell
    trains this configuration; the harness's references all carry it)."""
    return cross_entropy(forward(W, batch, sizes, prec), batch["labels"], sizes["vocab_size"])


def model_flops(sizes: dict, *, batch: int, tokens: int, frames: int = 0, train: bool = False,
                last_only: bool = False) -> float:
    """Model FLOPs of one forward pass (×3 with ``train``) over ``batch``
    sequences of ``tokens``: 2 FLOP per multiply-add of every weight matrix
    a token passes through (the attention's four projections, the dense
    layer's SwiGLU, in each MoE layer the router, its K experts and the
    shared experts), the attention products at the naive form's widths,
    2·(d_head + rope) + 2·d_head per (query, key) pair the causal mask
    keeps and head, and the LM head, for the last position only with
    ``last_only`` (a prefill); no pointwise op."""
    if frames:
        raise ValueError("this reference has no encoder")
    d, H, hd, r = sizes["d_model"], sizes["n_heads"], sizes["d_head"], sizes["kv_lora_rank"]
    rope_dim, E, K, f = sizes["qk_rope_dim"], sizes["n_experts"], sizes["top_k"], sizes["d_ff_expert"]
    L, dense = sizes["n_layers"], sizes["first_dense_layers"]
    attn_w = d * H * (hd + rope_dim) + d * (r + rope_dim) + r * H * 2 * hd + H * hd * d
    moe_w = d * E + K * 3 * d * f + 3 * d * sizes["n_shared_experts"] * f
    per_token = L * attn_w + dense * 3 * d * sizes["d_ff"] + (L - dense) * moe_w
    causal_pairs = tokens * (tokens + 1) / 2
    fl = batch * (tokens * 2 * per_token + L * H * causal_pairs * 2 * (2 * hd + rope_dim))
    fl += batch * (1 if last_only else tokens) * 2 * d * sizes["padded_vocab"]
    return 3.0 * fl if train else fl
