"""Plain reference of seamless-m4t-large-v2's text path as the program
defines it (arXiv:2308.11596; the program's ``models/model.py`` with
``blocks.py`` and ``attention.py``).

An encoder of bidirectional pre-LN transformer layers runs over frame
embeddings (B, F, d); a decoder of pre-LN layers runs causal self-attention,
cross-attention to the encoder's normed output and a GELU FFN; LayerNorm
eps 1e-6, biases on the FFN only, as many key/value heads as query heads.
Departures from the published model, which the program makes and the
reference follows, are listed under ``assumed`` in the configuration's
file: no speech frontend, rotary positions, GELU for ReLU, no attention
biases, no embedding scale, the head over the padded vocabulary.
"""
from __future__ import annotations

import math

from torch.utils.checkpoint import checkpoint

from .common import attention, cross_entropy, gelu, layernorm, mm, rnd, rope

__all__ = ["recipe", "forward", "train_loss", "model_flops"]


def _ln(prefix: str, d: int) -> list:
    return [(prefix + ".scale", (d,), ("const", 1.0)), (prefix + ".bias", (d,), ("const", 0.0))]


def _attn(prefix: str, d: int) -> list:
    s = ("normal", 1.0 / math.sqrt(d))
    return [(f"{prefix}.{w}.w", (d, d), s) for w in ("wq", "wk", "wv", "wo")]


def _ffn(prefix: str, d: int, ff: int) -> list:
    return [(prefix + ".wi", (d, ff), ("normal", 1.0 / math.sqrt(d))),
            (prefix + ".bi", (ff,), ("const", 0.0)),
            (prefix + ".wo", (ff, d), ("normal", 1.0 / math.sqrt(ff))),
            (prefix + ".bo", (d,), ("const", 0.0))]


def recipe(sizes: dict) -> list:
    """The weights, group by group: the program's distributions."""
    d, ff, V = sizes["d_model"], sizes["d_ff"], sizes["padded_vocab"]
    groups = [("embedding", [("embedding.table", (V, d), ("normal", 1.0))])]
    for i in range(sizes["enc_layers"]):
        p = f"encoder.{i}"
        groups.append((p, _ln(p + ".norm1", d) + _attn(p + ".attn", d) + _ln(p + ".norm2", d)
                       + _ffn(p + ".ffn", d, ff)))
    groups.append(("encoder_norm", _ln("encoder_norm", d)))
    for i in range(sizes["n_layers"]):
        p = f"layers.{i}"
        groups.append((p, _ln(p + ".norm1", d) + _attn(p + ".attn", d) + _ln(p + ".normx", d)
                       + _attn(p + ".xattn", d) + _ln(p + ".norm2", d) + _ffn(p + ".ffn", d, ff)))
    groups.append(("final_norm", _ln("final_norm", d)))
    groups.append(("lm_head", [("lm_head.w", (d, V), ("normal", d ** -0.5))]))
    return groups


def _heads(x, H):
    B, S, d = x.shape
    return x.reshape(B, S, H, d // H)


def _self_attn(p, pre, h, H, causal, prec):
    q = rope(_heads(mm(h, p[pre + ".wq.w"], prec), H))
    k = rope(_heads(mm(h, p[pre + ".wk.w"], prec), H))
    v = _heads(mm(h, p[pre + ".wv.w"], prec), H)
    o = attention(q, k, v, causal, prec)
    return mm(o.reshape(h.shape), p[pre + ".wo.w"], prec)


def _ffn_apply(p, h, prec):
    a = gelu(mm(h, p["ffn.wi"], prec) + p["ffn.bi"])
    return mm(a, p["ffn.wo"], prec) + p["ffn.bo"]


def enc_layer(p: dict, x, sizes: dict, prec: str):
    H = sizes["n_heads"]
    x = rnd(x + _self_attn(p, "attn", layernorm(x, p["norm1.scale"], p["norm1.bias"]), H, False,
                           prec), prec)
    return rnd(x + _ffn_apply(p, layernorm(x, p["norm2.scale"], p["norm2.bias"]), prec), prec)


def dec_layer(p: dict, x, ctx, sizes: dict, prec: str):
    H = sizes["n_heads"]
    x = rnd(x + _self_attn(p, "attn", layernorm(x, p["norm1.scale"], p["norm1.bias"]), H, True,
                           prec), prec)
    h = layernorm(x, p["normx.scale"], p["normx.bias"])
    q = _heads(mm(h, p["xattn.wq.w"], prec), H)
    k = _heads(mm(ctx, p["xattn.wk.w"], prec), H)
    v = _heads(mm(ctx, p["xattn.wv.w"], prec), H)
    o = attention(q, k, v, False, prec)
    x = rnd(x + mm(o.reshape(h.shape), p["xattn.wo.w"], prec), prec)
    return rnd(x + _ffn_apply(p, layernorm(x, p["norm2.scale"], p["norm2.bias"]), prec), prec)


def _inner(W, group: str) -> dict:
    n = len(group) + 1
    return {name[n:]: t for name, t in W(group).items()}


def forward(W, batch: dict, sizes: dict, prec: str = "fp32", remat: bool = False):
    """Logits (B, T, padded vocab) float32 of ``batch["tokens"]`` given
    ``batch["frames"]``; ``W(group)`` gives a group's leaves by full name.
    ``remat`` recomputes each layer in the backward pass."""
    def run(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)

    x = rnd(batch["frames"], prec)
    for i in range(sizes["enc_layers"]):
        x = run(enc_layer, _inner(W, f"encoder.{i}"), x, sizes, prec)
    en = W("encoder_norm")
    ctx = rnd(layernorm(x, en["encoder_norm.scale"], en["encoder_norm.bias"]), prec)
    x = rnd(W("embedding")["embedding.table"][batch["tokens"]], prec)
    for i in range(sizes["n_layers"]):
        x = run(dec_layer, _inner(W, f"layers.{i}"), x, ctx, sizes, prec)
    fn = W("final_norm")
    x = layernorm(x, fn["final_norm.scale"], fn["final_norm.bias"])
    return mm(x, W("lm_head")["lm_head.w"], prec)


def train_loss(W, batch: dict, sizes: dict, prec: str = "fp32"):
    logits = forward(W, batch, sizes, prec, remat=True)
    return cross_entropy(logits, batch["labels"], sizes["vocab_size"])


def model_flops(sizes: dict, *, batch: int, tokens: int, frames: int = 0, train: bool = False,
                last_only: bool = False) -> float:
    """Model FLOPs of one forward pass (×3 with ``train``: the backward's two
    products per forward product) over ``batch`` requests of ``frames``
    encoder frames and ``tokens`` decoder tokens: 2 FLOP per multiply-add of
    every weight matrix a position passes through (the encoder's attention
    and FFN; the decoder's self-attention, cross-attention query and output,
    FFN; the cross-attention's K/V projections over the frames), the
    attention products, 4·d per (query, key) pair the mask keeps, and the
    LM head, for the last position only with ``last_only`` (a prefill); no
    recompute, no pointwise op."""
    d, ff, V = sizes["d_model"], sizes["d_ff"], sizes["padded_vocab"]
    if sizes["n_kv_heads"] != sizes["n_heads"]:
        raise ValueError("this reference has as many key/value heads as query heads")
    L_enc, L_dec = sizes["enc_layers"], sizes["n_layers"]
    enc_w, dec_w = 4 * d * d + 2 * d * ff, 6 * d * d + 2 * d * ff
    causal_pairs = tokens * (tokens + 1) / 2
    f = batch * frames * L_enc * (2 * enc_w + 4 * frames * d)
    f += batch * frames * L_dec * 2 * (2 * d * d)
    f += batch * L_dec * (tokens * 2 * dec_w + 4 * causal_pairs * d + 4 * tokens * frames * d)
    f += batch * (1 if last_only else tokens) * 2 * d * V
    return 3.0 * f if train else f
