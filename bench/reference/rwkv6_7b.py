"""Plain reference of the RWKV-6 "Finch" language model as the program
defines it (arXiv:2404.05892; the program's ``models/rwkv6.py``).

Per layer: a time mix (LayerNorm, data-dependent token shift through five
low-rank mixes, r/k/v/g projections, the decay w_t = exp(-exp(w0 +
tanh(x W1) W2)), the WKV recurrence with bonus u, a per-head group norm,
the SiLU gate, the output projection, a residual) and a channel mix
(LayerNorm, token shift, squared ReLU, sigmoid receptance, a residual).
The WKV recurrence per head, state S (hd × hd):

    y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ),   S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

is computed exactly in float32 in chunks of 16 tokens with log-space decay
differences (every exponent ≤ 0).  The low-rank widths of the token-shift
mixes and of the decay are the configuration's ``mix_lora_rank`` and
``decay_lora_rank``.  Departures from the published model, which the
program makes and the reference follows, are listed under ``assumed`` in
the configuration's file.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import cross_entropy, layernorm, mm, rnd

__all__ = ["recipe", "forward", "train_loss", "model_flops"]

_CHUNK = 16
_GN_EPS = 64e-5


def recipe(sizes: dict) -> list:
    """The weights, group by group: the program's distributions (scaled
    normals clamped to ±2 standard deviations, constants)."""
    d, ff, V = sizes["d_model"], sizes["d_ff"], sizes["padded_vocab"]
    H, hd = sizes["n_heads"], sizes["d_head"]
    rm, rw = sizes["mix_lora_rank"], sizes["decay_lora_rank"]
    s = 1.0 / math.sqrt(d)
    one, zero = ("const", 1.0), ("const", 0.0)
    groups = [("embedding", [("embedding.table", (V, d), ("normal", 1.0))])]
    for i in range(sizes["n_layers"]):
        p = f"layers.{i}."
        groups.append((f"layers.{i}", [
            (p + "ln1.scale", (d,), one), (p + "ln1.bias", (d,), zero),
            (p + "ln2.scale", (d,), one), (p + "ln2.bias", (d,), zero),
            (p + "tm.mu_x", (d,), zero), (p + "tm.mu_5", (5, d), zero),
            (p + "tm.mix_w1", (d, 5 * rm), ("normal", s)),
            (p + "tm.mix_w2", (5, rm, d), ("normal", 0.02)),
            (p + "tm.w0", (d,), ("const", -1.0)),
            (p + "tm.w1", (d, rw), ("normal", s)),
            (p + "tm.w2", (rw, d), ("normal", 0.02)),
            (p + "tm.u", (H, hd), ("normal", 0.5)),
            (p + "tm.wr", (d, d), ("normal", s)), (p + "tm.wk", (d, d), ("normal", s)),
            (p + "tm.wv", (d, d), ("normal", s)), (p + "tm.wg", (d, d), ("normal", s)),
            (p + "tm.wo", (d, d), ("normal", s)),
            (p + "tm.ln_x.scale", (d,), one), (p + "tm.ln_x.bias", (d,), zero),
            (p + "cm.mu_k", (d,), zero), (p + "cm.mu_r", (d,), zero),
            (p + "cm.wk", (d, ff), ("normal", s)),
            (p + "cm.wv", (ff, d), ("normal", 1.0 / math.sqrt(ff))),
            (p + "cm.wr", (d, d), ("normal", s)),
        ]))
    groups.append(("final_norm", [("final_norm.scale", (d,), one),
                                  ("final_norm.bias", (d,), zero)]))
    groups.append(("lm_head", [("lm_head.w", (d, V), ("normal", d ** -0.5))]))
    return groups


def wkv(r, k, v, lw, u):
    """Exact WKV over (B, T, H, hd) float32 inputs from a zero state."""
    B, T, H, hd = r.shape
    L = _CHUNK
    pad = (-T) % L
    if pad:
        r, k, v, lw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, lw))
    nc = (T + pad) // L
    rc, kc, vc, lc = (t.reshape(B, nc, L, H, hd).permute(1, 0, 3, 2, 4) for t in (r, k, v, lw))
    c = torch.cumsum(lc, dim=-2)  # (nc, B, H, L, hd), inclusive
    c_prev = c - lc  # decay up to t - 1
    expo = c_prev[..., :, None, :] - c[..., None, :, :]  # (nc, B, H, t, s, hd)
    below = torch.ones(L, L, dtype=torch.bool, device=r.device).tril(-1)[..., None]
    decay = torch.where(below, torch.exp(expo.clamp(max=0.0)), torch.zeros((), device=r.device))
    scores = torch.einsum("nbhtsi,nbhti,nbhsi->nbhts", decay, rc, kc)
    bonus = torch.einsum("nbhti,hi,nbhti->nbht", rc, u, kc)
    scores = scores + torch.diag_embed(bonus)
    y_in = scores @ vc
    q_dec = rc * torch.exp(c_prev)
    k_end = kc * torch.exp(c[..., -1:, :] - c)
    S = torch.zeros(B, H, hd, hd, dtype=torch.float32, device=r.device)
    ys = []
    for n in range(nc):
        ys.append(y_in[n] + q_dec[n] @ S)
        S = torch.exp(c[n, :, :, -1, :])[..., None] * S + k_end[n].transpose(-1, -2) @ vc[n]
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, nc * L, H, hd)
    return y[:, :T]


def _shift(x):
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def layer(p: dict, x, sizes: dict, prec: str):
    """One block over a whole sequence from zero state; ``p`` by names
    inside the layer (``tm.wr``...)."""
    B, T, d = x.shape
    H, hd = sizes["n_heads"], sizes["d_head"]
    xn = layernorm(x, p["ln1.scale"], p["ln1.bias"])
    dx = _shift(xn) - xn
    xxx = xn + dx * p["tm.mu_x"]
    z = torch.tanh(mm(xxx, p["tm.mix_w1"], prec)).reshape(B, T, 5, sizes["mix_lora_rank"])
    deltas = torch.einsum("btfr,frd->btfd", rnd(z, prec), rnd(p["tm.mix_w2"], prec))
    mixed = xn[:, :, None] + dx[:, :, None] * (p["tm.mu_5"] + deltas)
    xw, xk, xv, xr, xg = mixed.unbind(2)
    r = rnd(mm(xr, p["tm.wr"], prec), prec).reshape(B, T, H, hd)
    k = rnd(mm(xk, p["tm.wk"], prec), prec).reshape(B, T, H, hd)
    v = rnd(mm(xv, p["tm.wv"], prec), prec).reshape(B, T, H, hd)
    g = mm(xg, p["tm.wg"], prec)
    wlog = p["tm.w0"] + torch.tanh(xw @ p["tm.w1"]) @ p["tm.w2"]
    lw = (-torch.exp(wlog)).reshape(B, T, H, hd)
    y = wkv(r, k, v, lw, p["tm.u"])
    mu = y.mean(dim=-1, keepdim=True)
    var = (y - mu).square().mean(dim=-1, keepdim=True)
    yn = ((y - mu) * torch.rsqrt(var + _GN_EPS)).reshape(B, T, d)
    yn = yn * p["tm.ln_x.scale"] + p["tm.ln_x.bias"]
    x = rnd(x + mm(yn * F.silu(g), p["tm.wo"], prec), prec)
    xn2 = layernorm(x, p["ln2.scale"], p["ln2.bias"])
    dx2 = _shift(xn2) - xn2
    kk = torch.relu(mm(xn2 + dx2 * p["cm.mu_k"], p["cm.wk"], prec)).square()
    gate = torch.sigmoid(mm(xn2 + dx2 * p["cm.mu_r"], p["cm.wr"], prec))
    return rnd(x + gate * mm(kk, p["cm.wv"], prec), prec)


def _inner(W, group: str) -> dict:
    n = len(group) + 1
    return {name[n:]: t for name, t in W(group).items()}


def forward(W, batch: dict, sizes: dict, prec: str = "fp32", remat: bool = False):
    """Logits (B, T, padded vocab) float32 of ``batch["tokens"]``; ``W(group)``
    gives a group's leaves by full name.  ``remat`` recomputes each layer
    in the backward pass (a training reference that fits the card)."""
    x = rnd(W("embedding")["embedding.table"][batch["tokens"]], prec)
    for i in range(sizes["n_layers"]):
        p = _inner(W, f"layers.{i}")
        if remat:
            x = checkpoint(layer, p, x, sizes, prec, use_reentrant=False)
        else:
            x = layer(p, x, sizes, prec)
    fn = W("final_norm")
    x = layernorm(x, fn["final_norm.scale"], fn["final_norm.bias"])
    return mm(x, W("lm_head")["lm_head.w"], prec)


def train_loss(W, batch: dict, sizes: dict, prec: str = "fp32"):
    logits = forward(W, batch, sizes, prec, remat=True)
    return cross_entropy(logits, batch["labels"], sizes["vocab_size"])


def model_flops(sizes: dict, *, batch: int, tokens: int, frames: int = 0, train: bool = False,
                last_only: bool = False) -> float:
    """Model FLOPs of one forward pass (×3 with ``train``: the backward's two
    products per forward product) over ``batch`` sequences of ``tokens``:
    2 FLOP per multiply-add of every weight matrix a token passes through
    (the time mix's five projections, its low-rank mixes and decay, the
    channel mix), the WKV scan's 4·hd² per token and head (the state's
    update and its read-out), and the LM head, for the last position only
    with ``last_only`` (a prefill); no recompute, no pointwise op."""
    if frames:
        raise ValueError("RWKV-6 has no encoder frames")
    d, ff, V = sizes["d_model"], sizes["d_ff"], sizes["padded_vocab"]
    H, hd = sizes["n_heads"], sizes["d_head"]
    rm, rw = sizes["mix_lora_rank"], sizes["decay_lora_rank"]
    weights = 5 * d * d + d * 5 * rm + 5 * rm * d + 2 * d * rw + 2 * d * ff + d * d
    f = batch * tokens * sizes["n_layers"] * (2 * weights + 4 * H * hd * hd)
    f += batch * (1 if last_only else tokens) * 2 * d * V
    return 3.0 * f if train else f
