"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Port of the JAX package's ``models/rglru.py``.  Recurrence (elementwise,
per channel):

    r_t = sigmoid(W_a x_t + b_a)            # recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            # input gate
    a_t = exp(c * r_t * log(sigmoid(Λ)))    # data-dependent decay, c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t²) (i_t ⊙ x_t)

The block: two branches from the pre-norm input — (a) linear→GeLU and
(b) linear→causal depthwise conv1d(width 4)→RG-LRU — merged
multiplicatively and projected back.  Under ``attn_impl="cuda"`` a sequence
whose length ``rec_chunk`` divides runs the CUDA scan kernel
(``kernels.ops.lru_scan``); otherwise the plain path is :func:`lru_scan`, a
doubling scan in ⌈log₂ T⌉ steps (PyTorch has no ``associative_scan``).
Decode (T = 1) is a single elementwise step.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.parallel.api import matmul

from .config import ExecConfig, ModelConfig
from .layers import Init, gelu

__all__ = ["rglru_init", "rglru_apply", "init_rglru_state", "lru_scan"]

_C = 8.0  # Griffin's fixed decay sharpness


def rglru_init(ini: Init, cfg: ModelConfig) -> dict:
    d, dr = cfg.d_model, cfg.rnn_width
    s = 1.0 / math.sqrt(d)
    # Λ so that a ∈ [0.9, 0.999] at r = 1 (Griffin appendix), as in the JAX init
    u = ini.uniform((dr,), 0.9**2, 0.999**2)
    lam = torch.log(torch.sqrt(u) / (1.0 - torch.sqrt(u)))
    return {
        "wx_gelu": ini.nrm((d, dr), s),  # branch (a)
        "wx_rec": ini.nrm((d, dr), s),  # branch (b)
        "conv_w": ini.nrm((cfg.conv_width, dr), 0.1),
        "conv_b": ini.zeros((dr,)),
        "wa": ini.nrm((dr, dr), 1.0 / math.sqrt(dr)),
        "ba": ini.zeros((dr,)),
        "wi": ini.nrm((dr, dr), 1.0 / math.sqrt(dr)),
        "bi": ini.zeros((dr,)),
        "lam": lam,
        "wo": ini.nrm((dr, d), 1.0 / math.sqrt(dr)),
    }


def init_rglru_state(cfg: ModelConfig, batch: int, device) -> dict:
    dr = cfg.rnn_width
    return {
        "h": torch.zeros((batch, dr), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, dr), dtype=getattr(torch, cfg.compute_dtype),
                            device=device),
    }


# ----------------------------------------------------------------- recurrence
def lru_scan(a, b, h0):
    """Doubling (Hillis–Steele) scan of the same first-order recurrence, in
    ⌈log₂ T⌉ steps: after the step with offset o, position t holds the
    composition of steps t−2o+1..t.  h0 is folded into the first step."""
    b = b.clone()
    b[:, 0] = b[:, 0] + a[:, 0] * h0
    a = a.clone()
    T = a.shape[1]
    off = 1
    while off < T:
        # compose (a, b)[t-off] then (a, b)[t]: a' = a_t a_{t-o}, b' = a_t b_{t-o} + b_t
        b_new = a[:, off:] * b[:, :-off] + b[:, off:]
        a_new = a[:, off:] * a[:, :-off]
        b = torch.cat([b[:, :off], b_new], dim=1)
        a = torch.cat([a[:, :off], a_new], dim=1)
        off *= 2
    return b, b[:, -1]


# ----------------------------------------------------------------- the block
def _causal_conv1d(x, w, b, state):
    """Depthwise causal conv. x: (B,T,D), w: (W,D); state: (B,W-1,D) history."""
    W = w.shape[0]
    xp = torch.cat([state.to(x.dtype), x], dim=1)  # (B, T+W-1, D)
    T = x.shape[1]
    y = xp[:, 0:T] * w[0].to(x.dtype)
    for i in range(1, W):
        y = y + xp[:, i:i + T] * w[i].to(x.dtype)
    return y + b.to(x.dtype), xp[:, -(W - 1):]


def rglru_apply(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    state: dict,
    *,
    exec_cfg: ExecConfig = ExecConfig(),
) -> Tuple[torch.Tensor, dict]:
    """Temporal-mix half of the Griffin block (residual handled by caller).
    x: (B,T,D) pre-normed. Returns (out (B,T,D), new_state)."""
    dt = x.dtype
    ga = gelu(matmul(x, p["wx_gelu"].to(dt)))  # branch (a)
    xb = matmul(x, p["wx_rec"].to(dt))  # branch (b)
    xb, new_conv = _causal_conv1d(xb, p["conv_w"], p["conv_b"], state["conv"])

    # RG-LRU gates (fp32 for the recurrence)
    xf = xb.float()
    r = torch.sigmoid(matmul(xf, p["wa"].float()) + p["ba"])
    i = torch.sigmoid(matmul(xf, p["wi"].float()) + p["bi"])
    log_a_base = -F.softplus(-p["lam"].float())  # log sigmoid(Λ)  (<= 0)
    log_a = _C * r * log_a_base[None, None, :]
    a = torch.exp(log_a)
    gated = i * xf
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * gated

    T = x.shape[1]
    if T == 1:
        h = a[:, 0] * state["h"] + b[:, 0]
        hs, hT = h[:, None], h
    elif exec_cfg.attn_impl == "cuda" and T % max(exec_cfg.rec_chunk, 1) == 0:
        hs, hT = kops.lru_scan(a, b, state["h"], chunk=exec_cfg.rec_chunk,
                               interpret=exec_cfg.interpret)
    else:
        hs, hT = lru_scan(a, b, state["h"])

    out = matmul(hs.to(dt) * ga, p["wo"].to(dt))
    return out, {"h": hT, "conv": new_conv}
