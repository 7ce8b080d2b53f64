"""RWKV-6 "Finch" block: data-dependent-decay linear recurrence (arXiv:2404.05892).

Port of the JAX package's ``models/rwkv6.py``.  Per head with state
S ∈ R^{hd×hd}, per-channel data-dependent decay w_t ∈ (0,1):

    y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

Sequence paths: under ``attn_impl="cuda"`` the CUDA scan kernel
(``kernels.ops.rwkv_scan``, the exact per-token recurrence); otherwise
:func:`wkv_chunked`, the exact chunked form with log-space decay
differences (all exponents ≤ 0).  Any length that ``rec_chunk`` does not
divide runs :func:`wkv_scan_ref`, the per-token oracle.  Decode (T = 1)
under ``attn_impl="cuda"`` on plain tensors under ``no_grad`` (as
``Model.decode_step`` runs it) takes
:func:`_decode_step`: the layer's pointwise work as the six kernels of
``kernels/rwkv_decode.py`` between its weight products; otherwise the
chain below with the per-token oracle, as the JAX package does.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels import ops as kops
from repro_torch.kernels import rwkv_decode as rd
from repro_torch.kernels.ref import rwkv_scan_ref
from repro_torch.parallel.api import einsum, matmul, split_dim

from .config import ExecConfig, ModelConfig
from .layers import Init, norm_apply

__all__ = ["rwkv_init", "rwkv_apply", "init_rwkv_state", "wkv_scan_ref", "wkv_chunked"]

_LORA_W = 64  # decay LoRA rank (rwkv6 default for 7B)
_LORA_MIX = 32  # ddlerp LoRA rank

#: exact per-token scan (oracle + decode path)
wkv_scan_ref = rwkv_scan_ref


def rwkv_init(ini: Init, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    H, hd = cfg.n_heads, cfg.d_head
    s = 1.0 / math.sqrt(d)

    def ln():
        return {"scale": ini.ones((d,)), "bias": ini.zeros((d,))}

    return {
        "ln1": ln(),
        "ln2": ln(),
        "tm": {
            "mu_x": ini.zeros((d,)),
            "mu_5": ini.zeros((5, d)),  # w,k,v,r,g ddlerp biases
            "mix_w1": ini.nrm((d, 5 * _LORA_MIX), s),
            "mix_w2": ini.nrm((5, _LORA_MIX, d), 0.02),
            "w0": ini.full((d,), -1.0),  # decay bias (log-log space)
            "w1": ini.nrm((d, _LORA_W), s),
            "w2": ini.nrm((_LORA_W, d), 0.02),
            "u": ini.nrm((H, hd), 0.5),  # bonus ("time_faaaa")
            "wr": ini.nrm((d, d), s),
            "wk": ini.nrm((d, d), s),
            "wv": ini.nrm((d, d), s),
            "wg": ini.nrm((d, d), s),
            "wo": ini.nrm((d, d), s),
            "ln_x": ln(),
        },
        "cm": {
            "mu_k": ini.zeros((d,)),
            "mu_r": ini.zeros((d,)),
            "wk": ini.nrm((d, cfg.d_ff), s),
            "wv": ini.nrm((cfg.d_ff, d), 1.0 / math.sqrt(cfg.d_ff)),
            "wr": ini.nrm((d, d), s),
        },
    }


def init_rwkv_state(cfg: ModelConfig, batch: int, device) -> dict:
    H, hd = cfg.n_heads, cfg.d_head
    dt = getattr(torch, cfg.compute_dtype)
    return {
        "shift_tm": torch.zeros((batch, cfg.d_model), dtype=dt, device=device),
        "shift_cm": torch.zeros((batch, cfg.d_model), dtype=dt, device=device),
        "wkv": torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
    }


# ----------------------------------------------------------------- recurrence
def wkv_chunked(r, k, v, lw, u, s0, chunk: int = 32):
    """Exact chunked form: a loop over T/L chunks, products within a chunk.

    With c = within-chunk cumsum of lw (c <= 0, decreasing),
      inter:  y += (r_t ⊙ e^{c_{t-1}}) · S_chunk          (exponent <= 0)
      intra:  score_{ts} = Σ_i r_t k_s e^{c_{t-1}-c_s}, s<t  (exponent <= 0)
      state:  S' = e^{c_L} ⊙ S + Σ_s (k_s e^{c_L - c_s}) v_sᵀ (exponent <= 0)
    """
    B, T, H, hd = r.shape
    L = min(chunk, T)
    if T % L:
        raise ValueError(f"T={T} not divisible by rec_chunk={L}")
    nc = T // L
    rf, kf, vf, lwf = (
        x.float().reshape(B, nc, L, H, hd).permute(1, 0, 3, 2, 4)
        for x in (r, k, v, lw)
    )  # (nc, B, H, L, hd)

    c = torch.cumsum(lwf, dim=-2)
    q_dec = rf * torch.exp(c - lwf)  # r_t e^{c_{t-1}}
    k_end = kf * torch.exp(c[..., -1:, :] - c)  # k_s e^{c_L - c_s}
    expo = (c - lwf)[..., :, None, :] - c[..., None, :, :]  # (nc,B,H,L,L,hd)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device), diagonal=-1)
    ew = torch.where(tri[..., None], torch.exp(torch.clamp(expo, max=0.0)), torch.zeros((), device=r.device))
    scores = einsum("nbhtsi,nbhti,nbhsi->nbhts", ew, rf, kf)
    diag = einsum("nbhti,hi,nbhti->nbht", rf, u.float(), kf)
    ii = torch.arange(L, device=r.device)
    scores[..., ii, ii] += diag
    y_intra = einsum("nbhts,nbhsv->nbhtv", scores, vf)

    S, ys = s0.float(), []
    for n in range(nc):
        ys.append(y_intra[n] + einsum("bhti,bhiv->bhtv", q_dec[n], S))
        S = torch.exp(c[n, ..., -1, :])[..., None] * S + einsum(
            "bhsi,bhsv->bhiv", k_end[n], vf[n])
    y = torch.stack(ys, dim=0).permute(1, 0, 3, 2, 4).reshape(B, T, H, hd)
    return y.to(r.dtype), S


def _per_shard(fn, r, k, v, lw, u, s0, **kw):
    """``fn(r, k, v, lw, u, s0)`` (a WKV recurrence).  On DTensors (the
    dry run's) it runs on each rank's shard: the recurrence is independent
    per sequence and head, so r/k/v/lw keep their batch and head shards
    (the rest gathered), ``u`` and the state follow the heads, and the
    results are the DTensors of the local ones."""
    if not isinstance(r, DTensor):
        return fn(r, k, v, lw, u, s0, **kw)
    mesh = r.device_mesh
    seq = [pl if isinstance(pl, Shard) and pl.dim in (0, 2) else Replicate() for pl in r.placements]
    heads = [Shard(0) if isinstance(pl, Shard) and pl.dim == 2 else Replicate() for pl in seq]
    state = [Shard(1) if isinstance(pl, Shard) and pl.dim == 2 else pl for pl in seq]
    batch = [isinstance(pl, Shard) and pl.dim == 0 for pl in seq]

    def local(t, placements, grads=None):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        return t.redistribute(mesh, placements).to_local(grad_placements=grads)

    u_grads = [Partial() if b else pl for b, pl in zip(batch, heads)]  # summed over sequences
    y, sT = fn(*(local(t, seq) for t in (r, k, v, lw)), local(u, heads, u_grads),
               local(s0, state), **kw)
    return (DTensor.from_local(y, mesh, seq, run_check=False),
            DTensor.from_local(sT, mesh, state, run_check=False))


# ----------------------------------------------------------------- the block
def _ddlerp(x, x_prev, tm):
    """Data-dependent token-shift interpolation (Finch §3)."""
    dx = x_prev - x
    xxx = x + dx * tm["mu_x"].to(x.dtype)
    z = torch.tanh(matmul(xxx, tm["mix_w1"].to(x.dtype)))  # (B,T,5*R)
    B, T = x.shape[:2]
    z = split_dim(z, -1, 5)  # (B,T,5,R)
    deltas = einsum("btfr,frd->btfd", z, tm["mix_w2"].to(x.dtype))
    mixed = x[:, :, None, :] + dx[:, :, None, :] * (tm["mu_5"].to(x.dtype)[None, None] + deltas)
    return tuple(mixed[:, :, i] for i in range(5))  # xw, xk, xv, xr, xg


def _decode_step(p: dict, x: torch.Tensor, state: dict, interpret: bool):
    """One token (x: (B,1,D)) through the block: six fused kernels
    (``kernels/rwkv_decode.py``) around the weight products the chain runs,
    same weights, same library calls.  Weights are cast as the chain casts
    them (a no-op for the served model's)."""
    B, _, D = x.shape
    dt = x.dtype
    tm, cm = p["tm"], p["cm"]
    x = x.reshape(B, D)
    shift_tm = state["shift_tm"]
    xn, xxx = rd.shift_mix(x, shift_tm, p["ln1"]["scale"].float(), p["ln1"]["bias"].float(),
                           tm["mu_x"].to(dt), interpret=interpret)
    xw, mixed = rd.lora_mix(xxx @ tm["mix_w1"].to(dt), xn, shift_tm, tm["mix_w2"].to(dt),
                            tm["mu_5"].to(dt), interpret=interpret)
    xk, xv, xr, xg = mixed.unbind(0)
    gated, wkv = rd.wkv_step(xr @ tm["wr"].to(dt), xk @ tm["wk"].to(dt), xv @ tm["wv"].to(dt),
                             xg @ tm["wg"].to(dt), xw @ tm["w1"].float(), tm["w0"].float(),
                             tm["w2"].float(), tm["u"].float(), state["wkv"],
                             tm["ln_x"]["scale"].to(dt), tm["ln_x"]["bias"].to(dt),
                             interpret=interpret)
    x1, xn2, xkr = rd.cm_mix(x, gated @ tm["wo"].to(dt), state["shift_cm"],
                             p["ln2"]["scale"].float(), p["ln2"]["bias"].float(), cm["mu_k"].to(dt),
                             cm["mu_r"].to(dt), interpret=interpret)
    kk = rd.relu_sq(xkr[0] @ cm["wk"].to(dt), interpret=interpret)
    out = rd.cm_out(x1, xkr[1] @ cm["wr"].to(dt), kk @ cm["wv"].to(dt), interpret=interpret)
    return out[:, None], {"shift_tm": xn, "wkv": wkv, "shift_cm": xn2}


def rwkv_apply(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    state: dict,
    *,
    exec_cfg: ExecConfig = ExecConfig(),
) -> Tuple[torch.Tensor, dict]:
    """Full block: time-mix (+residual) then channel-mix (+residual).
    x: (B,T,D).  ``state`` carries shift tokens + wkv state across calls."""
    B, T, D = x.shape
    # the fused kernels take no gradient, and the dry run's DTensors come as
    # a whole set: both keep the chain
    if (T == 1 and exec_cfg.attn_impl == "cuda" and not torch.is_grad_enabled()
            and not isinstance(x, DTensor)):
        return _decode_step(p, x, state, exec_cfg.interpret)
    H, hd = cfg.n_heads, cfg.d_head
    dt = x.dtype
    tm, cm = p["tm"], p["cm"]

    # ---- time mix (pre-LN stream carries the token shift) -------------------
    xn = norm_apply("layernorm", p["ln1"], x)
    xs = torch.cat([state["shift_tm"][:, None, :], xn[:, :-1]], dim=1)
    xw, xk, xv, xr, xg = _ddlerp(xn, xs, tm)
    r = split_dim(matmul(xr, tm["wr"].to(dt)), -1, H)
    k = split_dim(matmul(xk, tm["wk"].to(dt)), -1, H)
    v = split_dim(matmul(xv, tm["wv"].to(dt)), -1, H)
    g = matmul(xg, tm["wg"].to(dt))
    wlog = tm["w0"].float() + matmul(torch.tanh(matmul(xw.float(), tm["w1"].float())),
                                     tm["w2"].float())
    lw = split_dim(-torch.exp(wlog), -1, H)  # log decay <= 0

    if T == 1 or exec_cfg.rec_chunk <= 1 or T % min(exec_cfg.rec_chunk, T):
        y, sT = _per_shard(wkv_scan_ref, r, k, v, lw, tm["u"], state["wkv"])
    elif exec_cfg.attn_impl == "cuda":
        y, sT = kops.rwkv_scan(r, k, v, lw, tm["u"], state["wkv"], chunk=exec_cfg.rec_chunk,
                               interpret=exec_cfg.interpret)
    else:
        y, sT = _per_shard(wkv_chunked, r, k, v, lw, tm["u"], state["wkv"],
                           chunk=exec_cfg.rec_chunk)

    # per-head groupnorm, gate, out-proj
    yf = y.reshape(B, T, H, hd)
    # mean and variance accumulate in fp32 and round to the activation
    # dtype, as jnp.mean / jnp.var do
    y32 = yf.float()
    mu32 = y32.mean(dim=-1, keepdim=True)
    mu = mu32.to(dt)
    var = (y32 - mu32).square().mean(dim=-1, keepdim=True).to(dt)
    yn = ((yf - mu) * torch.rsqrt(var + 64e-5)).reshape(B, T, D)
    yn = yn * tm["ln_x"]["scale"].to(dt) + tm["ln_x"]["bias"].to(dt)
    out_tm = matmul(yn * F.silu(g), tm["wo"].to(dt))
    x = x + out_tm
    new_state = {"shift_tm": xn[:, -1], "wkv": sT}

    # ---- channel mix (its own pre-LN stream) ---------------------------------
    xn2 = norm_apply("layernorm", p["ln2"], x)
    xs2 = torch.cat([state["shift_cm"][:, None, :], xn2[:, :-1]], dim=1)
    dx2 = xs2 - xn2
    xk2 = xn2 + dx2 * cm["mu_k"].to(dt)
    xr2 = xn2 + dx2 * cm["mu_r"].to(dt)
    kk = torch.square(torch.relu(matmul(xk2, cm["wk"].to(dt))))
    out_cm = torch.sigmoid(matmul(xr2, cm["wr"].to(dt))) * matmul(kk, cm["wv"].to(dt))
    new_state["shift_cm"] = xn2[:, -1]
    return x + out_cm, new_state
