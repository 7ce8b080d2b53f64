"""RWKV-6's decode step (T = 1) as six hand-written CUDA kernels a layer
(``csrc/rwkv_decode.cu``), around the layer's ten weight products, which
stay with the library.

Replaces no Pallas kernel: the JAX package runs its T = 1 step as the plain
chain of ``models/rwkv6.py::rwkv_apply`` (the per-token oracle
``kernels/ref.py::rwkv_scan_ref`` with the norms, the token shift, the
interpolation, the decay's low-rank path, the group norm and the channel
mix), which XLA fuses under ``jit``.  The eager port ran that chain as some
97 small kernels a layer, every one a node of a decode graph; here it is
six, in the order the layer calls them:

* :func:`shift_mix`: ln1 → the new token-shift state ``xn`` and ``xxx``;
* :func:`lora_mix`: tanh of ``xxx @ mix_w1``, the five rank-R deltas
  against ``mix_w2``, the five interpolations (``xw`` in fp32 for the
  decay's fp32 product; ``xk, xv, xr, xg`` stacked in the activation type);
* :func:`wkv_step`: the decay ``exp(-exp(w0 + tanh(a) @ w2))``, the exact
  one-token WKV update of the fp32 state, the per-head group norm with
  ``ln_x``, times ``silu(g)``;
* :func:`cm_mix`: the residual add, ln2, the channel mix's token shift;
* :func:`relu_sq`: ``relu(h)²``;
* :func:`cm_out`: ``x + sigmoid(rr) · kv``.

Arithmetic is fp32; a value is rounded to the activation type only where
the plain chain hands it to a weight product or keeps it (states, the
residual stream, the block's output), so the chain's intermediate bf16
roundings are dropped, never added.  Each function's plain PyTorch version
(``*_plain``) repeats that arithmetic; CPU tensors take it under
``interpret=True``, CUDA tensors launch the kernel, anything else raises.
``launches`` counts kernel launches, ``plain_calls`` the plain versions'
calls.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from . import _cuda

__all__ = ["shift_mix", "lora_mix", "wkv_step", "cm_mix", "relu_sq", "cm_out", "shift_mix_plain",
           "lora_mix_plain", "wkv_step_plain", "cm_mix_plain", "relu_sq_plain", "cm_out_plain",
           "KERNELS", "HEAD_DIMS", "MAX_D_MODEL", "launches", "plain_calls"]

#: the kernels of one layer's step, in the order the layer launches them
KERNELS = ("shift_mix", "lora_mix", "wkv_step", "cm_mix", "relu_sq", "cm_out")
#: head sizes ``wkv_step``'s kernel is built for: rwkv6-7b's and its tiny
#: config's
HEAD_DIMS = (16, 64)
#: the decay's low-rank width ``wkv_step``'s kernel takes at most
MAX_DECAY_RANK = 256
#: the widest row ``shift_mix``'s and ``cm_mix``'s kernels hold (16 values
#: for each of a block's 1024 threads)
MAX_D_MODEL = 16384
_ACT = (torch.float32, torch.bfloat16)

#: kernel launches so far, and calls of the plain versions
launches = 0
plain_calls = 0
_count_lock = threading.Lock()

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_ARGTYPES = {
    "shift_mix": [_I] + [_P] * 5 + [_I, _I, _F, _P, _P, _P],
    "lora_mix": [_I] + [_P] * 5 + [_I, _I, _I, _P, _P, _P],
    "wkv_step": [_I] + [_P] * 11 + [_I, _I, _I, _I, _F, _P, _P, _P],
    "cm_mix": [_I] + [_P] * 7 + [_I, _I, _F, _P, _P, _P, _P],
    "relu_sq": [_I, _P, _L, _P, _P],
    "cm_out": [_I, _P, _P, _P, _L, _P, _P],
}


def _count(plain: bool) -> None:
    global launches, plain_calls
    with _count_lock:
        if plain:
            plain_calls += 1
        else:
            launches += 1


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    lib = _cuda.load("rwkv_decode")
    fn = getattr(lib, f"repro_rwkv_{name}")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    err = lib.repro_rwkv_decode_error_string
    err.restype = ctypes.c_char_p
    return fn, err


def _plain_ok(name: str, tensors) -> None:
    if any(t.is_cuda for t in tensors):
        raise ValueError(f"rwkv_decode.{name}: interpret=True runs the plain version on CPU tensors only")
    _count(True)


def _on_card(name: str, act: dict, f32: dict) -> tuple:
    """``act`` (in one activation dtype) and ``f32`` (fp32) tensors, checked
    to lie on one CUDA device and made contiguous (a no-op for the step's
    own tensors; the first step after a prefill gets strided shift states).
    Returns (the contiguous tensors in the order given, the bf16 flag)."""
    first = next(iter(act.values()))
    dev, dt = first.device, first.dtype
    if not first.is_cuda:
        raise ValueError(f"rwkv_decode.{name}: inputs are on {dev}; the CUDA kernel needs CUDA "
                         "tensors (interpret=True runs the plain version on CPU tensors)")
    if dt not in _ACT:
        raise ValueError(f"rwkv_decode.{name}: activations in {dt}; supported: {list(_ACT)}")
    out = []
    for group, want in ((act, dt), (f32, torch.float32)):
        for what, t in group.items():
            if type(t) not in (torch.Tensor, torch.nn.Parameter):
                raise ValueError(f"rwkv_decode.{name}: {what} is a {type(t).__name__}; the kernel "
                                 "takes plain tensors")
            if t.device != dev:
                raise ValueError(f"rwkv_decode.{name}: {what} is on {t.device}, the activations on {dev}")
            if t.dtype != want:
                raise ValueError(f"rwkv_decode.{name}: {what} has dtype {t.dtype}, needs {want}")
            out.append(t.contiguous())
    return out, int(dt == torch.bfloat16)


def _launch(name: str, dev, *args) -> None:
    fn, err = _entry(name)
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rwkv_decode.{name} kernel launch failed: CUDA error {rc}: "
                           f"{err(rc).decode()}")
    _count(False)


def _rows(name: str, x, *others) -> tuple:
    """(B, D) of ``x``, every tensor of ``others`` of that shape."""
    if x.dim() != 2 or any(o.shape != x.shape for o in others):
        raise ValueError(f"rwkv_decode.{name}: rows must share one (B, D) shape; got "
                         f"{[tuple(t.shape) for t in (x, *others)]}")
    return x.shape


def _row_fits(name: str, D: int) -> None:
    if D > MAX_D_MODEL:
        raise ValueError(f"rwkv_decode.{name}: rows of {D} exceed the kernel's {MAX_D_MODEL}")


def _vecs(name: str, D: int, **vecs) -> None:
    for what, t in vecs.items():
        if t.shape != (D,):
            raise ValueError(f"rwkv_decode.{name}: {what} is {tuple(t.shape)}, needs ({D},)")


# ------------------------------------------------------------ plain versions
def _layernorm(x32, w, b, eps):
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + eps) * w.float() + b.float()


def shift_mix_plain(x, shift, ln_w, ln_b, mu_x, eps: float = 1e-6):
    """x, shift: (B, D) -> (xn = ln1(x), xxx = xn + (shift - xn) · mu_x),
    both in ``x.dtype``; statistics and arithmetic in fp32 on the rounded xn."""
    xn = _layernorm(x.float(), ln_w, ln_b, eps).to(x.dtype)
    xf = xn.float()
    return xn, (xf + (shift.float() - xf) * mu_x.float()).to(x.dtype)


def lora_mix_plain(zpre, xn, shift, mix_w2, mu_5):
    """zpre: (B, 5R), ``xxx @ mix_w1``; xn, shift: (B, D); mix_w2: (5, R,
    D); mu_5: (5, D) -> (xw (B, D) fp32, (xk, xv, xr, xg) stacked (4, B, D)
    in ``xn.dtype``): xn + dx · (mu_5[i] + tanh(z_i) @ mix_w2[i])."""
    B, D = xn.shape
    R = mix_w2.shape[1]
    z = torch.tanh(zpre.float()).reshape(B, 5, R)
    deltas = torch.einsum("bfr,frd->fbd", z, mix_w2.float())
    xf = xn.float()
    mixed = xf + (shift.float() - xf) * (mu_5.float()[:, None, :] + deltas)  # (5, B, D)
    return mixed[0], mixed[1:].to(xn.dtype)


def wkv_step_plain(r, k, v, g, a, w0, w2, u, s, lnx_w, lnx_b, eps: float = 64e-5):
    """r, k, v, g: (B, D); a: (B, L) fp32, ``xw @ w1``; w0: (D,); w2: (L,
    D); u: (H, hd); s: (B, H, hd, hd) fp32 -> (the gated group-normed
    output (B, D) in ``r.dtype``, the new state fp32).  lw = -exp(w0 +
    tanh(a) @ w2); y = r · (s + u k vᵀ); s' = e^lw s + k vᵀ."""
    B, H, hd, _ = s.shape
    lw = -torch.exp(w0.float() + torch.tanh(a.float()) @ w2.float())
    rf, kf, vf = (t.float().reshape(B, H, hd) for t in (r, k, v))
    kv = kf[..., :, None] * vf[..., None, :]
    sf = s.float()
    y = torch.einsum("bhk,bhkv->bhv", rf, sf + u.float()[None, :, :, None] * kv)
    s_new = torch.exp(lw.reshape(B, H, hd))[..., None] * sf + kv
    mu = y.mean(dim=-1, keepdim=True)
    var = (y - mu).square().mean(dim=-1, keepdim=True)
    yn = ((y - mu) * torch.rsqrt(var + eps)).reshape(B, H * hd) * lnx_w.float() + lnx_b.float()
    gf = g.float()
    return (yn * (gf * torch.sigmoid(gf))).to(r.dtype), s_new


def cm_mix_plain(x, o, shift, ln_w, ln_b, mu_k, mu_r, eps: float = 1e-6):
    """x, o (the time mix's output), shift: (B, D) -> (x1 = x + o, xn =
    ln2(x1), (xk, xr) stacked (2, B, D)), all in ``x.dtype``."""
    x1 = (x.float() + o.float()).to(x.dtype)
    xn = _layernorm(x1.float(), ln_w, ln_b, eps).to(x.dtype)
    xf = xn.float()
    dx = shift.float() - xf
    return x1, xn, torch.stack([xf + dx * mu_k.float(), xf + dx * mu_r.float()]).to(x.dtype)


def relu_sq_plain(h):
    """relu(h)² in ``h.dtype``."""
    return torch.square(torch.relu(h.float())).to(h.dtype)


def cm_out_plain(x1, rr, kv):
    """x1 + sigmoid(rr) · kv in ``x1.dtype``."""
    return (x1.float() + torch.sigmoid(rr.float()) * kv.float()).to(x1.dtype)


# ---------------------------------------------------------------- wrappers
def shift_mix(x, shift, ln_w, ln_b, mu_x, *, eps: float = 1e-6, interpret: bool = False):
    """:func:`shift_mix_plain` as a kernel (one block a row held in
    registers; rows up to ``MAX_D_MODEL``)."""
    B, D = _rows("shift_mix", x, shift)
    _vecs("shift_mix", D, ln_w=ln_w, ln_b=ln_b, mu_x=mu_x)
    if interpret:
        _plain_ok("shift_mix", (x, shift, ln_w, ln_b, mu_x))
        return shift_mix_plain(x, shift, ln_w, ln_b, mu_x, eps)
    _row_fits("shift_mix", D)
    (x, shift, mu_x, ln_w, ln_b), bf = _on_card("shift_mix", {"x": x, "shift": shift, "mu_x": mu_x},
                                                {"ln_w": ln_w, "ln_b": ln_b})
    xn, xxx = torch.empty_like(x), torch.empty_like(x)
    _launch("shift_mix", x.device, bf, x.data_ptr(), shift.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
            mu_x.data_ptr(), B, D, eps, xn.data_ptr(), xxx.data_ptr())
    return xn, xxx


def lora_mix(zpre, xn, shift, mix_w2, mu_5, *, interpret: bool = False):
    """:func:`lora_mix_plain` as a kernel (a thread a channel for up to 8
    rows, mix_w2 read once for them)."""
    B, D = _rows("lora_mix", xn, shift)
    R = mix_w2.shape[1] if mix_w2.dim() == 3 else -1
    if mix_w2.shape != (5, R, D) or mu_5.shape != (5, D) or zpre.shape != (B, 5 * R):
        raise ValueError(f"rwkv_decode.lora_mix: zpre {tuple(zpre.shape)}, mix_w2 "
                         f"{tuple(mix_w2.shape)}, mu_5 {tuple(mu_5.shape)} do not fit rows ({B}, {D})")
    if interpret:
        _plain_ok("lora_mix", (zpre, xn, shift, mix_w2, mu_5))
        return lora_mix_plain(zpre, xn, shift, mix_w2, mu_5)
    (zpre, xn, shift, mix_w2, mu_5), bf = _on_card(
        "lora_mix", {"zpre": zpre, "xn": xn, "shift": shift, "mix_w2": mix_w2, "mu_5": mu_5}, {})
    xw = torch.empty((B, D), dtype=torch.float32, device=xn.device)
    xo = torch.empty((4, B, D), dtype=xn.dtype, device=xn.device)
    _launch("lora_mix", xn.device, bf, zpre.data_ptr(), xn.data_ptr(), shift.data_ptr(),
            mix_w2.data_ptr(), mu_5.data_ptr(), B, D, R, xw.data_ptr(), xo.data_ptr())
    return xw, xo


def wkv_step(r, k, v, g, a, w0, w2, u, s, lnx_w, lnx_b, *, eps: float = 64e-5,
             interpret: bool = False):
    """:func:`wkv_step_plain` as a kernel (one block a (row, head); head
    sizes ``HEAD_DIMS``)."""
    B, D = _rows("wkv_step", r, k, v, g)
    H, hd = u.shape if u.dim() == 2 else (-1, -1)
    L = a.shape[-1]
    if (H * hd != D or s.shape != (B, H, hd, hd) or a.shape != (B, L) or w2.shape != (L, D)):
        raise ValueError(f"rwkv_decode.wkv_step: u {tuple(u.shape)}, s {tuple(s.shape)}, a "
                         f"{tuple(a.shape)}, w2 {tuple(w2.shape)} do not fit rows ({B}, {D})")
    _vecs("wkv_step", D, w0=w0, lnx_w=lnx_w, lnx_b=lnx_b)
    if interpret:
        _plain_ok("wkv_step", (r, k, v, g, a, w0, w2, u, s, lnx_w, lnx_b))
        return wkv_step_plain(r, k, v, g, a, w0, w2, u, s, lnx_w, lnx_b, eps)
    if hd not in HEAD_DIMS or L > MAX_DECAY_RANK:
        raise ValueError(f"rwkv_decode.wkv_step: head size {hd} (built: {HEAD_DIMS}) or decay rank "
                         f"{L} (at most {MAX_DECAY_RANK}) has no kernel")
    (r, k, v, g, lnx_w, lnx_b, a, w0, w2, u, s), bf = _on_card(
        "wkv_step", {"r": r, "k": k, "v": v, "g": g, "lnx_w": lnx_w, "lnx_b": lnx_b},
        {"a": a, "w0": w0, "w2": w2, "u": u, "s": s})
    out = torch.empty_like(r)
    s_new = torch.empty_like(s)
    _launch("wkv_step", r.device, bf, *(t.data_ptr() for t in (r, k, v, g, a, w0, w2, u, s, lnx_w, lnx_b)),
            B, H, hd, L, eps, out.data_ptr(), s_new.data_ptr())
    return out, s_new


def cm_mix(x, o, shift, ln_w, ln_b, mu_k, mu_r, *, eps: float = 1e-6, interpret: bool = False):
    """:func:`cm_mix_plain` as a kernel (one block a row held in
    registers; rows up to ``MAX_D_MODEL``)."""
    B, D = _rows("cm_mix", x, o, shift)
    _vecs("cm_mix", D, ln_w=ln_w, ln_b=ln_b, mu_k=mu_k, mu_r=mu_r)
    if interpret:
        _plain_ok("cm_mix", (x, o, shift, ln_w, ln_b, mu_k, mu_r))
        return cm_mix_plain(x, o, shift, ln_w, ln_b, mu_k, mu_r, eps)
    _row_fits("cm_mix", D)
    (x, o, shift, mu_k, mu_r, ln_w, ln_b), bf = _on_card(
        "cm_mix", {"x": x, "o": o, "shift": shift, "mu_k": mu_k, "mu_r": mu_r},
        {"ln_w": ln_w, "ln_b": ln_b})
    x1, xn = torch.empty_like(x), torch.empty_like(x)
    xkr = torch.empty((2, B, D), dtype=x.dtype, device=x.device)
    _launch("cm_mix", x.device, bf, x.data_ptr(), o.data_ptr(), shift.data_ptr(), ln_w.data_ptr(),
            ln_b.data_ptr(), mu_k.data_ptr(), mu_r.data_ptr(), B, D, eps, x1.data_ptr(), xn.data_ptr(),
            xkr.data_ptr())
    return x1, xn, xkr


def relu_sq(h, *, interpret: bool = False):
    """:func:`relu_sq_plain` as a kernel."""
    if interpret:
        _plain_ok("relu_sq", (h,))
        return relu_sq_plain(h)
    (h,), bf = _on_card("relu_sq", {"h": h}, {})
    out = torch.empty_like(h)
    _launch("relu_sq", h.device, bf, h.data_ptr(), h.numel(), out.data_ptr())
    return out


def cm_out(x1, rr, kv, *, interpret: bool = False):
    """:func:`cm_out_plain` as a kernel."""
    _rows("cm_out", x1, rr, kv)
    if interpret:
        _plain_ok("cm_out", (x1, rr, kv))
        return cm_out_plain(x1, rr, kv)
    (x1, rr, kv), bf = _on_card("cm_out", {"x1": x1, "rr": rr, "kv": kv}, {})
    out = torch.empty_like(x1)
    _launch("cm_out", x1.device, bf, x1.data_ptr(), rr.data_ptr(), kv.data_ptr(), x1.numel(),
            out.data_ptr())
    return out
