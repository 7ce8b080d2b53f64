"""RWKV-6's fused decode step (``kernels/rwkv_decode.py``, ``csrc/rwkv_decode.cu``).
This file imports neither JAX nor ``repro``, so its card tests run on a
machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_rwkv_decode.py

On the CPU: each fused function's plain version against the same work done
by the T = 1 chain of ``models/rwkv6.py`` (written out below from that
chain), at the tiny config's widths (4 heads of 16) and at a slice with head
size 64 (4 heads of 64), in fp32 (the same arithmetic summed in another
order: 1e-5) and bf16 (the chain rounds its intermediates to bf16 and the
fused versions do not: ``BF16_TOL``); ``Model.decode_step`` through the plain
versions against the ``"xla"`` chain for several steps, logits and states;
the dispatch gate (prefill, ``attn_impl="xla"``, DTensors and autograd
never reach the fused functions), read from their counters; the wrappers'
refusals.

On the card (``cuda`` marker, each test skips without one): each kernel
against its plain version at both widths and at rwkv6-7b's (batch 8,
d_model 4096, 64 heads of 64, d_ff 14336), each element within 1e-5 of (1
+ its size) and a bf16 one within one bf16 step of its size besides; six
launches a layer in a decode step; a decode step's tokens through the
kernels against the chain's.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")  # without torch the whole module skips

import torch
import torch.nn.functional as F

from repro_torch import configs
from repro_torch.kernels import rwkv_decode as rd
from repro_torch.kernels.ref import rwkv_scan_ref
from repro_torch.models import ExecConfig, Model
from repro_torch.models import rwkv6
from repro_torch.models.layers import norm_apply

#: (d_model, heads, d_ff) of the widths the fused functions are held at:
#: the tiny config's, a slice of rwkv6-7b's heads (head size 64)
WIDTHS = {"tiny": None, "hd64": (256, 4, 512)}
#: on the card also rwkv6-7b's widths
CARD_WIDTHS = {**WIDTHS, "rwkv6_7b": (4096, 64, 14336)}
#: bf16: the chain rounds every intermediate (dx, each product, the deltas,
#: y before its group norm, the norm's mean and variance, sigmoid, silu) to
#: bf16, the fused versions only their outputs; outputs are O(1), where a
#: bf16 step is 2^-7 to 2^-6, and a few such roundings compound
BF16_TOL = 4e-2
FP32_TOL = 1e-5
#: a bf16 output of a kernel against its plain version: one bf16 step of
#: the element's own size beyond ``FP32_TOL`` (the same fp32 arithmetic in
#: another order can round to the neighbouring bf16 value)
BF16_STEP = 2 ** -7
STEPS = 4


def _cfg(width: str, dtype: str = "float32", layers: int = 2):
    cfg = configs.get_tiny("rwkv6_7b")
    if CARD_WIDTHS[width] is not None:
        d, h, ff = CARD_WIDTHS[width]
        cfg = dataclasses.replace(cfg, d_model=d, n_heads=h, n_kv_heads=h, d_head=d // h, d_ff=ff)
    return dataclasses.replace(cfg, compute_dtype=dtype, n_layers=layers, n_groups=layers)


def _randn(seed, shape, dtype=torch.float32, scale=1.0):
    x = np.random.RandomState(seed).standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(dtype)


def _layer(width: str, dtype: str, device="cpu"):
    """(config, one served layer's parameters with nonzero mixes, a
    residual row, its states) in ``dtype``."""
    cfg = _cfg(width, dtype)
    model = Model(cfg, ExecConfig(), device=device, seed=3)
    p = model.layers[0].tree()
    dt = getattr(torch, dtype)
    B, D, H, hd = 3, cfg.d_model, cfg.n_heads, cfg.d_head
    with torch.no_grad():  # the initialisation's zero mixes would hide the shift
        for i, t in enumerate((p["tm"]["mu_x"], p["tm"]["mu_5"], p["cm"]["mu_k"], p["cm"]["mu_r"])):
            t.copy_(torch.rand(t.shape, generator=torch.Generator().manual_seed(i)).to(t.device))
    x = _randn(1, (B, D), dt).to(device)
    state = {"shift_tm": _randn(2, (B, D), dt).to(device), "shift_cm": _randn(3, (B, D), dt).to(device),
             "wkv": _randn(4, (B, H, hd, hd), scale=0.5).to(device)}
    return cfg, p, x, state


def _close(got, want, tol):
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(), atol=tol, rtol=tol)


# ------------------------------------------- the chain's T = 1 work, written out
def _chain_shift_mix(p, x, shift):
    xn = norm_apply("layernorm", p["ln1"], x)
    return xn, xn + (shift - xn) * p["tm"]["mu_x"].to(x.dtype)


def _chain_lora_mix(p, xn, shift):
    """zpre as the fused path forms it, and the chain's five interpolations."""
    tm = p["tm"]
    dx = shift - xn
    xxx = xn + dx * tm["mu_x"].to(xn.dtype)
    mixed = rwkv6._ddlerp(xn[:, None], shift[:, None], tm)
    return xxx @ tm["mix_w1"].to(xn.dtype), [t[:, 0] for t in mixed]


def _chain_wkv_step(cfg, p, r, k, v, g, xw, s):
    tm = p["tm"]
    B, D = r.shape
    H, hd = cfg.n_heads, cfg.d_head
    dt = r.dtype
    lw = -torch.exp(tm["w0"].float() + torch.tanh(xw.float() @ tm["w1"].float()) @ tm["w2"].float())
    y, sT = rwkv_scan_ref(*(t.reshape(B, 1, H, hd) for t in (r, k, v, lw)), tm["u"], s)
    yf = y.reshape(B, 1, H, hd)
    y32 = yf.float()
    mu32 = y32.mean(dim=-1, keepdim=True)
    var = (y32 - mu32).square().mean(dim=-1, keepdim=True).to(dt)
    yn = ((yf - mu32.to(dt)) * torch.rsqrt(var + 64e-5)).reshape(B, D)
    yn = yn * tm["ln_x"]["scale"].to(dt) + tm["ln_x"]["bias"].to(dt)
    return yn * F.silu(g), sT


def _chain_cm_mix(p, x, o, shift):
    x1 = x + o
    xn = norm_apply("layernorm", p["ln2"], x1)
    dx = shift - xn
    return x1, xn, xn + dx * p["cm"]["mu_k"].to(x.dtype), xn + dx * p["cm"]["mu_r"].to(x.dtype)


def _cases(cfg, p, x, state):
    """Each fused function's (arguments, the chain's outputs for them) on
    one layer's inputs, every argument taken from the chain's own work."""
    tm, cm = p["tm"], p["cm"]
    dt = x.dtype
    ln1, ln2, lnx = p["ln1"], p["ln2"], tm["ln_x"]
    shift = state["shift_tm"]
    cases = {"shift_mix": ((x, shift, ln1["scale"], ln1["bias"], tm["mu_x"].to(dt)),
                           _chain_shift_mix(p, x, shift))}
    xn = cases["shift_mix"][1][0]
    zpre, mixed = _chain_lora_mix(p, xn, shift)
    cases["lora_mix"] = ((zpre, xn, shift, tm["mix_w2"].to(dt), tm["mu_5"].to(dt)), mixed)
    xw, xk, xv, xr, xg = mixed
    r, k, v, g = xr @ tm["wr"].to(dt), xk @ tm["wk"].to(dt), xv @ tm["wv"].to(dt), xg @ tm["wg"].to(dt)
    cases["wkv_step"] = ((r, k, v, g, xw.float() @ tm["w1"].float(), tm["w0"], tm["w2"], tm["u"],
                          state["wkv"], lnx["scale"].to(dt), lnx["bias"].to(dt)),
                         _chain_wkv_step(cfg, p, r, k, v, g, xw, state["wkv"]))
    o = cases["wkv_step"][1][0] @ tm["wo"].to(dt)
    x1, xn2, xk2, xr2 = _chain_cm_mix(p, x, o, state["shift_cm"])
    cases["cm_mix"] = ((x, o, state["shift_cm"], ln2["scale"], ln2["bias"], cm["mu_k"].to(dt),
                        cm["mu_r"].to(dt)), (x1, xn2, xk2, xr2))
    h = xk2 @ cm["wk"].to(dt)
    kk = torch.square(torch.relu(h))
    cases["relu_sq"] = ((h,), (kk,))
    rr, kv = xr2 @ cm["wr"].to(dt), kk @ cm["wv"].to(dt)
    cases["cm_out"] = ((x1, rr, kv), (x1 + torch.sigmoid(rr) * kv,))
    return cases


def _outputs(name: str, args, interpret: bool) -> tuple:
    """A fused function's outputs, one tensor each (the stacked ones split)."""
    out = getattr(rd, name)(*args, interpret=interpret)
    if name == "lora_mix":
        return (out[0], *out[1].unbind(0))
    if name == "cm_mix":
        return (out[0], out[1], *out[2].unbind(0))
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("kernel", rd.KERNELS)
@torch.no_grad()
def test_plain_version_matches_the_chain(kernel, width, dtype):
    cfg, p, x, state = _layer(width, dtype)
    args, want = _cases(cfg, p, x, state)[kernel]
    got = _outputs(kernel, args, interpret=True)
    assert len(got) == len(want)
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        # the decay's input xw and the state stay fp32; the rest is in the activation dtype
        fp32 = (kernel == "lora_mix" and i == 0) or (kernel == "wkv_step" and i == 1)
        assert g.dtype == (torch.float32 if fp32 else x.dtype), (kernel, i)
        _close(g, w, tol)


def _decode(model, impl, tokens, states, pos):
    """(logits, states) of each step, feeding ``tokens[:, i]`` at step i."""
    model.exec_cfg = ExecConfig(attn_impl=impl, rec_chunk=4, interpret=True)
    out = []
    for i in range(tokens.shape[1]):
        logits, states = model.decode_step(tokens[:, i:i + 1], states, pos + i)
        out.append((logits, states))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_decode_step_through_the_plain_versions_matches_the_chain(width, dtype):
    """The same tokens fed to both paths for ``STEPS`` steps from one
    prefill: logits within ``FP32_TOL`` (fp32) or ``BF16_TOL`` of the
    largest |logit| (bf16), every state alike, six fused calls a layer."""
    cfg = _cfg(width, dtype)
    model = Model(cfg, ExecConfig(attn_impl="cuda", rec_chunk=4, interpret=True), device="cpu", seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (3, 8), generator=torch.Generator().manual_seed(5))
    _, states = model.prefill({"tokens": tokens, "max_len": 8 + STEPS})
    fed = torch.randint(0, cfg.vocab_size, (3, STEPS), generator=torch.Generator().manual_seed(6))
    before, launched = rd.plain_calls, rd.launches
    fused = _decode(model, "cuda", fed, states, 8)
    assert rd.plain_calls - before == len(rd.KERNELS) * cfg.n_layers * STEPS
    assert rd.launches == launched
    chain = _decode(model, "xla", fed, states, 8)
    assert rd.plain_calls - before == len(rd.KERNELS) * cfg.n_layers * STEPS
    for (lf, sf), (lc, sc) in zip(fused, chain):
        scale = lc.float().abs().max().item()
        tol = FP32_TOL if dtype == "float32" else BF16_TOL
        _close(lf / scale, lc / scale, tol)
        for a, b in zip(sf, sc):
            assert sorted(a) == sorted(b) == ["shift_cm", "shift_tm", "wkv"]
            for name in a:
                assert a[name].dtype == b[name].dtype and a[name].shape == b[name].shape
                # the wkv state: the same fp32 recurrence on inputs that part by a bf16 step
                _close(a[name], b[name], tol if dtype == "float32" else 3 * BF16_TOL)


@pytest.mark.parametrize("case", ["prefill", "xla", "autograd", "dtensor"])
def test_only_a_kernel_path_decode_step_reaches_the_fused_functions(case):
    cfg, p, _, state = _layer("tiny", "float32")
    x = _randn(9, (3, 4 if case == "prefill" else 1, cfg.d_model))
    ec = ExecConfig(attn_impl="xla" if case == "xla" else "cuda", rec_chunk=4, interpret=True)
    before = (rd.plain_calls, rd.launches)
    if case == "autograd":
        x.requires_grad_(True)
        y, _ = rwkv6.rwkv_apply(cfg, p, x, state, exec_cfg=ec)
        y.sum().backward()
        assert x.grad is not None
    elif case == "dtensor":
        from torch.distributed.tensor import DTensor, Replicate

        from repro_torch.launch.mesh import fake_process_group, make_mesh

        with fake_process_group(1):
            mesh = make_mesh((1,), ("data",))

            def dt(t):
                return DTensor.from_local(t, mesh, [Replicate()], run_check=False)

            pd = {k: ({n: dt(t) if not isinstance(t, dict) else {m: dt(u) for m, u in t.items()}
                       for n, t in v.items()}) for k, v in p.items()}
            with torch.no_grad():
                y, _ = rwkv6.rwkv_apply(cfg, pd, dt(x), {k: dt(v) for k, v in state.items()}, exec_cfg=ec)
            assert isinstance(y, DTensor)
    else:
        with torch.no_grad():
            rwkv6.rwkv_apply(cfg, p, x, state, exec_cfg=ec)
    assert (rd.plain_calls, rd.launches) == before
    if case != "prefill":  # the same step without the reason to bypass takes them
        with torch.no_grad():
            rwkv6.rwkv_apply(cfg, p, x.detach()[:, :1], state,
                             exec_cfg=dataclasses.replace(ec, attn_impl="cuda"))
        assert rd.plain_calls == before[0] + len(rd.KERNELS)


def test_the_wrappers_refuse_what_they_do_not_take():
    cfg, p, x, state = _layer("tiny", "float32")
    ln = p["ln1"]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rd.shift_mix(x, state["shift_tm"], ln["scale"], ln["bias"], p["tm"]["mu_x"])
    with pytest.raises(ValueError, match="share one"):
        rd.shift_mix(x, state["shift_tm"][:2], ln["scale"], ln["bias"], p["tm"]["mu_x"], interpret=True)
    with pytest.raises(ValueError, match="do not fit"):
        rd.lora_mix(torch.zeros(3, 7), x, state["shift_tm"], p["tm"]["mix_w2"], p["tm"]["mu_5"],
                    interpret=True)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rd.relu_sq(x)


# --------------------------------------------------------------- on the card
def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _cpu(t):
    return t.cpu() if isinstance(t, torch.Tensor) else t


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", sorted(CARD_WIDTHS))
def test_kernels_match_their_plain_versions(width, dtype):
    dev = _card()
    cfg, p, x, state = _layer(width, dtype, device=dev)
    cases = _cases(cfg, p, x, state)
    before = rd.launches
    for name in rd.KERNELS:
        args = cases[name][0]
        got = _outputs(name, args, interpret=False)
        torch.cuda.synchronize()
        want = _outputs(name, tuple(map(_cpu, args)), interpret=True)
        for g, w in zip(got, want):
            assert g.is_cuda and g.dtype == w.dtype and g.shape == w.shape
            size = w.float().abs()
            lim = FP32_TOL * (1 + size) + (BF16_STEP * size if w.dtype == torch.bfloat16 else 0)
            assert bool(((g.float().cpu() - w.float()).abs() <= lim).all()), name
    assert rd.launches == before + len(rd.KERNELS)


@pytest.mark.cuda
def test_a_decode_step_launches_six_kernels_a_layer_and_keeps_the_chains_tokens():
    dev = _card()
    cfg = _cfg("hd64", "bfloat16")
    model = Model(cfg, ExecConfig(attn_impl="cuda", rec_chunk=4), device=dev, seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (8, 16), generator=torch.Generator().manual_seed(5))
    hidden, states = model.prefill({"tokens": tokens.to(dev), "max_len": 16 + STEPS})
    token = model.logits(hidden[:, None])[:, 0].argmax(-1)[:, None]
    before = rd.launches
    fused = []
    st, tok = states, token
    for i in range(STEPS):
        logits, st = model.decode_step(tok, st, 16 + i)
        fused.append(logits)
        tok = logits.argmax(-1)[:, None]
    assert rd.launches - before == len(rd.KERNELS) * cfg.n_layers * STEPS
    model.exec_cfg = ExecConfig(attn_impl="xla", rec_chunk=4)
    st, tok = states, token
    for i in range(STEPS):
        logits, st = model.decode_step(tok, st, 16 + i)
        scale = logits.float().abs().max().item()
        assert (fused[i].float() - logits.float()).abs().max().item() <= BF16_TOL * scale
        tok = fused[i].argmax(-1)[:, None]
