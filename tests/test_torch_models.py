"""The port's models against the JAX package's, on the CPU, at tiny sizes.

Weights come from the JAX ``Model.init`` and are carried across by
``params_from_jax``; inputs are made with numpy from a seed.  The port runs
its kernels' plain versions (``interpret=True``), the JAX package its
Pallas kernels in interpret mode.  Tolerances:

* fp32 (``compute_dtype`` replaced by float32): blocks at atol = rtol =
  1e-5, whole-model logits at 1e-4 with an identical greedy token stream;
* bf16: whole-model logits within 3e-2 of the largest logit.  XLA and
  PyTorch round bf16 products and activations at different places (one
  bf16 step, 1.6e-2 at the logits' magnitude, per disagreement), so the
  decode steps are teacher-forced on the JAX stream there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")  # without torch the whole module skips

import torch

from repro import configs as jconfigs
from repro.models import ExecConfig as JExec
from repro.models import Model as JModel
from repro.models import attention as jattn
from repro.models import rglru as jrglru
from repro.models import rwkv6 as jrwkv
from repro_torch import configs as tconfigs
from repro_torch.models import ExecConfig as TExec
from repro_torch.models import Model as TModel
from repro_torch.models import attention as tattn
from repro_torch.models import rglru as trglru
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models.convert import params_from_jax, stage_defs

ARCHS = ["recurrentgemma_2b", "rwkv6_7b"]
PROMPT, GEN = 12, 8  # prompt longer than the tiny window (8): the ring wraps


def _cfgs(arch, dtype):
    cj, ct = jconfigs.get_tiny(arch), tconfigs.get_tiny(arch)
    return (dataclasses.replace(cj, compute_dtype=dtype),
            dataclasses.replace(ct, compute_dtype=dtype))


def _np(seed, shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, tol):
    g = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    w = want.float().numpy() if isinstance(want, torch.Tensor) else np.asarray(want, np.float32)
    np.testing.assert_allclose(g, w, atol=tol, rtol=tol)


_PARAMS = {}


def _jax_params(arch):
    """JAX ``Model.init`` parameters of the tiny config (fp32 masters; the
    compute dtype does not change them)."""
    if arch not in _PARAMS:
        cj = jconfigs.get_tiny(arch)
        _PARAMS[arch] = JModel(cj).init(jax.random.PRNGKey(0))
    return _PARAMS[arch]


def _port(arch, dtype, impl):
    cj, ct = _cfgs(arch, dtype)
    model = TModel(ct, TExec(attn_impl=impl, rec_chunk=4, interpret=True), device="cpu")
    model.load_state_dict(params_from_jax(ct, _jax_params(arch)))
    return model


# ------------------------------------------------------------------ convert
@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_fills_every_weight(arch):
    _, ct = _cfgs(arch, "bfloat16")
    sd = params_from_jax(ct, _jax_params(arch))
    model = TModel(ct, device="cpu", seed=3)
    want = model.state_dict()
    assert sorted(sd) == sorted(want)
    for name, t in sd.items():
        assert tuple(t.shape) == tuple(want[name].shape), name
    model.load_state_dict(sd)
    got = model.state_dict()
    # weights cast at use are stored in bf16 (rounded as the JAX cast rounds),
    # the ones used in fp32 stay fp32
    kept = {n for n, t in got.items() if t.dtype == torch.float32}
    assert kept and all(("norm" in n or "ln1" in n or "ln2" in n or n.split(".")[-1] in
                         ("wa", "ba", "wi", "bi", "lam", "w0", "w1", "w2", "u")) for n in kept)
    for name, t in sd.items():
        want_dt = jnp.float32 if got[name].dtype == torch.float32 else jnp.bfloat16
        np.testing.assert_array_equal(got[name].float().numpy(),
                                      t.numpy().astype(want_dt).astype(np.float32))


# ------------------------------------------------------------------ blocks
def _layer(arch, kind):
    """(JAX params, port params) of the first layer of ``kind``."""
    cj, ct = _cfgs(arch, "float32")
    model = _port(arch, "float32", "xla")
    idx = ct.pattern.index(kind)
    flat, layer = 0, None
    for si, (kinds, ng) in enumerate(stage_defs(ct)):
        for g in range(ng):
            for i in range(len(kinds)):
                if flat == idx:
                    layer = jax.tree.map(lambda a, g=g: a[g], _jax_params(arch)["stages"][si][f"pos{i}"])
                flat += 1
    return cj, ct, layer, model._layer_trees()[idx]


@pytest.mark.parametrize("impl", ["xla", "cuda"])
@pytest.mark.parametrize("T", [12, 1])
def test_rglru_block_matches_jax(impl, T):
    cj, ct, pj, pt = _layer("recurrentgemma_2b", "rglru")
    x = _np(1, (2, T, cj.d_model))
    h0, conv = _np(2, (2, cj.rnn_width)), _np(3, (2, cj.conv_width - 1, cj.rnn_width))
    jimpl = "pallas" if impl == "cuda" else "xla"
    ec = JExec(attn_impl=jimpl, rec_chunk=4, interpret=True)
    yj, sj = jax.jit(lambda *a: jrglru.rglru_apply(cj, pj["rec"], *a, exec_cfg=ec))(
        jnp.asarray(x), {"h": jnp.asarray(h0), "conv": jnp.asarray(conv)})
    yt, st = trglru.rglru_apply(ct, pt["rec"], torch.from_numpy(x),
                                {"h": torch.from_numpy(h0), "conv": torch.from_numpy(conv)},
                                exec_cfg=TExec(attn_impl=impl, rec_chunk=4, interpret=True))
    _close(yt, yj, 1e-5)
    _close(st["h"], sj["h"], 1e-5)
    _close(st["conv"], sj["conv"], 1e-5)


@pytest.mark.parametrize("impl", ["xla", "cuda"])
@pytest.mark.parametrize("T", [12, 1, 6])  # 6: rec_chunk 4 does not divide, per-token path
def test_rwkv_block_matches_jax(impl, T):
    cj, ct, pj, pt = _layer("rwkv6_7b", "rwkv")
    B, D, H, hd = 2, cj.d_model, cj.n_heads, cj.d_head
    x = _np(4, (B, T, D))
    st_np = {"shift_tm": _np(5, (B, D)), "shift_cm": _np(6, (B, D)), "wkv": _np(7, (B, H, hd, hd))}
    jimpl = "pallas" if impl == "cuda" else "xla"
    ec = JExec(attn_impl=jimpl, rec_chunk=4, interpret=True)
    yj, sj = jax.jit(lambda *a: jrwkv.rwkv_apply(cj, pj, *a, exec_cfg=ec))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in st_np.items()})
    yt, st = trwkv.rwkv_apply(ct, pt, torch.from_numpy(x),
                              {k: torch.from_numpy(v) for k, v in st_np.items()},
                              exec_cfg=TExec(attn_impl=impl, rec_chunk=4, interpret=True))
    _close(yt, yj, 1e-5)
    for k in st_np:
        _close(st[k], sj[k], 1e-5)


def test_attention_prefill_and_decode_through_the_ring():
    """Prefill of 12 tokens into an 8-slot ring keeps the last 8; decode then
    overwrites slot pos mod 8 and masks by stored positions."""
    cj, ct, pj, pt = _layer("recurrentgemma_2b", "attn")
    B = 2
    cache_j = jattn.init_attn_cache(cj, B, PROMPT + GEN, window=cj.window)
    cache_t = tattn.init_attn_cache(ct, B, PROMPT + GEN, window=ct.window, device="cpu")
    assert cache_t["k"].shape == (B, ct.n_kv_heads, ct.window, ct.d_head)
    x = _np(8, (B, PROMPT, cj.d_model))
    japply = jax.jit(lambda x, q_pos, cache: jattn.attn_apply(cj, pj["attn"], x, q_pos=q_pos,
                                                              cache=cache, window=cj.window))
    yj, cache_j = japply(jnp.asarray(x), jnp.arange(PROMPT), cache_j)
    yt, cache_t = tattn.attn_apply(ct, pt["attn"], torch.from_numpy(x), q_pos=torch.arange(PROMPT),
                                   cache=cache_t, window=ct.window)
    _close(yt, yj, 1e-5)
    for step in range(GEN):
        pos = PROMPT + step
        xs = _np(20 + step, (B, 1, cj.d_model))
        yj, cache_j = japply(jnp.asarray(xs), jnp.asarray([pos]), cache_j)
        yt, cache_t = tattn.attn_apply(ct, pt["attn"], torch.from_numpy(xs),
                                       q_pos=torch.tensor([pos]), cache=cache_t, window=ct.window)
        _close(yt, yj, 1e-5)
    np.testing.assert_array_equal(cache_t["pos"].numpy(), np.asarray(cache_j["pos"]))
    _close(cache_t["k"], cache_j["k"], 1e-5)
    _close(cache_t["v"], cache_j["v"], 1e-5)


def test_full_sequence_attention_takes_the_flash_kernel_without_a_window():
    """Under the kernel option the no-cache, no-window branch runs the flash
    kernel's plain version and still equals the JAX plain path."""
    cj, ct, pj, pt = _layer("recurrentgemma_2b", "attn")
    cj, ct = (dataclasses.replace(c, window=0) for c in (cj, ct))
    x = _np(9, (2, 16, cj.d_model))
    yj, _ = jattn.attn_apply(cj, pj["attn"], jnp.asarray(x), q_pos=jnp.arange(16))
    calls = []
    orig = tattn.kops.flash_attention
    try:
        tattn.kops.flash_attention = lambda *a, **k: calls.append(1) or orig(*a, **k)
        yt, _ = tattn.attn_apply(ct, pt["attn"], torch.from_numpy(x), q_pos=torch.arange(16),
                                 exec_cfg=TExec(attn_impl="cuda", block_q=8, block_kv=8, interpret=True))
    finally:
        tattn.kops.flash_attention = orig
    assert calls == [1]
    _close(yt, yj, 1e-5)


# ------------------------------------------------------------- whole model
def _jax_stream(arch, dtype, impl, tokens, teacher=None):
    cj, _ = _cfgs(arch, dtype)
    jimpl = "pallas" if impl == "cuda" else "xla"
    jm = JModel(cj, JExec(attn_impl=jimpl, rec_chunk=4, interpret=True))
    params = _jax_params(arch)
    prefill = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t, "max_len": PROMPT + GEN}))
    hidden, states = prefill(params, jnp.asarray(tokens))
    logits = [jm.logits(params, hidden[:, None])[:, 0]]
    step = jax.jit(jm.decode_step)
    toks = []
    for i in range(GEN):
        tok = jnp.argmax(logits[-1], -1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok))
        lg, states = step(params, tok, states, jnp.int32(PROMPT + i))
        logits.append(lg)
    return [np.asarray(lg, np.float32) for lg in logits], toks


def _port_stream(arch, dtype, impl, tokens, teacher=None):
    model = _port(arch, dtype, impl)
    hidden, states = model.prefill({"tokens": torch.from_numpy(tokens), "max_len": PROMPT + GEN})
    logits = [model.logits(hidden[:, None])[:, 0]]
    toks = []
    for i in range(GEN):
        tok = logits[-1].argmax(-1)[:, None] if teacher is None else torch.tensor(teacher[i]).long()
        toks.append(tok.numpy())
        lg, states = model.decode_step(tok, states, PROMPT + i)
        logits.append(lg)
    return logits, toks


@pytest.mark.parametrize("impl", ["xla", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_in_fp32(arch, impl):
    tokens = np.random.RandomState(1).randint(0, 512, (2, PROMPT))
    jl, jt = _jax_stream(arch, "float32", impl, tokens)
    tl, tt = _port_stream(arch, "float32", impl, tokens)
    for a, b in zip(tl, jl):
        _close(a, b, 1e-4)
    assert [t.tolist() for t in tt] == [t.tolist() for t in jt]


@pytest.mark.parametrize("impl", ["xla", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_in_bf16(arch, impl):
    tokens = np.random.RandomState(2).randint(0, 512, (2, PROMPT))
    jl, jt = _jax_stream(arch, "bfloat16", impl, tokens)
    tl, _ = _port_stream(arch, "bfloat16", impl, tokens, teacher=jt)
    for a, b in zip(tl, jl):
        assert a.dtype == torch.bfloat16
        err = np.abs(a.float().numpy() - b).max()
        assert err <= 3e-2 * np.abs(b).max(), (err, np.abs(b).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_takes_a_tensor_position(arch):
    """A 0-d int64 ``pos`` (what a CUDA graph advances in place) gives the
    same logits, bit for bit, as the int, step after step through the ring,
    and both match the JAX model's ``decode_step`` at the fp32 limit."""
    tokens = np.random.RandomState(4).randint(0, 512, (2, PROMPT))
    jl, jt = _jax_stream(arch, "float32", "xla", tokens)
    model = _port(arch, "float32", "xla")
    batch = {"tokens": torch.from_numpy(tokens), "max_len": PROMPT + GEN}
    (h_int, s_int), (h_ten, s_ten) = model.prefill(batch), model.prefill(batch)
    tok = model.logits(h_int[:, None])[:, 0].argmax(-1)[:, None]
    pos = torch.tensor(PROMPT, dtype=torch.int64)
    for i in range(GEN):
        assert tok.numpy().tolist() == jt[i].tolist()
        lg_int, s_int = model.decode_step(tok, s_int, PROMPT + i)
        lg_ten, s_ten = model.decode_step(tok, s_ten, pos)
        assert torch.equal(lg_int, lg_ten)
        _close(lg_ten, jl[i + 1], 1e-4)
        tok = lg_ten.argmax(-1)[:, None]
        pos.add_(1)
    for a, b in zip(s_int, s_ten):
        for name in a:
            pairs = ([(a[name][n], b[name][n]) for n in a[name]] if isinstance(a[name], dict)
                     else [(a[name], b[name])])
            assert all(torch.equal(x, y) for x, y in pairs)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_writes_the_rings_in_place_and_returns_new_recurrent_states(arch):
    """What the served CUDA graphs rest on: a decode step writes every
    attention ring into the tensors it was given, and returns every
    recurrent state as a new tensor (copied back into the static set)."""
    model = _port(arch, "float32", "xla")
    tokens = torch.from_numpy(np.random.RandomState(5).randint(0, 512, (2, PROMPT)))
    _, states = model.prefill({"tokens": tokens, "max_len": PROMPT + GEN})
    new_lg, new = model.decode_step(tokens[:, :1], states, torch.tensor(PROMPT))
    assert new_lg.shape == (2, model.cfg.padded_vocab)
    kinds = set()
    for kind, old_st, new_st in zip(model.cfg.pattern, states, new):
        assert sorted(old_st) == sorted(new_st)
        for name, v in new_st.items():
            if isinstance(v, dict):
                kinds.add("ring")
                assert all(v[n] is old_st[name][n] for n in v)
            else:
                kinds.add("recurrent")
                assert v is not old_st[name] and v.shape == old_st[name].shape
    assert "recurrent" in kinds


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    cj, _ = _cfgs(arch, "float32")
    tokens = np.random.RandomState(3).randint(0, 512, (2, 8))
    jm = JModel(cj, JExec())
    hj, _ = jm.forward(_jax_params(arch), {"tokens": jnp.asarray(tokens)})
    ht = _port(arch, "float32", "xla")({"tokens": torch.from_numpy(tokens)})
    _close(ht, hj, 1e-5)


def test_unported_kinds_raise():
    cfg = tconfigs.get_tiny("rwkv6_7b")
    with pytest.raises(NotImplementedError, match="later slice"):
        TModel(dataclasses.replace(cfg, group=("cross",)), device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        TModel(dataclasses.replace(cfg, group=("attn",), ffn="moe"), device="cpu")
    with pytest.raises(KeyError, match="not ported"):
        tconfigs.get("qwen2_7b")
