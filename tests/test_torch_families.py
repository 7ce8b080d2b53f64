"""The encoder–decoder, VLM and MoE families of the port against the JAX
package, on the CPU, at tiny sizes: the MoE FFN (drop-free and on the
capacity branch), Arctic's dense residual, cross-attention, the encoder on
the flash kernel's plain version (non-causal), and the four configs
(seamless-m4t-large-v2, llama-3.2-vision-11b, moonshot-v1-16b-a3b,
arctic-480b) end to end.

Weights come from the JAX ``init`` functions through ``params_from_jax`` (or
numpy for single layers); inputs are made with numpy from a seed.  The JAX
model runs its Pallas kernels in interpret mode, the port its kernels'
plain versions.  Tolerances, as in ``tests/test_torch_models.py``: fp32
layers, hidden states and losses at atol = rtol = 1e-5; fp32 logits at
1e-4 with an identical greedy token stream; bf16 logits within 3e-2 of the
largest logit, with the decode steps teacher-forced on the JAX stream.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")  # without torch the whole module skips

import torch

from repro import configs as jconfigs
from repro.data import make_batch_for as jmake_batch
from repro.models import ExecConfig as JExec
from repro.models import Model as JModel
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.train import make_loss_fn as jloss_fn
from repro_torch import configs as tconfigs
from repro_torch.data import make_batch_for as tmake_batch
from repro_torch.kernels import ops as tops
from repro_torch.models import ExecConfig as TExec
from repro_torch.models import Model as TModel
from repro_torch.models import TrainModel
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_jax
from repro_torch.train import make_loss_fn as tloss_fn

FAMILIES = ["seamless_m4t_large_v2", "llama_3_2_vision_11b", "moonshot_v1_16b_a3b", "arctic_480b"]
PROMPT, GEN = 12, 6


def _np(seed, shape, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape)).astype(np.float32)


def _f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def _tree(p):
    """A JAX parameter dict as fp32 torch tensors."""
    if isinstance(p, dict):
        return {k: _tree(v) for k, v in p.items()}
    return torch.from_numpy(np.array(p, dtype=np.float32))


def _cfgs(arch, dtype):
    return (dataclasses.replace(jconfigs.get_tiny(arch), compute_dtype=dtype),
            dataclasses.replace(tconfigs.get_tiny(arch), compute_dtype=dtype))


_PARAMS = {}


def _jax_params(arch):
    if arch not in _PARAMS:
        _PARAMS[arch] = JModel(jconfigs.get_tiny(arch)).init(jax.random.PRNGKey(0))
    return _PARAMS[arch]


def _port(arch, dtype, impl="cuda", cls=TModel):
    _, ct = _cfgs(arch, dtype)
    model = cls(ct, TExec(attn_impl=impl, rec_chunk=4, interpret=True), device="cpu")
    model.load_state_dict(params_from_jax(ct, _jax_params(arch)))
    return model


def _context(arch, B):
    """The modality-stub input of ``arch`` (numpy, seed 31), or {}."""
    cfg = jconfigs.get_tiny(arch)
    ctx = _np(31, (B, cfg.ctx_tokens, cfg.d_model), 0.1)
    if cfg.is_encdec:
        return {"frames": ctx}
    if cfg.family == "vlm":
        return {"ctx_embeds": ctx}
    return {}


# --------------------------------------------------------------------- MoE
def _moe(arch, x, dtype="float32"):
    """(port y, port aux, JAX y, JAX aux, port routing) of one MoE FFN."""
    cj, ct = _cfgs(arch, dtype)
    pj = jmoe.moe_init(jax.random.PRNGKey(3), cj)
    pt = _tree(pj)
    jdt = jnp.dtype(dtype)
    yj, auxj = jax.jit(lambda p, x: jmoe.moe_apply(cj, p, x))(pj, jnp.asarray(x).astype(jdt))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    yt, auxt = tmoe.moe_apply(ct, pt, xt)
    return yt, auxt, yj, auxj, tmoe.route(ct, pt, xt.reshape(-1, x.shape[-1])), (cj, pj)


def _jax_keep(cj, pj, x):
    """The JAX routing's kept assignments (``models/moe.py``'s own
    expressions: softmax, top-k, token-major cumsum against the capacity)."""
    E, K = cj.n_experts, cj.top_k
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    T = xt.shape[0]
    probs = jax.nn.softmax(xt @ pj["router"], axis=-1)
    _, eidx = jax.lax.top_k(probs, K)
    C = int(np.ceil(T * K / E * cj.capacity_factor)) if T * K > 8192 else T * K
    flat_e = eidx.reshape(T * K)
    pos = jnp.cumsum(jax.nn.one_hot(flat_e, E, dtype=jnp.int32), axis=0) - 1
    return np.asarray(jnp.take_along_axis(pos, flat_e[:, None], axis=1)[:, 0] < C), C


@pytest.mark.parametrize("branch", ["drop_free", "capacity"])
def test_moe_apply_matches_jax(branch):
    """Drop-free at decode's size; on the capacity branch at T·K = 12288 >
    8192, with inputs that share a direction so that the router crowds a
    few experts past their capacity C = 1920 and assignments are dropped."""
    if branch == "drop_free":
        x = _np(40, (2, 4, 64))
    else:
        x = _np(41, (2, 2048, 64)) + 2.0 * _np(42, (64,))
    yt, auxt, yj, auxj, r, (cj, pj) = _moe("moonshot_v1_16b_a3b", x)
    T, K = x.shape[0] * x.shape[1], cj.top_k
    keep_j, C = _jax_keep(cj, pj, x)
    assert r["capacity"] == C == (T * K if branch == "drop_free" else 1920)
    np.testing.assert_array_equal(r["keep"].numpy(), keep_j)
    dropped = int((~r["keep"]).sum())
    assert (dropped == 0) if branch == "drop_free" else (dropped > 0)
    _close(yt, yj, 1e-5)
    _close(auxt, auxj, 1e-5)


def test_moe_apply_matches_jax_in_bf16():
    x = _np(43, (2, 8, 64))
    yt, auxt, yj, auxj, _, _ = _moe("moonshot_v1_16b_a3b", x, "bfloat16")
    assert yt.dtype == torch.bfloat16
    assert np.abs(_f32(yt) - _f32(yj)).max() <= 3e-2 * np.abs(_f32(yj)).max()
    _close(auxt, auxj, 1e-5)  # routing is fp32 in both


def test_arctic_dense_residual_matches_jax():
    """Arctic adds a dense SwiGLU FFN in parallel with the experts: the
    output is the MoE's plus ``ffn_apply("swiglu", dense, x)``."""
    from repro_torch.models.layers import ffn_apply

    x = _np(44, (2, 6, 64))
    yt, auxt, yj, auxj, _, (cj, pj) = _moe("arctic_480b", x)
    _close(yt, yj, 1e-5)
    _close(auxt, auxj, 1e-5)
    ct = dataclasses.replace(tconfigs.get_tiny("arctic_480b"), compute_dtype="float32")
    pt = _tree(pj)
    alone, _ = tmoe.moe_apply(dataclasses.replace(ct, moe_dense_residual=False), pt,
                              torch.from_numpy(x))
    dense = ffn_apply("swiglu", pt["dense"], torch.from_numpy(x))
    assert float(dense.abs().max()) > 0.1
    _close(yt, alone + dense, 1e-5)


def test_moe_dispatch_is_shape_static():
    """The capacity comes from the shapes alone, and every routing tensor
    has a shape fixed by (T, E, K): nothing depends on the data."""
    cfg = tconfigs.get("moonshot_v1_16b_a3b")
    assert tmoe.capacity(cfg, 8) == 48  # decode, batch 8: drop-free
    assert tmoe.capacity(cfg, 8 * 2048) == 1920  # the served prefill
    ct = tconfigs.get_tiny("moonshot_v1_16b_a3b")
    pt = _tree(jmoe.moe_init(jax.random.PRNGKey(3), jconfigs.get_tiny("moonshot_v1_16b_a3b")))
    for seed in (0, 1):
        r = tmoe.route(ct, pt, torch.from_numpy(_np(seed, (10, 64))))
        assert r["expert"].shape == r["slot"].shape == r["keep"].shape == (30,)
        assert r["gate"].shape == (10, 3)


# ----------------------------------------------------------- cross attention
def test_cross_attention_matches_jax():
    """``cross_kv`` and the ``kv=`` branch: no rope, no cache, unmasked."""
    cj, ct = _cfgs("llama_3_2_vision_11b", "float32")
    pj = jattn.attn_init(jax.random.PRNGKey(5), cj)
    pt = _tree(pj)
    x, ctx = _np(50, (2, 5, 64)), _np(51, (2, 16, 64), 0.1)
    kj, vj = jattn.cross_kv(cj, pj, jnp.asarray(ctx))
    kt, vt = tattn.cross_kv(ct, pt, torch.from_numpy(ctx))
    assert kt.shape == (2, ct.n_kv_heads, 16, ct.d_head)
    _close(kt, kj, 1e-5)
    _close(vt, vj, 1e-5)
    for q_pos in (np.arange(5), np.arange(7, 12)):  # positions do not matter: no rope
        yj, cj_out = jattn.attn_apply(cj, pj, jnp.asarray(x), q_pos=jnp.asarray(q_pos), kv=(kj, vj),
                                      causal=False, rope=False)
        yt, ct_out = tattn.attn_apply(ct, pt, torch.from_numpy(x), q_pos=torch.from_numpy(q_pos),
                                      kv=(kt, vt), causal=False, rope=False)
        assert cj_out is None and ct_out is None
        _close(yt, yj, 1e-5)


def test_rope_flag_matches_jax():
    cj, ct = _cfgs("qwen2_7b", "float32")
    pj = jattn.attn_init(jax.random.PRNGKey(6), cj)
    x = _np(52, (2, 8, 64))
    for rope in (True, False):
        yj, _ = jattn.attn_apply(cj, pj, jnp.asarray(x), q_pos=jnp.arange(8), rope=rope)
        yt, _ = tattn.attn_apply(ct, _tree(pj), torch.from_numpy(x), q_pos=torch.arange(8),
                                 rope=rope)
        _close(yt, yj, 1e-5)


# ------------------------------------------------------------------ encoder
def test_encode_matches_jax_on_the_non_causal_flash_kernel(monkeypatch):
    """The encoder's layers take the flash kernel, bidirectional: the JAX
    Pallas kernel in interpret mode against the port's plain version."""
    arch = "seamless_m4t_large_v2"
    cj, ct = _cfgs(arch, "float32")
    frames = _np(60, (2, ct.ctx_tokens, ct.d_model), 0.1)
    jm = JModel(cj, JExec(attn_impl="pallas", interpret=True))
    want = jax.jit(jm.encode)(_jax_params(arch), jnp.asarray(frames))
    calls = []
    real = tops.flash_attention

    def spy(*args, **kw):
        calls.append(kw["causal"])
        return real(*args, **kw)

    monkeypatch.setattr(tops, "flash_attention", spy)
    got = _port(arch, "float32").encode(torch.from_numpy(frames))
    assert calls == [False] * ct.enc_layers
    assert got.shape == (2, ct.ctx_tokens, ct.d_model)
    _close(got, want, 1e-5)


# --------------------------------------------------------- the four configs
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_configs_equal_jax_field_for_field(arch):
    for which in ("CONFIG", "tiny"):
        jc = jconfigs.get(arch) if which == "CONFIG" else jconfigs.get_tiny(arch)
        tc = tconfigs.get(arch) if which == "CONFIG" else tconfigs.get_tiny(arch)
        for f in dataclasses.fields(jc):
            assert getattr(tc, f.name) == getattr(jc, f.name), (which, f.name)
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
    assert tconfigs.get(jconfigs.get(arch).name) == tconfigs.get(arch)


def test_registry_has_every_jax_architecture():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.ALIASES == jconfigs.ALIASES


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_from_jax_fills_every_weight(arch):
    cfg = tconfigs.get_tiny(arch)
    sd = params_from_jax(cfg, _jax_params(arch))
    model = TModel(cfg, device="cpu")
    want = model.state_dict()
    assert sorted(sd) == sorted(want)
    for name, t in sd.items():
        assert t.shape == want[name].shape, name
    model.load_state_dict(sd)  # strict
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(_jax_params(arch)))
    assert sum(t.numel() for t in sd.values()) == n_jax
    if cfg.ffn == "moe":
        assert sd["layers.0.ffn.wi"].shape == (cfg.n_experts, cfg.d_model, cfg.d_ff_expert)
        assert sd["layers.0.ffn.router"].shape == (cfg.d_model, cfg.n_experts)
        assert model.layers[0].ffn.router.dtype == torch.float32  # routing runs in fp32
    if cfg.is_encdec:
        assert len(model.encoder) == cfg.enc_layers
        assert model.encoder_norm.scale.dtype == torch.float32


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_jax_with_the_aux_loss(arch):
    """The train model's ``forward`` (hidden, aux) against the JAX
    ``Model.forward``; aux is the MoE layers' summed router loss."""
    cj, _ = _cfgs(arch, "float32")
    tokens = np.random.RandomState(3).randint(0, 500, (2, 8))
    ctx = _context(arch, 2)
    jm = JModel(cj, JExec(attn_impl="pallas", interpret=True))
    hj, auxj = jax.jit(jm.forward)(_jax_params(arch), {
        "tokens": jnp.asarray(tokens), **{k: jnp.asarray(v) for k, v in ctx.items()}})
    model = _port(arch, "float32", cls=TrainModel)
    ht, auxt = model({"tokens": torch.from_numpy(tokens),
                      **{k: torch.from_numpy(v) for k, v in ctx.items()}})
    _close(ht, hj, 1e-5)
    _close(auxt, auxj, 1e-5)
    assert (float(auxt.detach()) > 0) == (cj.ffn == "moe")
    serving = _port(arch, "float32")({"tokens": torch.from_numpy(tokens),
                                      **{k: torch.from_numpy(v) for k, v in ctx.items()}})
    _close(serving, hj, 1e-5)


def _jax_stream(arch, dtype, tokens, ctx):
    cj, _ = _cfgs(arch, dtype)
    jm = JModel(cj, JExec(attn_impl="pallas", rec_chunk=4, interpret=True))
    params = _jax_params(arch)
    batch = {"tokens": jnp.asarray(tokens), **{k: jnp.asarray(v) for k, v in ctx.items()}}
    hidden, states = jax.jit(lambda p, b: jm.prefill(p, {**b, "max_len": PROMPT + GEN}))(params, batch)
    logits = [jm.logits(params, hidden[:, None])[:, 0]]
    step = jax.jit(jm.decode_step)
    toks = []
    for i in range(GEN):
        tok = jnp.argmax(logits[-1], -1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok))
        lg, states = step(params, tok, states, jnp.int32(PROMPT + i))
        logits.append(lg)
    return [np.asarray(lg, np.float32) for lg in logits], toks


def _port_stream(arch, dtype, tokens, ctx, teacher=None):
    model = _port(arch, dtype)
    batch = {"tokens": torch.from_numpy(tokens), "max_len": PROMPT + GEN,
             **{k: torch.from_numpy(v) for k, v in ctx.items()}}
    hidden, states = model.prefill(batch)
    logits = [model.logits(hidden[:, None])[:, 0]]
    toks = []
    for i in range(GEN):
        tok = logits[-1].argmax(-1)[:, None] if teacher is None else torch.tensor(teacher[i]).long()
        toks.append(tok.numpy())
        lg, states = model.decode_step(tok, states, PROMPT + i)
        logits.append(lg)
    return logits, toks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_jax(arch, dtype):
    tokens = np.random.RandomState(21).randint(0, 500, (2, PROMPT))
    ctx = _context(arch, 2)
    jl, jt = _jax_stream(arch, dtype, tokens, ctx)
    if dtype == "float32":
        tl, tt = _port_stream(arch, dtype, tokens, ctx)
        for a, b in zip(tl, jl):
            np.testing.assert_allclose(_f32(a), b, atol=1e-4, rtol=1e-4)
        assert [t.tolist() for t in tt] == [t.tolist() for t in jt]
    else:
        tl, _ = _port_stream(arch, dtype, tokens, ctx, teacher=jt)
        for a, b in zip(tl, jl):
            assert a.dtype == torch.bfloat16
            assert np.abs(_f32(a) - b).max() <= 3e-2 * np.abs(b).max()


@pytest.mark.parametrize("arch", ["seamless_m4t_large_v2", "llama_3_2_vision_11b"])
def test_cross_decode_reads_the_context_kv_in_place(arch):
    """What the served CUDA graphs rest on: prefill writes the context's
    K/V into the state's ``xk``/``xv``, and a decode step returns those very
    tensors, unchanged."""
    model = _port(arch, "float32", impl="xla")
    cfg = model.cfg
    tokens = torch.from_numpy(np.random.RandomState(5).randint(0, 500, (2, PROMPT)))
    ctx = {k: torch.from_numpy(v) for k, v in _context(arch, 2).items()}
    _, states = model.prefill({"tokens": tokens, "max_len": PROMPT + GEN, **ctx})
    cross = [st for kind, st in zip(cfg.pattern, states) if kind == "cross"]
    assert cross and all(st["xk"].shape == (2, cfg.n_kv_heads, cfg.ctx_tokens, cfg.d_head)
                         for st in cross)
    assert all(float(st["xk"].abs().max()) > 0 for st in cross)
    before = [(st["xk"].clone(), st["xv"].clone()) for st in cross]
    _, new = model.decode_step(tokens[:, :1], states, torch.tensor(PROMPT))
    new_cross = [st for kind, st in zip(cfg.pattern, new) if kind == "cross"]
    for old, st, (k0, v0) in zip(cross, new_cross, before):
        assert st["xk"] is old["xk"] and st["xv"] is old["xv"]
        assert torch.equal(st["xk"], k0) and torch.equal(st["xv"], v0)


@pytest.mark.parametrize("arch", FAMILIES)
def test_make_batch_for_shapes(arch):
    cfg = tconfigs.get_tiny(arch)
    want = jmake_batch(jconfigs.get_tiny(arch), 2, 16, step=3, seed=1)
    got = tmake_batch(cfg, 2, 16, step=3, seed=1, device="cpu")
    assert sorted(got) == sorted(want)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in set(got) - {"tokens", "labels"}:
        assert got[k].shape == want[k].shape == (2, cfg.ctx_tokens, cfg.d_model)
        assert got[k].dtype == torch.float32
        assert 0.05 < float(got[k].std()) < 0.15
        assert torch.equal(got[k], tmake_batch(cfg, 2, 16, step=3, seed=1, device="cpu")[k])
        assert not torch.equal(got[k], tmake_batch(cfg, 2, 16, step=4, seed=1, device="cpu")[k])


def test_moonshot_train_step_loss_matches_jax():
    """One tiny moonshot step: loss, ce and aux of ``make_loss_fn`` against
    the JAX loss, and the gradients against ``jax.value_and_grad``."""
    from repro_torch.optim import global_norm

    arch = "moonshot_v1_16b_a3b"
    cj, _ = _cfgs(arch, "float32")
    jb = jmake_batch(cj, 2, 16, step=0, seed=0)
    jm = JModel(cj, JExec(attn_impl="pallas", interpret=True))
    (lj, mj), gj = jax.jit(jax.value_and_grad(jloss_fn(jm), has_aux=True))(_jax_params(arch), jb)
    model = _port(arch, "float32", cls=TrainModel)
    tb = {k: torch.from_numpy(np.array(v)).long() for k, v in jb.items()}
    lt, mt = tloss_fn(model)(model.params(), tb)
    lt.backward()
    for name, want in (("loss", lj), ("ce", mj["ce"]), ("aux", mj["aux"])):
        _close(lt if name == "loss" else mt[name], want, 1e-5)
    assert float(mt["aux"].detach()) > 0
    grads = params_from_jax(cj, gj)
    norm_j = float(np.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values())))
    norm_t = float(global_norm([p.grad for p in model.params().values()]))
    assert abs(norm_t - norm_j) <= 1e-4 * norm_j
    router = "layers.0.ffn.router"
    g = grads[router]
    _close(model.params()[router].grad, g, 1e-4 * float(g.abs().max()))


# ----------------------------------------------------------------- serving
@pytest.mark.parametrize("arch", FAMILIES)
def test_tiny_serve_on_the_cpu(arch, tmp_path):
    """``python -m repro_torch.launch.serve --arch <id> --tiny --device cpu``
    serves each new family; a second run on the same DB is a hit."""
    from repro_torch.launch import serve

    db = str(tmp_path / "s.json")
    argv = ["--arch", arch, "--tiny", "--device", "cpu", "--prompt-len", "8", "--gen", "64",
            "--epsilon", "0.5", "--db", db]
    first = serve.serve(argv)
    cfg = first["model"].cfg
    assert first["hidden"].shape == (8, cfg.d_model)
    assert bool(torch.isfinite(first["hidden"].float()).all())
    key = "frames" if cfg.is_encdec else "ctx_embeds" if cfg.family == "vlm" else None
    if key:
        assert first["batch"][key].shape == (8, cfg.ctx_tokens, cfg.d_model)
    second = serve.serve(argv)
    assert second["db_hit"] and torch.equal(second["hidden"], first["hidden"])
