"""The port's training stack against the JAX package, on the CPU, at tiny
sizes: data, losses, AdamW and its schedule, the trainable model's loss and
gradients, and one train step.

Weights come from the JAX ``Model.init`` and are carried across by
``params_from_jax`` (into the fp32 masters of ``TrainModel``, no rounding);
inputs are made with numpy from a seed.  The JAX model runs its Pallas
kernels in interpret mode (``attn_impl="pallas", interpret=True``), the port
its kernels' plain versions (``attn_impl="cuda", interpret=True``).
Tolerances:

* batches: bit-equal;
* cross-entropy: 1e-5;
* AdamW over five updates: fp32 state at 1e-6 relative, bf16 state at 1e-2;
  the cosine schedule and the global-norm clip at 1e-7;
* loss and gradients in fp32 compute: loss 1e-5, each gradient leaf within
  1e-4 of its largest magnitude; in bf16 compute 5e-2 (the JAX tests' bf16
  bound, ``tests/test_train.py``), the gradients measured against the exact
  ones (see ``test_loss_and_grads_match_jax``);
* one train step (update included), fp32: 1e-5.

The four dense configs' serving parity is in ``tests/test_torch_dense.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")  # without torch the whole module skips

import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro.data import SyntheticLM as JSynthetic
from repro.data import make_batch_for as jmake_batch
from repro.models import ExecConfig as JExec
from repro.models import Model as JModel
from repro.train import make_loss_fn as jmake_loss
from repro.train import make_train_step as jmake_step
from repro.train import xent_chunked as jxent_chunked
from repro.train import xent_full as jxent_full
from repro_torch import configs as tconfigs
from repro_torch import optim as toptim
from repro_torch.data import SyntheticLM as TSynthetic
from repro_torch.data import make_batch_for as tmake_batch
from repro_torch.models import ExecConfig as TExec
from repro_torch.models import Model as TModel
from repro_torch.models import TrainModel
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import keeps_fp32
from repro_torch.train import make_loss_fn as tmake_loss
from repro_torch.train import make_train_step as tmake_step
from repro_torch.train import xent_chunked as txent_chunked
from repro_torch.train import xent_full as txent_full

TRAIN_ARCHS = ["qwen2_7b", "starcoder2_15b", "recurrentgemma_2b", "rwkv6_7b"]
S = 16  # a multiple of rec_chunk 4, so the scans take their kernels


def _np(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape) * scale).astype(np.float32)


def _f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


_PARAMS = {}


def _jax_params(arch):
    if arch not in _PARAMS:
        _PARAMS[arch] = JModel(jconfigs.get_tiny(arch)).init(jax.random.PRNGKey(0))
    return _PARAMS[arch]


def _cfgs(arch, dtype):
    return (dataclasses.replace(jconfigs.get_tiny(arch), compute_dtype=dtype),
            dataclasses.replace(tconfigs.get_tiny(arch), compute_dtype=dtype))


def _models(arch, dtype):
    cj, ct = _cfgs(arch, dtype)
    jm = JModel(cj, JExec(attn_impl="pallas", rec_chunk=4, interpret=True))
    tm = TrainModel(ct, TExec(attn_impl="cuda", rec_chunk=4, interpret=True), device="cpu")
    tm.load_state_dict(params_from_jax(ct, _jax_params(arch)))
    return jm, tm


def _batch(seed, B=2):
    toks = np.random.RandomState(seed).randint(0, 512, (B, S + 1))
    labels = toks[:, 1:].copy()
    labels[0, -2:] = 515  # pad labels: masked out of the loss
    return ({"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(labels)})


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("seed,step", [(0, 0), (7, 13), (3, 2**20 + 5)])
def test_synthetic_batches_equal_jax_bit_for_bit(seed, step):
    want = JSynthetic(1000, 24, 4, seed=seed).batch(step)
    got = TSynthetic(1000, 24, 4, seed=seed, device="cpu").batch(step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int64 and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    it = iter(TSynthetic(1000, 24, 4, seed=seed, device="cpu"))
    assert torch.equal(next(it)["tokens"], TSynthetic(1000, 24, 4, seed, "cpu").batch(0)["tokens"])


@pytest.mark.parametrize("arch", ["qwen2_7b", "rwkv6_7b"])
def test_make_batch_for_equals_jax_and_refuses_unported_families(arch):
    want = jmake_batch(jconfigs.get_tiny(arch), 2, 16, step=3, seed=1)
    got = tmake_batch(tconfigs.get_tiny(arch), 2, 16, step=3, seed=1, device="cpu")
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # the VLM and encoder-decoder families are ported: their batches carry
    # the modality-stub context beside the same tokens
    vlm = dataclasses.replace(tconfigs.get_tiny(arch), family="vlm", ctx_tokens=4)
    got = tmake_batch(vlm, 2, 16, step=3, seed=1, device="cpu")
    assert sorted(got) == sorted([*want, "ctx_embeds"])
    assert got["ctx_embeds"].shape == (2, 4, vlm.d_model)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))


# -------------------------------------------------------------------- loss
@pytest.mark.parametrize("masked", [False, True])
def test_xent_full_and_chunked_match_jax(masked):
    h, w = _np(1, (2, 5, 16)), _np(2, (16, 64), 0.5)
    labels = np.random.RandomState(3).randint(0, 64, (2, 5))
    valid = (np.random.RandomState(4).rand(2, 5) > 0.3).astype(np.float32) if masked else None
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.from_numpy(valid)
    want_f, nf = jxent_full(jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels), jv)
    want_c, _ = jxent_chunked(jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels), jv, chunk=16)
    th, tw, tl = torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(labels)
    got_f, n = txent_full(th, tw, tl, tv)
    got_c, _ = txent_chunked(th, tw, tl, tv, chunk=16)
    np.testing.assert_allclose(float(got_f), float(want_f), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got_c), float(want_c), rtol=1e-5, atol=1e-5)
    assert float(n) == float(nf)
    with pytest.raises(ValueError, match="not divisible"):
        txent_chunked(th, tw, tl, chunk=24)


# ------------------------------------------------------------------- optim
def _opt_tree(seed):
    return {"w": _np(seed, (6, 5)), "b": _np(seed + 1, (5,)), "nested": {"s": _np(seed + 2, (3,))}}


def _tree(fn, t):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in t.items()}


@pytest.mark.parametrize("state_dtype,tol", [(None, 1e-6), ("bfloat16", 1e-2)])
def test_adamw_five_updates_match_jax(state_dtype, tol):
    kw = dict(weight_decay=0.1, clip_norm=1.0, state_dtype=state_dtype)
    jopt = joptim.AdamW(lr=joptim.cosine_schedule(1e-2, 2, 5), **kw)
    topt = toptim.AdamW(lr=toptim.cosine_schedule(1e-2, 2, 5), **kw)
    p0 = _opt_tree(0)
    jp = _tree(jnp.asarray, p0)
    tp = _tree(torch.from_numpy, p0)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(5):
        g = _tree(lambda a: a * (3.0 if i == 1 else 0.2), _opt_tree(10 + 3 * i))  # step 2 clips
        jp, js, jm = jopt.update(_tree(jnp.asarray, g), js, jp)
        tp2, ts2, tm = topt.update(_tree(torch.from_numpy, g), ts, tp)
        assert tp2 is tp and ts2 is ts  # updated in place
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7)
    assert int(ts["step"]) == int(js["step"]) == 5
    for a, b in zip(toptim.tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol, atol=tol * 1e-2)
    for part in ("m", "v"):
        for a, b in zip(toptim.tree_leaves(ts[part]), jax.tree.leaves(js[part])):
            assert a.dtype == (torch.bfloat16 if state_dtype else torch.float32)
            np.testing.assert_allclose(_f32(a), np.asarray(b, np.float32), rtol=tol,
                                       atol=tol * np.abs(np.asarray(b, np.float32)).max())


def test_cosine_schedule_and_clip_match_jax():
    jlr, tlr = joptim.cosine_schedule(3e-3, 10, 110), toptim.cosine_schedule(3e-3, 10, 110)
    for s in (0, 1, 5, 10, 11, 37, 60, 99, 110, 200):
        np.testing.assert_allclose(float(tlr(s)), float(jlr(s)), rtol=1e-7, atol=0)
        assert float(tlr(torch.tensor(s, dtype=torch.int32))) == float(tlr(s))
    for scale in (10.0, 0.01):
        t = _tree(lambda a: a * scale, _opt_tree(5))
        jc, jn = joptim.clip_by_global_norm(_tree(jnp.asarray, t), 1.0)
        tc, tn = toptim.clip_by_global_norm(_tree(torch.from_numpy, t), 1.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-7)
        for a, b in zip(toptim.tree_leaves(tc), jax.tree.leaves(jc)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7, atol=0)
        np.testing.assert_allclose(float(toptim.global_norm(tc)), float(joptim.global_norm(jc)),
                                   rtol=1e-7)


# ------------------------------------------------------- loss and gradients
_GRADS = {}


def _grads(arch, dtype):
    """(JAX loss, JAX grads in the port's layout, port loss, port grads),
    computed once per (arch, dtype)."""
    if (arch, dtype) not in _GRADS:
        jm, tm = _models(arch, dtype)
        jb, tb = _batch(11)
        fn = jmake_loss(jm)
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(lambda p: fn(p, jb), has_aux=True))(
            _jax_params(arch))
        loss, metrics = tmake_loss(tm)(tm.params(), tb)
        loss.backward()
        assert metrics["tokens"].item() == 2 * S - 2
        _GRADS[arch, dtype] = (float(jloss), {n: t.numpy() for n, t in
                                              params_from_jax(tm.cfg, jgrads).items()},
                               float(loss.detach()),
                               {n: _f32(p.grad) for n, p in tm.params().items()})
    return _GRADS[arch, dtype]


def _err(a, b, scale):
    return np.abs(a - b).max() / scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_loss_and_grads_match_jax(arch, dtype):
    """fp32: loss at 1e-5, every gradient leaf within 1e-4 of its largest
    magnitude.  bf16: the loss within 5e-2; the gradients are held to the
    exact (fp32) ones: per leaf, the port's bf16 gradient may be no further
    from them than the JAX package's bf16 gradient is, plus 5e-2 of the
    leaf's largest magnitude.  A direct bf16-to-bf16 bound does not hold
    here in either direction: these tiny models' bf16 gradients are
    dominated by rounding (JAX's own bf16 rwkv6 gradients lie up to 0.5 of
    a leaf's magnitude from its fp32 ones, and a key bias's gradient is zero
    in exact arithmetic, so in bf16 it is noise in both packages)."""
    jloss, jgrads, loss, grads = _grads(arch, dtype)
    assert sorted(jgrads) == sorted(grads)
    if dtype == "float32":
        np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=1e-5)
        for name, g in grads.items():
            scale = np.abs(jgrads[name]).max() + 1e-12
            assert _err(g, jgrads[name], scale) <= 1e-4, (name, _err(g, jgrads[name], scale))
        return
    np.testing.assert_allclose(loss, jloss, rtol=5e-2, atol=5e-2)
    _, exact, _, _ = _grads(arch, "float32")
    for name, g in grads.items():
        scale = np.abs(exact[name]).max() + 1e-12
        port, ref = _err(g, exact[name], scale), _err(jgrads[name], exact[name], scale)
        assert port <= ref + 5e-2, (name, port, ref)


@pytest.mark.parametrize("arch", ["qwen2_7b", "recurrentgemma_2b", "rwkv6_7b"])
def test_train_model_runs_the_kernels_under_autograd(arch):
    """The kernel path's forward goes through the ops wrappers (flash for
    window-0 attention, lru_scan for the RG-LRU layers, rwkv_scan for the
    RWKV layers), and each scan's backward through its backward kernel's
    plain version (once per forward call); the loss and gradients equal the
    plain path's on one batch and, on the batch ``_grads`` uses, the JAX
    package's ``value_and_grad`` (Pallas interpret), at the fp32 limits
    (loss 1e-5, each leaf 1e-4 of its largest magnitude)."""
    from repro_torch.kernels import linear_scan as tls
    from repro_torch.kernels import ops

    calls = {"flash_attention": 0, "lru_scan": 0, "rwkv_scan": 0}
    bwd_calls = {"lru_scan_bwd_plain": 0, "rwkv_scan_bwd_plain": 0}
    origs = {n: getattr(ops, n) for n in calls}
    bwd_origs = {n: getattr(tls, n) for n in bwd_calls}

    def counting(name, module, table, fns):
        def fn(*a, **k):
            table[name] += 1
            return fns[name](*a, **k)
        setattr(module, name, fn)

    def kernel_path(tb):
        """(loss, gradients) of the kernel path, its wrapper calls counted."""
        tm.zero_grad(set_to_none=True)
        tm.exec_cfg = TExec(attn_impl="cuda", interpret=True, rec_chunk=4)
        try:
            for n in calls:
                counting(n, ops, calls, origs)
            for n in bwd_calls:
                counting(n, tls, bwd_calls, bwd_origs)
            loss, _ = tmake_loss(tm)(tm.params(), tb)
            loss.backward()
        finally:
            for n, f in origs.items():
                setattr(ops, n, f)
            for n, f in bwd_origs.items():
                setattr(tls, n, f)
        return loss, {n: p.grad.clone() for n, p in tm.params().items()}

    _, tm = _models(arch, "float32")
    _, tb = _batch(12)
    loss, kernel_grads = kernel_path(tb)
    want = {"qwen2_7b": {"flash_attention": 2, "lru_scan": 0, "rwkv_scan": 0},
            "recurrentgemma_2b": {"flash_attention": 0, "lru_scan": 4, "rwkv_scan": 0},
            "rwkv6_7b": {"flash_attention": 0, "lru_scan": 0, "rwkv_scan": 2}}[arch]
    assert calls == want
    assert bwd_calls == {"lru_scan_bwd_plain": want["lru_scan"],
                         "rwkv_scan_bwd_plain": want["rwkv_scan"]}
    tm.zero_grad(set_to_none=True)
    tm.exec_cfg = TExec(attn_impl="xla", rec_chunk=4)
    loss2, _ = tmake_loss(tm)(tm.params(), tb)
    loss2.backward()
    np.testing.assert_allclose(loss.item(), loss2.item(), rtol=1e-5)
    for n, p in tm.params().items():
        scale = kernel_grads[n].abs().max().item()
        assert (p.grad - kernel_grads[n]).abs().max().item() <= 1e-4 * scale + 1e-12, n

    _, jb = _batch(11)
    jloss_t, jkernel_grads = kernel_path(jb)
    jloss, jgrads, _, _ = _grads(arch, "float32")
    np.testing.assert_allclose(jloss_t.item(), jloss, rtol=1e-5, atol=1e-5)
    for n, g in jkernel_grads.items():
        scale = np.abs(jgrads[n]).max() + 1e-12
        assert _err(_f32(g), jgrads[n], scale) <= 1e-4, (n, _err(_f32(g), jgrads[n], scale))


def test_chunked_loss_equals_full_loss_on_the_model():
    _, tm = _models("qwen2_7b", "float32")
    _, tb = _batch(13)
    full, _ = tmake_loss(tm)(tm.params(), tb)
    chunked, _ = tmake_loss(tm, logits_chunk=16)(tm.params(), tb)
    np.testing.assert_allclose(float(chunked), float(full), rtol=1e-5)


# ---------------------------------------------------------------- the step
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_update_matches_jax(microbatches):
    """One update: metrics, Adam's m and v (images of the gradient) and the
    new parameters at 1e-5.  The first Adam step moves each component by
    lr * g / (|g| + eps), a sign where |g| is far under the gradient's
    resolution (1e-4 of the leaf), so there the parameters are held to the
    step's size, lr (1 + weight decay |p|), instead."""
    jm, tm = _models("qwen2_7b", "float32")
    jb, tb = _batch(14, B=4)
    jopt, topt = joptim.AdamW(lr=1e-3), toptim.AdamW(lr=1e-3)
    jp = _jax_params("qwen2_7b")
    jp2, js2, jmet = jax.jit(jmake_step(jm, jopt, microbatches=microbatches))(
        jp, jopt.init(jp), jb)
    params = tm.params()
    p0 = {n: _f32(p) for n, p in params.items()}
    p2, s2, met = tmake_step(tm, topt, microbatches=microbatches)(params, topt.init(params), tb)
    assert p2 is params and all(p.grad is None for p in params.values())
    for k in ("loss", "grad_norm", "lr", "ce", "tokens"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5, atol=1e-6)
    want, want_m, want_v = (params_from_jax(tm.cfg, t) for t in (jp2, js2["m"], js2["v"]))
    for name, p in p2.items():
        m = want_m[name].numpy()
        for got, ref in ((s2["m"][name], m), (s2["v"][name], want_v[name].numpy())):
            assert _err(_f32(got), ref, np.abs(ref).max() + 1e-30) <= 1e-5, name
        sharp = np.abs(m) >= 1e-4 * np.abs(m).max()
        d = np.abs(_f32(p) - want[name].numpy())
        assert (d <= 1e-5 + 1e-5 * np.abs(want[name].numpy()))[sharp].all(), name
        assert (d <= 2e-3 * (1 + 0.1 * np.abs(p0[name])))[~sharp].all(), name
    with pytest.raises(ValueError, match="not divisible"):
        tmake_step(tm, topt, microbatches=3)(params, topt.init(params), tb)


# ------------------------------------------------------ the serving model
@pytest.mark.parametrize("arch", ["qwen2_7b", "recurrentgemma_2b", "rwkv6_7b"])
def test_serving_model_keeps_its_dtypes_and_the_train_model_masters(arch):
    """The serving form stores frozen weights in the dtype they are used in
    (fp32 only for norms and gates); the trainable form holds fp32 masters
    that require grad, with the same numbers before the cast."""
    cfg = tconfigs.get_tiny(arch)
    serving, train = TModel(cfg, device="cpu", seed=4), TrainModel(cfg, device="cpu", seed=4)
    sp, tp = dict(serving.named_parameters()), train.params()
    assert sorted(sp) == sorted(tp)
    for name, p in sp.items():
        fp32 = keeps_fp32(tuple(name.split(".")))
        assert p.dtype == (torch.float32 if fp32 else torch.bfloat16), name
        assert not p.requires_grad
        t = tp[name]
        assert t.dtype == torch.float32 and t.requires_grad
        assert torch.equal(t.detach().to(p.dtype), p), name
    batch = {"tokens": torch.zeros(1, 4, dtype=torch.int64)}
    assert serving(batch).grad_fn is None
    hidden, aux = train(batch)
    assert hidden.requires_grad and float(aux) == 0.0

