"""The port's ``ExecConfig`` knobs ``remat`` (activation checkpointing of
each block of the trainable model), ``logits_chunk`` (through the dry run
and the training launcher) and the ``"flashcost"`` attention surrogate
against the JAX package, on the CPU, at tiny sizes.

Tolerances: ``remat`` ``none``/``full``/``dots`` give bit-equal loss and
gradients in the port (fp32, the CPU: recomputation repeats the same ops);
each against the JAX package's ``remat`` of the same name is held to the
train tests' fp32 bounds (loss 1e-5, every gradient leaf within 1e-4 of its
largest magnitude, ``tests/test_torch_train.py``); the surrogate to 1e-6
(fp32 means over the sequence, summed in another order).
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
from repro.models.attention import _sdpa_flashcost as j_flashcost
from repro.train import make_loss_fn as jmake_loss
from repro_torch import configs as tconfigs
from repro_torch.models import ExecConfig as TExec
from repro_torch.models import Model as TModel
from repro_torch.models import TrainModel
from repro_torch.models.attention import _sdpa_flashcost as t_flashcost
from repro_torch.models.convert import params_from_jax
from repro_torch.train import make_loss_fn as tmake_loss

ARCHS = ["qwen2_7b", "recurrentgemma_2b", "rwkv6_7b", "moonshot_v1_16b_a3b"]
REMATS = ["none", "full", "dots"]
S = 16


def _cfgs(arch):
    return (dataclasses.replace(jconfigs.get_tiny(arch), compute_dtype="float32"),
            dataclasses.replace(tconfigs.get_tiny(arch), compute_dtype="float32"))


_JPARAMS = {}


def _jax_params(arch):
    if arch not in _JPARAMS:
        _JPARAMS[arch] = JModel(_cfgs(arch)[0]).init(jax.random.PRNGKey(0))
    return _JPARAMS[arch]


def _batch(seed=11, B=2):
    toks = np.random.RandomState(seed).randint(0, 512, (B, S + 1))
    return ({"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])},
            {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])})


_PORT = {}


def _port_loss_and_grads(arch, remat):
    if (arch, remat) not in _PORT:
        ct = _cfgs(arch)[1]
        tm = TrainModel(ct, TExec(remat=remat, rec_chunk=4), device="cpu")
        tm.load_state_dict(params_from_jax(ct, _jax_params(arch)))
        loss, _ = tmake_loss(tm)(tm.params(), _batch()[1])
        loss.backward()
        _PORT[arch, remat] = (loss.detach(), {n: p.grad.clone() for n, p in tm.params().items()})
    return _PORT[arch, remat]


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_equal_to_none(arch, remat):
    loss0, grads0 = _port_loss_and_grads(arch, "none")
    loss, grads = _port_loss_and_grads(arch, remat)
    assert torch.equal(loss, loss0)
    assert grads.keys() == grads0.keys()
    for name, g in grads.items():
        assert torch.equal(g, grads0[name]), name


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("arch", ARCHS[:2])
def test_remat_matches_jax(arch, remat):
    cj, ct = _cfgs(arch)
    jm = JModel(cj, JExec(remat=remat, rec_chunk=4))
    fn = jmake_loss(jm)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(lambda p: fn(p, _batch()[0]),
                                                    has_aux=True))(_jax_params(arch))
    jgrads = params_from_jax(ct, jgrads)
    loss, grads = _port_loss_and_grads(arch, remat)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, atol=1e-5)
    for name, g in grads.items():
        ref = jgrads[name].numpy()
        scale = np.abs(ref).max() + 1e-12
        assert np.abs(g.numpy() - ref).max() / scale <= 1e-4, name


def test_remat_checkpoints_only_under_grad():
    """Serving (no_grad) never checkpoints: the same forward as without
    remat, and ``torch.utils.checkpoint`` is not reached."""
    cfg = tconfigs.get_tiny("qwen2_7b")
    m0 = TModel(cfg, TExec(), device="cpu", seed=0)
    m1 = TModel(cfg, TExec(remat="full"), device="cpu", seed=0)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(0, 512, (2, 8)))
    with torch.autograd.graph.saved_tensors_hooks(lambda t: pytest.fail("saved"), lambda t: t):
        h1 = m1({"tokens": tokens})
    assert torch.equal(m0({"tokens": tokens}), h1)


def test_exec_config_checks_the_new_knobs():
    assert TExec().remat == "none" and TExec().logits_chunk == 0
    TExec(attn_impl="flashcost", remat="dots", logits_chunk=128)
    with pytest.raises(ValueError):
        TExec(remat="some")
    with pytest.raises(ValueError):
        TExec(attn_impl="pallas")


@pytest.mark.parametrize("B,Sq,H,Kh,Skv", [(2, 8, 4, 2, 8), (1, 1, 8, 1, 32), (3, 5, 6, 6, 7)])
def test_flashcost_surrogate_equals_jax(B, Sq, H, Kh, Skv):
    rs = np.random.RandomState(B * 100 + Sq)
    hd = 16
    q = rs.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rs.standard_normal((B, Kh, Skv, hd)).astype(np.float32)
    v = rs.standard_normal((B, Kh, Skv, hd)).astype(np.float32)
    ref = np.asarray(j_flashcost(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = t_flashcost(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)).numpy()
    assert got.shape == ref.shape == (B, Sq, H, hd)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ["qwen2_7b", "seamless_m4t_large_v2"])
def test_flashcost_runs_every_attention_site(arch, monkeypatch):
    """Under ``attn_impl="flashcost"`` training, prefill and decode reach
    the surrogate (self and cross attention) and never the plain path."""
    from repro_torch.models import attention

    calls = []
    monkeypatch.setattr(attention, "_sdpa", lambda *a: pytest.fail("plain path"))
    real = attention._sdpa_flashcost
    monkeypatch.setattr(attention, "_sdpa_flashcost", lambda *a: calls.append(1) or real(*a))
    cfg = tconfigs.get_tiny(arch)
    m = TModel(cfg, TExec(attn_impl="flashcost"), device="cpu", seed=0)
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int64)}
    if cfg.is_encdec:
        batch["frames"] = torch.zeros((2, cfg.ctx_tokens, cfg.d_model))
    m(batch)
    _, states = m.prefill(batch)
    m.decode_step(torch.zeros((2, 1), dtype=torch.int64), states, 8)
    assert len(calls) >= 3 * cfg.n_layers


def test_logits_chunk_reaches_the_loss_through_run_cell(monkeypatch):
    """The dry run hands ``ExecConfig.logits_chunk`` to the train step, so
    the vocab-chunked loss runs (and is counted)."""
    from repro_torch.launch import dryrun
    from repro_torch.train import loss as tloss

    chunks = []
    real = tloss.xent_chunked
    monkeypatch.setattr(tloss, "xent_chunked",
                        lambda h, w, labels, valid=None, chunk=8192:
                        chunks.append(chunk) or real(h, w, labels, valid, chunk))
    r = dryrun.run_cell("qwen2_7b", "train_4k", tiny=True, mesh_spec=((1, 2), ("data", "model")),
                        exec_overrides={"logits_chunk": 128}, verbose=False)
    assert r["status"] == "ok" and r["exec"]["logits_chunk"] == 128
    assert chunks == [128]


def test_launch_train_passes_logits_chunk(monkeypatch):
    """``TrainJob`` (the training launcher's) builds its step with the
    ``logits_chunk`` of its ``ExecConfig``."""
    from repro_torch.runtime import driver

    seen = []
    real = driver.make_train_step
    monkeypatch.setattr(driver, "make_train_step",
                        lambda *a, **kw: seen.append(kw.get("logits_chunk")) or real(*a, **kw))
    job = driver.TrainJob(arch="qwen2_7b", tiny=True, steps=1, global_batch=2, seq_len=8,
                          device="cpu", exec_cfg=TExec(rec_chunk=8, logits_chunk=64))
    job.run()
    assert seen and set(seen) == {64}
