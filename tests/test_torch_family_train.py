"""Training the encoder–decoder and MoE families, on the CPU, against the
JAX package's ``train`` on the same seed: tiny seamless-m4t-large-v2 and
tiny moonshot-v1-16b-a3b.

Weights come from the JAX ``Model.init`` (``params_from_jax``, into the
port's fp32 masters) and batches from the JAX ``make_batch_for`` (the
port's token stream equals JAX's bit for bit; its ``frames`` draw other
numbers from the same distribution), so both packages take the same steps.
The JAX model runs its plain attention, the port its flash kernel's plain
version (the seamless encoder non-causal, every decoder self-attention
causal) with the cross attention's scores in the fp32 form the CPU runs.

* two steps through ``TrainJob`` and through ``make_train_step``, in fp32
  compute: the losses (and, from the step, the gradient norms) at 1e-5,
  the parameters at 1e-5 where every step's update is sharp (as
  ``test_train_step_update_matches_jax`` holds one step), elsewhere at
  2·lr a step;
* the same in the configs' bf16 compute, held as
  ``tests/test_torch_train.py`` holds bf16: the losses and gradient norms
  at 5e-2.  Parameters after Adam steps are not held in bf16: Adam's
  normalisation turns a bf16 rounding of a gradient far under its
  resolution into a step of lr either way, in both packages.
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
from repro.checkpoint import load_checkpoint as jload
from repro.data import make_batch_for as jmake_batch
from repro.models import ExecConfig as JExec
from repro.models import Model as JModel
from repro.runtime import TrainJob as JTrainJob
from repro.train import make_train_step as jmake_step
from repro_torch import configs as tconfigs
from repro_torch import optim as toptim
from repro_torch.models import ExecConfig as TExec
from repro_torch.models import TrainModel
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import TrainJob, driver
from repro_torch.train import make_train_step as tmake_step

ARCHS = ["seamless_m4t_large_v2", "moonshot_v1_16b_a3b"]
B, S, STEPS, LR = 2, 16, 2, 1e-3


def _torch_batch(jb) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


def _f32(t) -> np.ndarray:
    return t.detach().float().numpy()


def _configs_in(monkeypatch, dtype):
    """Both packages' tiny configs in ``dtype`` compute (TrainJob builds
    its model from ``configs.get_tiny``)."""
    for mod in (jconfigs, tconfigs):
        get_tiny = mod.get_tiny
        monkeypatch.setattr(mod, "get_tiny", lambda a, f=get_tiny: dataclasses.replace(
            f(a), compute_dtype=dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_job_matches_jax(arch, dtype, tmp_path, monkeypatch):
    _configs_in(monkeypatch, dtype)
    jcfg = jconfigs.get_tiny(arch)
    jhist = JTrainJob(arch=arch, tiny=True, steps=STEPS, global_batch=B, seq_len=S, lr=LR, warmup=0,
                      seed=0, ckpt_dir=str(tmp_path), ckpt_every=1, ckpt_async=False).run()
    jinit = JModel(jcfg).init(jax.random.PRNGKey(0))
    like = (jinit, joptim.AdamW(lr=LR).init(jinit))
    jstates = [jload(str(tmp_path), like, step=step)[0] for step in range(STEPS)]
    monkeypatch.setattr(driver, "make_batch_for", lambda cfg, b, s, step, seed, device: _torch_batch(
        jmake_batch(jcfg, b, s, step, seed)))

    class FromJax(TrainJob):
        def build(self):
            cfg, model, opt, params, opt_state = super().build()
            model.load_state_dict(params_from_jax(cfg, jinit))
            return cfg, model, opt, params, opt_state

    job = FromJax(arch=arch, tiny=True, steps=STEPS, global_batch=B, seq_len=S, lr=LR, warmup=0, seed=0,
                  device="cpu")
    hist = job.run()
    if dtype == "bfloat16":
        np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=5e-2, atol=5e-2)
        return
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-5, atol=1e-6)
    cfg = tconfigs.get_tiny(arch)
    _hold_params(job.state[0], params_from_jax(cfg, jstates[-1][0]),
                 [params_from_jax(cfg, st[1]["m"]) for st in jstates])


def _hold_params(got, want, ms):
    """The parameters at 1e-5 where every step's Adam update was sharp (its
    m resolved, 1e-4 of the leaf's largest), elsewhere at 2·lr a step: a
    step moves a component by lr·m/(√v + eps), a sign where |g| is far
    under the gradient's resolution."""
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        sharp = np.logical_and.reduce([np.abs(m[name].numpy()) >= 1e-4 * np.abs(m[name].numpy()).max()
                                       for m in ms])
        d = np.abs(_f32(p) - want[name].numpy())
        assert (d <= 1e-5 + 1e-5 * np.abs(want[name].numpy()))[sharp].all(), name
        assert (d <= 2 * LR * len(ms))[~sharp].all(), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_train_step_matches_jax(arch, dtype):
    jcfg = dataclasses.replace(jconfigs.get_tiny(arch), compute_dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_tiny(arch), compute_dtype=dtype)
    jinit = JModel(jconfigs.get_tiny(arch)).init(jax.random.PRNGKey(0))
    jm = JModel(jcfg, JExec())
    tm = TrainModel(tcfg, TExec(attn_impl="cuda", interpret=True), device="cpu")
    tm.load_state_dict(params_from_jax(tcfg, jinit))
    jopt, topt = joptim.AdamW(lr=LR), toptim.AdamW(lr=LR)
    jstep, tstep = jax.jit(jmake_step(jm, jopt)), tmake_step(tm, topt)
    jp, js = jinit, jopt.init(jinit)
    params = tm.params()
    state = topt.init(params)
    tol = {"float32": (1e-5, 1e-6), "bfloat16": (5e-2, 5e-2)}[dtype]
    ms = []
    for step in range(STEPS):
        jb = jmake_batch(jcfg, B, S, step, 0)
        jp, js, jmet = jstep(jp, js, jb)
        params, state, met = tstep(params, state, _torch_batch(jb))
        for k in ("loss", "grad_norm", "ce", "aux"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=tol[0], atol=tol[1], err_msg=k)
        ms.append(params_from_jax(tcfg, js["m"]))
    if dtype == "float32":
        _hold_params(params, params_from_jax(tcfg, jp), ms)
