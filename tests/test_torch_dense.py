"""The four dense configs of the port (qwen2-7b, starcoder2-15b, qwen2-72b,
llama3-405b) against the JAX package, on the CPU: each ``CONFIG`` and
``tiny()`` field for field, and the tiny models' prefill + decode, and the
train package's prefill / decode steps, at ``tests/test_torch_models.py``'s
limits: fp32 logits 1e-4 and the same greedy tokens; bf16 logits within
3e-2 of the largest logit, teacher-forced on the JAX stream.  Weights come
from the JAX ``Model.init`` through ``params_from_jax``; the JAX model runs
its Pallas kernels in interpret mode, the port its kernels' plain versions.
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
from repro_torch import configs as tconfigs
from repro_torch.models import ExecConfig as TExec
from repro_torch.models import Model as TModel
from repro_torch.models import TrainModel
from repro_torch.models.convert import params_from_jax

DENSE = ["qwen2_7b", "starcoder2_15b", "qwen2_72b", "llama3_405b"]


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


@pytest.mark.parametrize("arch", DENSE)
def test_dense_configs_equal_jax_field_for_field(arch):
    for which in ("CONFIG", "tiny"):
        jc = jconfigs.get(arch) if which == "CONFIG" else jconfigs.get_tiny(arch)
        tc = tconfigs.get(arch) if which == "CONFIG" else tconfigs.get_tiny(arch)
        for f in dataclasses.fields(tc):
            assert getattr(tc, f.name) == getattr(jc, f.name), (which, f.name)
        assert tc.param_count() == jc.param_count()
    assert tconfigs.get(arch.replace("_", "-")) == tconfigs.get(arch)


PROMPT, GEN = 12, 6


def _jax_stream(arch, dtype, tokens):
    cj, _ = _cfgs(arch, dtype)
    jm = JModel(cj, JExec(attn_impl="pallas", rec_chunk=4, interpret=True))
    params = _jax_params(arch)
    hidden, states = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t, "max_len": PROMPT + GEN}))(
        params, jnp.asarray(tokens))
    logits = [jm.logits(params, hidden[:, None])[:, 0]]
    step = jax.jit(jm.decode_step)
    toks = []
    for i in range(GEN):
        tok = jnp.argmax(logits[-1], -1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok))
        lg, states = step(params, tok, states, jnp.int32(PROMPT + i))
        logits.append(lg)
    return [np.asarray(lg, np.float32) for lg in logits], toks


def _port_stream(arch, dtype, tokens, teacher=None):
    _, ct = _cfgs(arch, dtype)
    model = TModel(ct, TExec(attn_impl="cuda", rec_chunk=4, interpret=True), device="cpu")
    model.load_state_dict(params_from_jax(ct, _jax_params(arch)))
    hidden, states = model.prefill({"tokens": torch.from_numpy(tokens), "max_len": PROMPT + GEN})
    logits = [model.logits(hidden[:, None])[:, 0]]
    toks = []
    for i in range(GEN):
        tok = logits[-1].argmax(-1)[:, None] if teacher is None else torch.tensor(teacher[i]).long()
        toks.append(tok.numpy())
        lg, states = model.decode_step(tok, states, PROMPT + i)
        logits.append(lg)
    return logits, toks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_prefill_and_decode_match_jax(arch, dtype):
    tokens = np.random.RandomState(21).randint(0, 512, (2, PROMPT))
    jl, jt = _jax_stream(arch, dtype, tokens)
    if dtype == "float32":
        tl, tt = _port_stream(arch, dtype, tokens)
        for a, b in zip(tl, jl):
            np.testing.assert_allclose(_f32(a), b, atol=1e-4, rtol=1e-4)
        assert [t.tolist() for t in tt] == [t.tolist() for t in jt]
    else:
        tl, _ = _port_stream(arch, dtype, tokens, teacher=jt)
        for a, b in zip(tl, jl):
            assert a.dtype == torch.bfloat16
            assert np.abs(_f32(a) - b).max() <= 3e-2 * np.abs(b).max()


def test_prefill_and_decode_steps_match_jax():
    """``make_prefill_step`` / ``make_decode_step`` (the JAX signatures, the
    model's own parameters) give the JAX steps' logits at the fp32 limit."""
    from repro.train import make_decode_step as jdecode
    from repro.train import make_prefill_step as jprefill
    from repro_torch.train import make_decode_step as tdecode
    from repro_torch.train import make_prefill_step as tprefill

    cj, ct = _cfgs("qwen2_7b", "float32")
    jm = JModel(cj, JExec(attn_impl="pallas", rec_chunk=4, interpret=True))
    tm = TrainModel(ct, TExec(attn_impl="cuda", rec_chunk=4, interpret=True), device="cpu")
    tm.load_state_dict(params_from_jax(ct, _jax_params("qwen2_7b")))
    tokens = np.random.RandomState(22).randint(0, 512, (2, 8))
    jp = _jax_params("qwen2_7b")
    jl, jst = jprefill(jm)(jp, {"tokens": jnp.asarray(tokens), "max_len": 10})
    tl, tst = tprefill(tm)(tm.params(), {"tokens": torch.from_numpy(tokens), "max_len": 10})
    np.testing.assert_allclose(_f32(tl), np.asarray(jl), atol=1e-4, rtol=1e-4)
    tok = np.array(jnp.argmax(jl, -1))[:, None]
    jl2, _ = jdecode(jm)(jp, jnp.asarray(tok, jnp.int32), jst, jnp.int32(8))
    tl2, _ = tdecode(tm)(tm.params(), torch.from_numpy(tok).long(), tst, 8)
    np.testing.assert_allclose(_f32(tl2), np.asarray(jl2), atol=1e-4, rtol=1e-4)
