"""Flash attention's gradient in the port, on the CPU: the backward
kernel's plain version (``flash_attention.flash_attention_bwd_plain``,
which ``ops.flash_attention``'s backward runs on CPU tensors with
``interpret=True``) against the JAX package's gradient (``jax.vjp`` of
``repro.kernels.ops.flash_attention``, Pallas in interpret mode), and
against torch autograd through the forward's plain version where the JAX
package's backward is the gradient of another function (causal with Sq !=
Skv: its oracle aligns the mask bottom-right, its forward kernel top-left).

Inputs come from numpy seeds.  Each gradient is held by ||port - want|| /
||want|| (heavy-tailed sums that cancel: an element-wise limit tied to the
largest value would pass a missing term): 1e-5 in fp32, 1e-2 in bf16 (the
backward rounds P and dS to bf16 as its tensor-core operands; the JAX
oracle rounds p and dP).  The CUDA kernel itself is held against the same
plain version on the card (``tests/test_torch_cuda.py``).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")  # without torch the whole module skips

import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro.data import make_batch_for as jmake_batch
from repro.kernels import ops as jops
from repro.models import ExecConfig as JExec
from repro.models import Model as JModel
from repro.train import make_train_step as jmake_step
from repro_torch import configs as tconfigs
from repro_torch import optim as toptim
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import ExecConfig as TExec
from repro_torch.models import TrainModel
from repro_torch.models.convert import params_from_jax
from repro_torch.train import make_train_step as tmake_step

BWD_REL = {"float32": 1e-5, "bfloat16": 1e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# tests/test_torch_kernels.py's flash cases: (B, H, Kh, S, hd, block_q, block_kv)
_FA_CASES = [
    (1, 2, 2, 32, 16, 16, 16),  # MHA
    (2, 4, 2, 64, 32, 32, 16),  # GQA g=2
    (1, 8, 1, 64, 16, 16, 64),  # MQA
    (1, 2, 1, 128, 64, 64, 32),
]


def _pair(seed, shape, dtype):
    x = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def _rel(got, want) -> float:
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    w = want.float().numpy() if isinstance(want, torch.Tensor) else np.asarray(want, np.float32)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _port_grads(tq, tk, tv, tg, causal, bq, bkv):
    """The forward's plain version with its lse, then the backward's plain
    version; q and g in the model's (B,Sq,H,hd) layout."""
    o, lse = tfa.flash_attention_fwd(tq.transpose(1, 2), tk, tv, causal=causal, block_q=bq,
                                     block_kv=bkv, interpret=True, return_lse=True)
    dq, dk, dv = tfa.flash_attention_bwd_plain(tq.transpose(1, 2), tk, tv, o, lse, tg.transpose(1, 2),
                                               causal=causal, block_q=bq, block_kv=bkv)
    return dq.transpose(1, 2), dk, dv


@pytest.mark.parametrize("B,H,Kh,S,hd,bq,bkv", _FA_CASES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_plain_matches_jax_vjp(dtype, causal, B, H, Kh, S, hd, bq, bkv):
    jq, tq = _pair(20, (B, S, H, hd), dtype)
    jk, tk = _pair(21, (B, Kh, S, hd), dtype)
    jv, tv = _pair(22, (B, Kh, S, hd), dtype)
    jg, tg = _pair(23, (B, S, H, hd), dtype)
    _, vjp = jax.vjp(lambda q, k, v: jops.flash_attention(q, k, v, causal=causal, block_q=bq, block_kv=bkv,
                                                          interpret=True), jq, jk, jv)
    want = vjp(jg)
    got = _port_grads(tq, tk, tv, tg, causal, bq, bkv)
    for name, g_, w_, t_ in zip(("dq", "dk", "dv"), got, want, (tq, tk, tv)):
        assert g_.dtype == t_.dtype and g_.shape == t_.shape, name
        assert _rel(g_, w_) <= BWD_REL[dtype], (name, _rel(g_, w_))


@pytest.mark.parametrize("Sq,Skv", [(32, 64), (64, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_plain_unequal_lengths_causal_matches_autograd(dtype, Sq, Skv):
    """Causal Sq != Skv (top-left mask, as the kernels): against torch
    autograd through ``flash_attention_plain`` in fp32 arithmetic."""
    B, H, Kh, hd, bq, bkv = 1, 4, 2, 32, 16, 16
    _, tq = _pair(30, (B, Sq, H, hd), dtype)
    _, tk = _pair(31, (B, Kh, Skv, hd), dtype)
    _, tv = _pair(32, (B, Kh, Skv, hd), dtype)
    _, tg = _pair(33, (B, Sq, H, hd), dtype)
    leaves = [t.float().clone().requires_grad_(True) for t in (tq, tk, tv)]
    o = tfa.flash_attention_plain(leaves[0].transpose(1, 2), leaves[1], leaves[2], causal=True, block_q=bq,
                                  block_kv=bkv)
    want = torch.autograd.grad(o, leaves, tg.float().transpose(1, 2))
    got = _port_grads(tq, tk, tv, tg, True, bq, bkv)
    for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        assert _rel(g_, w_) <= BWD_REL[dtype], (name, _rel(g_, w_))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_gradient_through_strided_views_matches_jax(dtype):
    """q, k and v as ``attn_apply`` hands them in (k and v transposed views
    of (B,S,Kh,hd) projections), through ``ops.flash_attention`` under
    autograd: the gradients match the JAX package's and come back in the
    inputs' layouts."""
    B, S, H, Kh, hd, bq, bkv = 2, 64, 4, 2, 32, 32, 16
    jq, tq = _pair(40, (B, S, H, hd), dtype)
    jk, tk = _pair(41, (B, S, Kh, hd), dtype)
    jv, tv = _pair(42, (B, S, Kh, hd), dtype)
    jg, tg = _pair(43, (B, S, H, hd), dtype)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    k_view, v_view = leaves[1].transpose(1, 2), leaves[2].transpose(1, 2)
    assert not k_view.is_contiguous()
    out = tops.flash_attention(leaves[0], k_view, v_view, causal=True, block_q=bq, block_kv=bkv, interpret=True)
    out.backward(tg)
    _, vjp = jax.vjp(lambda q, k, v: jops.flash_attention(q, k, v, causal=True, block_q=bq, block_kv=bkv,
                                                          interpret=True),
                     jq, jk.transpose(0, 2, 1, 3), jv.transpose(0, 2, 1, 3))
    jdq, jdk, jdv = vjp(jg)
    for name, leaf, w_ in zip(("dq", "dk", "dv"), leaves, (jdq, jdk.transpose(0, 2, 1, 3),
                                                          jdv.transpose(0, 2, 1, 3))):
        assert leaf.grad.dtype == leaf.dtype and leaf.grad.shape == leaf.shape, name
        assert _rel(leaf.grad, w_) <= BWD_REL[dtype], (name, _rel(leaf.grad, w_))
    o, lse = tfa.flash_attention_fwd(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
                                     block_q=bq, block_kv=bkv, interpret=True, return_lse=True)
    grads = tfa.flash_attention_bwd(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2), o, lse,
                                    tg.transpose(1, 2), block_q=bq, block_kv=bkv, interpret=True)
    for g_, t_ in zip(grads, (tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2))):
        assert g_.stride() == t_.stride()


@pytest.mark.parametrize("causal,Sq,Skv", [(True, 64, 64), (False, 64, 64), (True, 32, 64), (True, 64, 32)])
def test_plain_forward_lse_is_the_logsumexp_of_the_scaled_scores(causal, Sq, Skv):
    B, H, Kh, hd = 2, 4, 2, 16
    _, tq = _pair(50, (B, H, Sq, hd), "float32")
    _, tk = _pair(51, (B, Kh, Skv, hd), "float32")
    _, tv = _pair(52, (B, Kh, Skv, hd), "float32")
    o, lse = tfa.flash_attention_fwd(tq, tk, tv, causal=causal, block_q=16, block_kv=16, interpret=True,
                                     return_lse=True)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    assert torch.equal(o, tfa.flash_attention_fwd(tq, tk, tv, causal=causal, block_q=16, block_kv=16,
                                                  interpret=True))
    s = tq @ tk.repeat_interleave(H // Kh, dim=1).transpose(-1, -2) / math.sqrt(hd)
    if causal:  # top-left: row i sees keys 0..i
        s = s.masked_fill(~torch.ones(Sq, Skv, dtype=torch.bool).tril(), -math.inf)
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ["qwen2_7b", "seamless_m4t_large_v2"])
def test_train_step_runs_no_flash_oracle(arch, monkeypatch):
    """One ``make_train_step`` step of a tiny model on the kernel path with
    ``ref.flash_attention_ref`` replaced by a function that raises: the
    backward runs ``flash_attention_bwd_plain`` (counted) and the step's
    loss, gradient norm, ce and aux equal the JAX package's at 1e-5."""
    def refuse(*a, **k):
        raise AssertionError("the flash backward ran the oracle")

    calls = []
    plain = tfa.flash_attention_bwd_plain

    def counted(*a, **k):
        calls.append(k["causal"])
        return plain(*a, **k)

    monkeypatch.setattr(tref, "flash_attention_ref", refuse)
    monkeypatch.setattr(tfa, "flash_attention_bwd_plain", counted)
    jcfg = dataclasses.replace(jconfigs.get_tiny(arch), compute_dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_tiny(arch), compute_dtype="float32")
    jinit = JModel(jconfigs.get_tiny(arch)).init(jax.random.PRNGKey(0))
    tm = TrainModel(tcfg, TExec(attn_impl="cuda", interpret=True), device="cpu")
    tm.load_state_dict(params_from_jax(tcfg, jinit))
    jopt, topt = joptim.AdamW(lr=1e-3), toptim.AdamW(lr=1e-3)
    params = tm.params()
    jb = jmake_batch(jcfg, 2, 16, 0, 0)
    _, _, jmet = jax.jit(jmake_step(JModel(jcfg, JExec()), jopt))(jinit, jopt.init(jinit), jb)
    _, _, met = tmake_step(tm, topt)(params, topt.init(params),
                                     {k: torch.from_numpy(np.array(v)) for k, v in jb.items()})
    for k in ("loss", "grad_norm", "ce", "aux"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    causal = sum(1 for kind in tcfg.pattern if kind in ("attn", "cross")) if tcfg.window == 0 else 0
    assert sorted(calls) == sorted([True] * causal + [False] * tcfg.enc_layers) and calls
