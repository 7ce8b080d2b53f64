"""The port's kernel modules against the JAX package's Pallas kernels.

Inputs are made with numpy from a seed and handed to both packages.  On the
CPU the port's wrappers run their plain versions (``interpret=True``), held
against ``repro.kernels`` in ``interpret=True`` mode and against the ref.py
oracles of both packages: fp32 at atol=rtol=1e-5, bf16 at 2e-2, compared in
fp32.  The CUDA kernels themselves are tested on the card by
``test_torch_cuda.py``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import GuardTimeout
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.autotuned import autotuned, classify_failure, roofline

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(seed, shape, dtype):
    """The same values as a JAX array and a torch tensor (bf16 rounds alike)."""
    x = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def _close(got, want, dtype):
    g = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    w = want.float().numpy() if isinstance(want, torch.Tensor) else np.asarray(want, np.float32)
    np.testing.assert_allclose(g, w, atol=TOL[dtype], rtol=TOL[dtype])


# --------------------------------------------------------------------- matmul
@pytest.mark.parametrize("bm,bn,bk", [(32, 32, 32), (64, 32, 96), (128, 64, 48)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_plain_matches_jax_kernel_and_refs(dtype, bm, bn, bk):
    ja, ta = _pair(7, (128, 96), dtype)
    jb, tb = _pair(8, (96, 64), dtype)
    got = tops.matmul(ta, tb, bm=bm, bn=bn, bk=bk, interpret=True)
    assert got.dtype == TDT[dtype] and got.shape == (128, 64)
    _close(got, jops.matmul(ja, jb, bm=bm, bn=bn, bk=bk, interpret=True), dtype)
    _close(got, jref.matmul_ref(ja, jb), dtype)
    _close(got, tref.matmul_ref(ta, tb), dtype)


def test_matmul_rejects_tiles_that_do_not_divide():
    a = torch.zeros(64, 48)
    with pytest.raises(ValueError, match="divisible"):
        tmm.matmul_tiled(a, torch.zeros(48, 64), bm=64, bn=64, bk=32, interpret=True)


# ------------------------------------------------------------ flash attention
_FA_CASES = [
    (1, 2, 2, 32, 16, 16, 16),  # MHA
    (2, 4, 2, 64, 32, 32, 16),  # GQA g=2
    (1, 8, 1, 64, 16, 16, 64),  # MQA
    (1, 2, 1, 128, 64, 64, 32),
]


@pytest.mark.parametrize("B,H,Kh,Sq,hd,bq,bkv", _FA_CASES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_jax_kernel_and_refs(dtype, causal, B, H, Kh, Sq, hd, bq, bkv):
    jq, tq = _pair(0, (B, Sq, H, hd), dtype)
    jk, tk = _pair(1, (B, Kh, Sq, hd), dtype)
    jv, tv = _pair(2, (B, Kh, Sq, hd), dtype)
    got = tops.flash_attention(tq, tk, tv, causal=causal, block_q=bq, block_kv=bkv, interpret=True)
    assert got.dtype == TDT[dtype] and got.shape == (B, Sq, H, hd)
    want = jops.flash_attention(jq, jk, jv, causal=causal, block_q=bq, block_kv=bkv, interpret=True)
    _close(got, want, dtype)
    _close(got, jref.flash_attention_ref(jq, jk, jv, causal=causal), dtype)
    _close(got, tref.flash_attention_ref(tq, tk, tv, causal=causal), dtype)


@pytest.mark.parametrize("Sq,Skv,bq,bkv", [(16, 32, 16, 16), (32, 64, 16, 32), (64, 32, 32, 16)])
def test_flash_unequal_lengths_match_jax_kernel_top_left(Sq, Skv, bq, bkv):
    """Sq != Skv: held against the JAX *kernel* only.  The kernels align the
    causal mask top-left (qi >= kj); the ref.py oracles align it bottom-right
    (tril(k=Skv-Sq)) — a known disagreement of the reference (ROADMAP queue
    3), so the oracle is not a check here."""
    jq, tq = _pair(3, (1, Sq, 4, 16), "float32")
    jk, tk = _pair(4, (1, 2, Skv, 16), "float32")
    jv, tv = _pair(5, (1, 2, Skv, 16), "float32")
    got = tops.flash_attention(tq, tk, tv, causal=True, block_q=bq, block_kv=bkv, interpret=True)
    want = jops.flash_attention(jq, jk, jv, causal=True, block_q=bq, block_kv=bkv, interpret=True)
    _close(got, want, "float32")


def test_flash_block_shape_never_changes_the_result():
    _, tq = _pair(6, (1, 64, 2, 16), "float32")
    _, tk = _pair(7, (1, 2, 64, 16), "float32")
    _, tv = _pair(8, (1, 2, 64, 16), "float32")
    base = tops.flash_attention(tq, tk, tv, block_q=64, block_kv=64, interpret=True)
    for bq, bkv in [(16, 16), (16, 64), (32, 16)]:
        got = tops.flash_attention(tq, tk, tv, block_q=bq, block_kv=bkv, interpret=True)
        _close(got, base, "float32")


def test_flash_gradient_matches_jax_grad():
    B, H, Kh, S, hd = 1, 4, 2, 32, 16
    jq, tq = _pair(10, (B, S, H, hd), "float32")
    jk, tk = _pair(11, (B, Kh, S, hd), "float32")
    jv, tv = _pair(12, (B, Kh, S, hd), "float32")
    jw, tw = _pair(13, (B, S, H, hd), "float32")

    def jloss(q, k, v):
        o = jops.flash_attention(q, k, v, causal=True, block_q=16, block_kv=16, interpret=True)
        return jnp.sum(o * jw)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    o = tops.flash_attention(*leaves, causal=True, block_q=16, block_kv=16, interpret=True)
    (o * tw).sum().backward()
    for jg, leaf in zip(jgrads, leaves):
        _close(leaf.grad, jg, "float32")


# ------------------------------------------------------- device and failures
def test_cpu_tensors_without_interpret_raise():
    a, b = torch.zeros(64, 64), torch.zeros(64, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tops.matmul(a, b)
    q, k = torch.zeros(1, 32, 2, 16), torch.zeros(1, 2, 32, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        autotuned("matmul", a, b)


def test_oversized_tiles_raise_before_launch_and_classify_illegal():
    with pytest.raises(ValueError, match="shared memory") as smem:
        tmm.check_tiles(128, 128, 256, itemsize=4)
    with pytest.raises(ValueError, match="accumulators") as threads:
        tmm.check_tiles(256, 256, 256, itemsize=2)
    with pytest.raises(ValueError, match="shared memory") as fa_smem:
        tfa.check_blocks(128, 128, 512, itemsize=2)
    with pytest.raises(ValueError, match="threads") as fa_threads:
        tfa.check_blocks(128, 256, 64, itemsize=2)
    for e in (smem, threads, fa_smem, fa_threads):
        assert classify_failure(e.value) == "illegal"
    tmm.check_tiles(128, 128, 32, itemsize=2)  # the defaults fit
    tfa.check_blocks(128, 128, 128, itemsize=2)


@pytest.mark.parametrize("msg", [
    "CUDA error 1: too many resources requested for launch",
    "CUDA error 9: invalid configuration argument",
    "kernel needs 262144 bytes of shared memory (max 232448)",
])
def test_classify_failure_calls_cuda_refusals_illegal(msg):
    assert classify_failure(RuntimeError(msg)) == "illegal"
    assert classify_failure(GuardTimeout("hung")) == "illegal"
    assert classify_failure(TypeError("unexpected keyword 'tile'")) == "unexpected"


def test_roofline_at_qwen2_7b_width():
    """Analytic bounds at the shapes the main path runs (meta tensors: no
    memory), against the H100 SXM data-sheet peaks."""
    a = torch.empty(4096, 3584, dtype=torch.bfloat16, device="meta")
    b = torch.empty(3584, 18944, dtype=torch.bfloat16, device="meta")
    mm = roofline("matmul", a, b)
    assert mm.flops == 2 * 4096 * 3584 * 18944 and mm.dominant == "operations"
    assert math.isclose(mm.bound_s, 556.2e9 / 989e12, rel_tol=1e-3)
    q = torch.empty(2, 2048, 28, 128, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 4, 2048, 128, dtype=torch.bfloat16, device="meta")
    fa = roofline("flash_attention", q, k, k, causal=True)
    assert math.isclose(fa.flops, 60.15e9, rel_tol=1e-3) and fa.dominant == "operations"
    full = roofline("flash_attention", q, k, k, causal=False)
    assert full.flops > 1.99 * fa.flops
