"""The port's scan kernels (RG-LRU and RWKV-6 WKV) against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.  On the
CPU the port's wrappers run their plain versions (``interpret=True``), held
against the JAX package's Pallas kernels in ``interpret=True`` mode and
against the per-token oracles of both packages.  Tolerances (atol = rtol,
compared in fp32): against the oracles fp32 1e-5 (the same recurrence
summed in another order), bf16 3e-2 for lru and 5e-2 for rwkv (the JAX
tests' bf16 limits); against the JAX rwkv kernel, whose chunked
log-space form differs from the per-token recurrence by more than fp32
rounding, the JAX test's own fp32 limit 5e-4.  The CUDA kernels themselves
are tested on the card by ``test_torch_cuda.py``.
"""
from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")  # without torch the whole module skips

import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro import tuning as jtuning
from repro_torch import tuning as ttuning
from repro_torch.kernels import linear_scan as tls
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.autotuned import roofline

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
jat = import_module("repro.kernels.autotuned")
tat = import_module("repro_torch.kernels.autotuned")
ORACLE_TOL = {"lru": {"float32": 1e-5, "bfloat16": 3e-2},
              "rwkv": {"float32": 1e-5, "bfloat16": 5e-2}}
JAX_RWKV_KERNEL_TOL = {"float32": 5e-4, "bfloat16": 5e-2}


def _np(seed, shape, fn=None):
    x = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
    return fn(x) if fn is not None else x


def _pair(x, dtype):
    """The same values as a JAX array and a torch tensor (bf16 rounds alike)."""
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def _close(got, want, tol):
    g = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    w = want.float().numpy() if isinstance(want, torch.Tensor) else np.asarray(want, np.float32)
    np.testing.assert_allclose(g, w, atol=tol, rtol=tol)


# ------------------------------------------------------------------ rwkv scan
def _rwkv_inputs(B, T, H, hd, dtype, seed=4):
    raw = [_np(seed + i, (B, T, H, hd)) for i in range(3)]
    raw.append(-np.exp(_np(seed + 3, (B, T, H, hd))))  # log decay <= 0
    raw.append(_np(seed + 4, (H, hd)))
    j = [_pair(x, dtype) for x in raw]
    s0 = _np(seed + 5, (B, H, hd, hd))
    return ([p[0] for p in j] + [jnp.asarray(s0)], [p[1] for p in j] + [torch.from_numpy(s0)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [8, 16, 32])
@pytest.mark.parametrize("B,T,H,hd", [(1, 32, 2, 8), (2, 64, 2, 16), (1, 64, 1, 32)])
def test_rwkv_plain_matches_jax_kernel_and_oracles(dtype, chunk, B, T, H, hd):
    jargs, targs = _rwkv_inputs(B, T, H, hd, dtype)
    y, sT = tops.rwkv_scan(*targs, chunk=chunk, interpret=True)
    assert y.dtype == TDT[dtype] and sT.dtype == torch.float32
    assert y.shape == (B, T, H, hd) and sT.shape == (B, H, hd, hd)
    tol = ORACLE_TOL["rwkv"][dtype]
    for yw, sw in (tref.rwkv_scan_ref(*targs), jref.rwkv_scan_ref(*jargs)):
        _close(y, yw, tol)
        _close(sT, sw, tol)
    yk, sk = jops.rwkv_scan(*jargs, chunk=chunk, interpret=True)
    _close(y, yk, JAX_RWKV_KERNEL_TOL[dtype])
    _close(sT, sk, JAX_RWKV_KERNEL_TOL[dtype])


@pytest.mark.parametrize("chunk", [16, 32])
def test_rwkv_strong_decay_stays_finite(chunk):
    B, T, H, hd = 1, 32, 1, 8
    jargs, targs = _rwkv_inputs(B, T, H, hd, "float32", seed=5)
    targs[3] = torch.full((B, T, H, hd), -14.0)
    jargs[3] = jnp.full((B, T, H, hd), -14.0)
    targs[5] = torch.zeros(B, H, hd, hd)
    jargs[5] = jnp.zeros((B, H, hd, hd))
    y, _ = tops.rwkv_scan(*targs, chunk=chunk, interpret=True)
    assert bool(torch.isfinite(y).all())
    _close(y, tref.rwkv_scan_ref(*targs)[0], 1e-5)
    _close(y, jref.rwkv_scan_ref(*jargs)[0], 1e-5)
    _close(y, jops.rwkv_scan(*jargs, chunk=chunk, interpret=True)[0], 1e-4)


# ------------------------------------------------------------------- lru scan
def _lru_inputs(B, T, D, dtype):
    a = _np(6, (B, T, D), lambda x: 1.0 / (1.0 + np.exp(-x)))
    jb, tb = _pair(_np(7, (B, T, D)), dtype)
    h0 = _np(8, (B, D))
    ja, ta = _pair(a.astype(np.float32), dtype)
    return (ja, jb, jnp.asarray(h0)), (ta, tb, torch.from_numpy(h0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk,block_d", [(16, 16), (32, 32), (64, 16), (16, 8)])
def test_lru_plain_matches_jax_kernel_and_oracles(dtype, chunk, block_d):
    B, T, D = 2, 64, 32
    jargs, targs = _lru_inputs(B, T, D, dtype)
    hs, hT = tops.lru_scan(*targs, chunk=chunk, block_d=block_d, interpret=True)
    assert hs.dtype == TDT[dtype] and hT.dtype == torch.float32 and hT.shape == (B, D)
    tol = ORACLE_TOL["lru"][dtype]
    for hw, hTw in (tref.lru_scan_ref(*targs), jref.lru_scan_ref(*jargs),
                    jops.lru_scan(*jargs, chunk=chunk, interpret=True)):
        _close(hs, hw, tol)
        _close(hT, hTw, tol)


def test_lru_block_d_reaches_the_kernel():
    """The JAX wrapper drops ``block_d``; the port's passes it through, so a
    channel block that does not divide D, or that the kernel cannot hold, is
    refused (the tuner charges such a knob ``inf``)."""
    _, (a, b, h0) = _lru_inputs(2, 64, 32, "float32")
    with pytest.raises(ValueError, match="block_d=24"):
        tops.lru_scan(a, b, h0, chunk=16, block_d=24, interpret=True)
    with pytest.raises(ValueError, match="chunk=48"):
        tops.lru_scan(a, b, h0, chunk=48, interpret=True)
    with pytest.raises(ValueError, match="block_d=2048"):
        tls.check_lru(16, 2048)
    with pytest.raises(ValueError, match="shared memory"):
        tls.check_lru(256, 128)
    tls.check_lru(128, 128)
    with pytest.raises(ValueError, match="head dim 128"):
        tls.check_rwkv(16, 128)
    with pytest.raises(ValueError, match="shared memory"):
        tls.check_rwkv(256, 64)
    try:
        tls.check_lru(256, 128)
    except ValueError as e:
        assert tat.classify_failure(e) == "illegal"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,chunk,segments", [
    (64, 16, 1), (64, 16, 2), (64, 8, 4), (64, 4, 16), (96, 32, 3), (64, 1, 64),
])
def test_lru_segmented_form_matches_jax_kernel_and_oracles(dtype, T, chunk, segments):
    """The kernel's segmented arithmetic (per-segment product and state,
    carries chained segment after segment, a rescan from each carry) against
    the oracles and the JAX kernel at the chunk whose whole multiples make
    the segments: one segment, two, many, a chunk that divides the segment
    (64 / 4 = 16 = 2 chunks of 8) and segments of one step."""
    B, D = 2, 32
    assert (T // chunk) % segments == 0
    jargs, targs = _lru_inputs(B, T, D, dtype)
    hs, hT = tls.lru_scan_segmented_plain(*targs, segments=segments)
    assert hs.dtype == TDT[dtype] and hT.dtype == torch.float32 and hT.shape == (B, D)
    tol = ORACLE_TOL["lru"][dtype]
    for hw, hTw in (tref.lru_scan_ref(*targs), jref.lru_scan_ref(*jargs),
                    jops.lru_scan(*jargs, chunk=chunk, interpret=True)):
        _close(hs, hw, tol)
        _close(hT, hTw, tol)


def test_lru_segmented_form_refuses_uneven_segments():
    _, (a, b, h0) = _lru_inputs(1, 64, 8, "float32")
    with pytest.raises(ValueError, match="segments"):
        tls.lru_scan_segmented_plain(a, b, h0, segments=3)


def test_lru_segments_is_a_pure_function_of_the_shape_and_the_sm_count():
    """The segment count is derived, not tuned: the same shape and SM count
    give the same count; it divides the chunk count, a segment's staged
    a and b fit the block's shared memory, and the grid gives every SM two
    blocks or more where the steps allow it."""
    served = [tls.lru_segments(8, 2048, 2560, c, 128, 4, 132) for c in (4, 16, 32, 64, 128)]
    assert served == [32, 32, 32, 32, 16]  # 64 steps a segment; chunk 128 holds 128
    assert tls.lru_segments(8, 2048, 2560, 4, 128, 2, 132) == 16  # bf16 stages half the bytes
    for args in [(8, 2048, 2560, 4, 128, 4, 132), (2, 64, 96, 16, 32, 4, 132),
                 (1, 128, 256, 16, 128, 2, 132), (1, 4096, 64, 16, 64, 4, 78)]:
        n = tls.lru_segments(*args)
        assert n == tls.lru_segments(*args)
        B, T, D, chunk, bd, itemsize, sms = args
        assert (T // chunk) % n == 0
        assert 2 * (T // n) * bd * itemsize + tls.LRU_FIXED_BYTES <= tls.SMEM_LIMIT
        assert n == T // chunk or B * (D // bd) * n >= tls.LRU_BLOCKS_PER_SM * sms
    # more SMs never mean fewer segments; a short sequence runs a chunk a segment
    assert tls.lru_segments(1, 4096, 64, 16, 64, 4, 264) >= tls.lru_segments(1, 4096, 64, 16, 64, 4, 78)
    assert tls.lru_segments(1, 64, 32, 16, 32, 4, 132) == 4


def test_lru_illegal_knobs_raise_before_any_launch():
    """Knobs the kernel cannot run raise ``ValueError`` from the wrapper's
    legality check, before it looks at the device: a one-chunk segment over
    the block's shared memory (in the input dtype) or more channels than
    threads.  The JAX legality (chunk divides T, block_d divides D) holds
    everywhere."""
    _, (a, b, h0) = _lru_inputs(1, 256, 256, "float32")
    with pytest.raises(ValueError, match="shared memory"):
        tops.lru_scan(a, b, h0, chunk=256, block_d=256)
    with pytest.raises(ValueError, match="chunk=96"):
        tops.lru_scan(a, b, h0, chunk=96)
    assert tls.launches == {"lru_scan": 0, "rwkv_scan": 0}
    assert tls.lru_smem_bytes(256, 128, 4) > tls.SMEM_LIMIT >= tls.lru_smem_bytes(256, 128, 2)
    tls.check_lru(256, 128, itemsize=2)
    assert tls.legal_lru(2048, 2560, 4, 128, on_card=True) == (4, 128)
    assert tls.lru_channels_per_thread(2560, 128, True) == 4
    assert tls.lru_channels_per_thread(2560, 128, False) == 1
    assert tls.lru_channels_per_thread(96, 6, True) == 1


def test_scan_wrappers_refuse_cpu_tensors_without_interpret():
    _, (a, b, h0) = _lru_inputs(1, 16, 8, "float32")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.lru_scan(a, b, h0, chunk=16)
    _, targs = _rwkv_inputs(1, 16, 1, 8, "float32")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.rwkv_scan(*targs, chunk=16)
    assert tls.launches == {"lru_scan": 0, "rwkv_scan": 0}


def test_scan_gradients_follow_the_oracles():
    _, (a, b, h0) = _lru_inputs(1, 16, 8, "float32")
    leaves = [t.clone().requires_grad_(True) for t in (a, b, h0)]
    hs, hT = tops.lru_scan(*leaves, chunk=8, interpret=True)
    g = torch.autograd.grad((hs.sum() + hT.sum()), leaves)
    ref_leaves = [t.clone().requires_grad_(True) for t in (a, b, h0)]
    rs, rT = tref.lru_scan_ref(*ref_leaves)
    gw = torch.autograd.grad((rs.sum() + rT.sum()), ref_leaves)
    for x, w in zip(g, gw):
        _close(x, w, 1e-5)
    _, targs = _rwkv_inputs(1, 8, 1, 8, "float32")
    leaves = [t.clone().requires_grad_(True) for t in targs]
    y, sT = tops.rwkv_scan(*leaves, chunk=4, interpret=True)
    g = torch.autograd.grad(y.square().sum() + sT.sum(), leaves)
    ref_leaves = [t.clone().requires_grad_(True) for t in targs]
    yw, sw = tref.rwkv_scan_ref(*ref_leaves)
    gw = torch.autograd.grad(yw.square().sum() + sw.sum(), ref_leaves)
    for x, w in zip(g, gw):
        _close(x, w, 1e-5)


# --------------------------------------------------------- registry + bounds
@pytest.mark.parametrize("name", ["lru_scan", "rwkv_scan"])
def test_registry_keys_and_defaults_equal_jax(name):
    if name == "lru_scan":
        jargs, targs = _lru_inputs(2, 64, 32, "float32")
    else:
        jargs, targs = _rwkv_inputs(2, 64, 2, 16, "float32")
    jspace = jat.get_spec(name).space(*jargs)
    tspace = tat.get_spec(name).space(*targs)
    jkey = jtuning.make_key(name, args=jargs, space=jspace, extra={"interpret": True},
                            backend="cpu", device_kind="cpu")
    tkey = ttuning.make_key(name, args=targs, space=tspace, extra={"interpret": True},
                            backend="cpu", device_kind="cpu")
    assert tkey.encode() == jkey.encode()
    assert tat.get_spec(name).defaults(*targs) == jat.get_spec(name).defaults(*jargs)


def test_roofline_names_the_arithmetic_dtype():
    """The scans compute in fp32 on the CUDA cores whatever their inputs'
    dtype, so their bound uses the fp32 peak; the matmul and flash bounds
    keep the input dtype's (tensor-core) peak."""
    meta = dict(device="meta")
    a = torch.empty(8, 2048, 2560, **meta)
    lru = roofline("lru_scan", a, a, torch.empty(8, 2560, **meta))
    assert lru.dominant == "bytes"
    assert lru.bytes_accessed == 3 * 8 * 2048 * 2560 * 4 + 2 * 8 * 2560 * 4
    assert abs(lru.bound_s * 1e3 - 0.150) < 0.002
    r = torch.empty(8, 2048, 64, 64, dtype=torch.bfloat16, **meta)
    lw = torch.empty(8, 2048, 64, 64, **meta)
    rw = roofline("rwkv_scan", r, r, r, lw, torch.empty(64, 64, **meta),
                  torch.empty(8, 64, 64, 64, **meta))
    assert rw.dominant == "operations"
    assert rw.flops == 5.0 * 8 * 2048 * 64 * 64 * 64
    assert abs(rw.bound_s * 1e3 - rw.flops / 67e12 * 1e3) < 1e-9  # fp32 CUDA-core peak
    assert abs(rw.bound_s * 1e3 - 0.3205) < 0.001
    # unchanged for the kernels of the first slice: bf16 inputs, tensor-core peak
    x = torch.empty(4096, 3584, dtype=torch.bfloat16, **meta)
    w = torch.empty(3584, 18944, dtype=torch.bfloat16, **meta)
    mm = roofline("matmul", x, w)
    assert mm.flops == 2.0 * 4096 * 3584 * 18944
    assert abs(mm.bound_s - mm.flops / 989e12) < 1e-12


# ------------------------------------- the tensor-core design's decomposition
@pytest.mark.parametrize("T", [16, 48])
@pytest.mark.parametrize("B,H,hd", [(1, 2, 16), (2, 1, 64)])
def test_rwkv_subchunk_form_matches_oracles_and_jax_kernel(T, B, H, hd):
    """The 16-token sub-chunked form (inter product, exact per-channel intra
    scores, state update) against the per-token oracles: the state at their
    fp32 limit 1e-5, y at the JAX chunked kernel's 5e-4 (y's 64-term sums
    cancel to far below their terms, and the chunk form rounds them in
    another order)."""
    jargs, targs = _rwkv_inputs(B, T, H, hd, "float32", seed=9)
    y, sT = tls.rwkv_scan_subchunk_plain(*targs)
    assert y.dtype == torch.float32 and sT.shape == (B, H, hd, hd)
    for yw, sw in (tref.rwkv_scan_ref(*targs), jref.rwkv_scan_ref(*jargs)):
        _close(y, yw, JAX_RWKV_KERNEL_TOL["float32"])
        _close(sT, sw, ORACLE_TOL["rwkv"]["float32"])
    yk, sk = jops.rwkv_scan(*jargs, chunk=16, interpret=True)
    _close(y, yk, JAX_RWKV_KERNEL_TOL["float32"])
    _close(sT, sk, JAX_RWKV_KERNEL_TOL["float32"])


@pytest.mark.parametrize("T", [16, 48])
def test_rwkv_subchunk_form_strong_decay_and_bf16(T):
    """lw = -14 underflows the decay of every earlier token to 0 without an
    overflow (no exponent is positive); bf16 inputs give y in bf16."""
    B, H, hd = 1, 2, 64
    jargs, targs = _rwkv_inputs(B, T, H, hd, "float32", seed=10)
    targs[3] = torch.full((B, T, H, hd), -14.0)
    jargs[3] = jnp.full((B, T, H, hd), -14.0)
    y, sT = tls.rwkv_scan_subchunk_plain(*targs)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(sT).all())
    yw, sw = tref.rwkv_scan_ref(*targs)
    _close(y, yw, 1e-5)
    _close(sT, sw, 1e-5)
    _close(y, jops.rwkv_scan(*jargs, chunk=16, interpret=True)[0], 1e-4)
    jb, tb = _rwkv_inputs(B, T, H, hd, "bfloat16", seed=11)
    yb, sb = tls.rwkv_scan_subchunk_plain(*tb)
    assert yb.dtype == torch.bfloat16
    ywb, swb = jref.rwkv_scan_ref(*jb)
    _close(yb, ywb, ORACLE_TOL["rwkv"]["bfloat16"])
    _close(sb, swb, 1e-5)


def test_rwkv_design_names_the_kernel_that_runs():
    """bf16 at head dim 64 where T is a multiple of max(chunk, 16) takes the
    tensor-core design, the serving prefill's chunk=4 included; the rest
    keeps the per-token kernel, whose knob check then applies."""
    assert tls.rwkv_design(2, 64, 2048, 4) == "tc"  # rwkv6-7b's served prefill
    assert [tls.rwkv_design(2, 64, 2048, c) for c in (16, 32, 64, 128)] == ["tc"] * 4
    assert tls.rwkv_design(4, 64, 2048, 16) == "per_token"  # fp32
    assert tls.rwkv_design(2, 32, 2048, 16) == "per_token"
    assert tls.rwkv_design(2, 64, 8, 4) == "per_token"  # T not a multiple of 16
    assert tls.rwkv_design(2, 64, 48, 32) == "per_token"  # 48 not a multiple of 32
    assert tls.rwkv_design(2, 64, 2048, 16, aligned=False) == "per_token"
    assert tls.rwkv_design(2, 64, 4096, 256) == "per_token"  # ring over a block's memory
    assert tls.rwkv_tc_smem_bytes(4) == tls.rwkv_tc_smem_bytes(16) < tls.SMEM_LIMIT // 4
    assert tls.rwkv_tc_smem_bytes(128) <= tls.SMEM_LIMIT
    # the check follows the design: chunk 256 fits neither kernel at hd 64
    assert tls.legal_rwkv(2048, 64, 128, on_card=True, itemsize=2) == 128
    with pytest.raises(ValueError, match="shared memory"):
        tls.legal_rwkv(4096, 64, 256, on_card=True, itemsize=2)
    assert tls.launches_by_design == {"tc": 0, "per_token": 0}
