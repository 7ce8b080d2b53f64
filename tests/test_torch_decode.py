"""The port's decode attention (plain version, registry entry, pretune
cases) against the JAX package's Pallas kernel in interpret mode and its
``ref.py`` oracle, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
plain version repeats the kernel's arithmetic (fp32 m/l/acc and p), so it
is held against the JAX kernel at fp32 rounding (1e-5; bf16 outputs within
one bf16 rounding step, 8e-3 at |o| < 2) and against the oracle, which
rounds p to v's dtype before P·V, at the JAX test's ``_tol``.
"""
import math
import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.tuning as jtuning
import repro_torch.tuning as ttuning
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.autotuned import get_spec as jget_spec
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.autotuned import get_spec, roofline
from repro_torch.tuning import pretune as tpretune

DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: plain version vs the JAX kernel: the same fp32 arithmetic; bf16 adds the
#: output rounding of both (one bf16 step below magnitude 2)
VS_KERNEL = {"float32": 1e-5, "bfloat16": 8e-3}
#: vs the oracle: tests/test_kernels.py's _tol
VS_ORACLE = {"float32": 2e-4, "bfloat16": 2e-2}


def _np(seed, shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def _inputs(dtype, B, H, Kh, S, hd, valid, seed=0):
    jdt, tdt = DT[dtype]
    arrays = [_np(seed, (B, H, hd)), _np(seed + 1, (B, Kh, S, hd)), _np(seed + 2, (B, Kh, S, hd))]
    valid = np.asarray(valid, np.int32)
    jargs = [jnp.asarray(x, jdt) for x in arrays] + [jnp.asarray(valid)]
    targs = [torch.from_numpy(x).to(tdt) for x in arrays] + [torch.from_numpy(valid)]
    return jargs, targs


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _t2np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bkv", [16, 64, 128])
@pytest.mark.parametrize("length", [1, 37, 128])
def test_plain_matches_jax_kernel_and_oracle(dtype, bkv, length):
    B, H, Kh, S, hd = 2, 4, 2, 128, 32
    valid = (np.arange(S) < length).astype(np.int32)[None].repeat(B, 0)
    jargs, targs = _inputs(dtype, B, H, Kh, S, hd, valid, seed=2)
    want = jops.decode_attention(*jargs, block_kv=bkv, interpret=True)
    got = tops.decode_attention(*targs, block_kv=bkv, interpret=True)
    assert got.dtype == targs[0].dtype and got.shape == (B, H, hd)
    _close(_t2np(got), want, VS_KERNEL[dtype])
    _close(_t2np(got), jref.decode_attention_ref(*jargs[:3], length), VS_ORACLE[dtype])
    _close(_t2np(tref.decode_attention_ref(*targs[:3], length)),
           jref.decode_attention_ref(*jargs[:3], length), VS_KERNEL[dtype])


@pytest.mark.parametrize("H,Kh,S,hd,bkv", [
    (1, 1, 64, 16, 16),  # g = 1
    (4, 2, 64, 32, 32),  # g = 2
    (14, 2, 128, 64, 64),  # g = 7, as qwen2-7b's 28/4
    (10, 1, 64, 256, 16),  # g = 10 at hd 256, as recurrentgemma-2b's MQA
])
def test_ring_validity_and_gqa_groups(H, Kh, S, hd, bkv):
    """Scattered validity (ring buffers), several groups and head dims."""
    B = 2
    valid = (np.random.RandomState(5).uniform(size=(B, S)) < 0.5).astype(np.int32)
    valid[:, 3] = 1
    jargs, targs = _inputs("float32", B, H, Kh, S, hd, valid, seed=7)
    want = jops.decode_attention(*jargs, block_kv=bkv, interpret=True)
    got = tops.decode_attention(*targs, block_kv=bkv, interpret=True)
    _close(_t2np(got), want, VS_KERNEL["float32"])


def test_all_invalid_row_is_the_mean_of_v():
    """No valid slot: the finite -1e30 makes every p = 1, so the row
    averages V (not 0, not NaN), as the JAX kernel and oracle do."""
    B, H, Kh, S, hd = 2, 4, 2, 64, 16
    valid = np.ones((B, S), np.int32)
    valid[1] = 0
    jargs, targs = _inputs("float32", B, H, Kh, S, hd, valid, seed=3)
    got = tops.decode_attention(*targs, block_kv=16, interpret=True)
    assert torch.isfinite(got).all()
    mean_v = targs[2][1].mean(dim=1).repeat_interleave(H // Kh, dim=0)  # (H, hd)
    torch.testing.assert_close(got[1], mean_v, atol=1e-5, rtol=1e-5)
    _close(_t2np(got), jops.decode_attention(*jargs, block_kv=16, interpret=True), 1e-5)


def test_wrapper_checks():
    _, (q, k, v, valid) = _inputs("float32", 1, 2, 1, 48, 16, np.ones((1, 48)))
    with pytest.raises(ValueError, match="not divisible"):
        tops.decode_attention(q, k, v, valid, block_kv=32, interpret=True)
    with pytest.raises(ValueError, match="CUDA"):
        tops.decode_attention(q, k, v, valid, block_kv=16)  # no interpret: kernel only
    # block_kv is clamped to the cache length, as in the JAX wrapper
    torch.testing.assert_close(tops.decode_attention(q, k, v, valid, block_kv=1024, interpret=True),
                               tops.decode_attention(q, k, v, valid, block_kv=48, interpret=True))


def test_illegal_tiles_are_refused_by_the_knob_check():
    """On the card every point of the space runs or is refused before launch."""
    tda.check_tile(7, 128, 1024)  # qwen2-7b: the whole JAX space runs
    tda.check_tile(10, 256, 1024)  # recurrentgemma-2b MQA
    tda.check_tile(64, 128, 1024)  # g = 64 runs as eight blocks of eight heads
    with pytest.raises(ValueError, match="block_kv=8192.*shared memory"):
        tda.check_tile(64, 128, 8192)  # beyond the space: 8 x 8192 fp32 scores and the ring
    with pytest.raises(ValueError, match="head dim"):
        tda.check_tile(1, 96, 64)
    q, k = torch.empty(1, 64, 128, device="meta"), torch.empty(1, 1, 4096, 128, device="meta")
    assert tda.default_block_kv(q, k) == 512  # a block holds at most 8 heads' score tiles
    assert tda.smem_bytes(8, 128, 8192) > tda.SMEM_LIMIT >= tda.smem_bytes(8, 128, 4096)
    q, k = torch.empty(8, 28, 128, device="meta"), torch.empty(8, 4, 32768, 128, device="meta")
    assert tda.default_block_kv(q, k) == 512  # the JAX default where the card runs it


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [128, 96, 4096])
def test_registry_key_and_space_equal_jax(dtype, S):
    B, H, Kh, hd = 2, 4, 2, 16
    jargs, targs = _inputs(dtype, B, H, Kh, S, hd, np.ones((B, S)))
    jspace, tspace = jget_spec("decode_attention").space(*jargs), get_spec("decode_attention").space(*targs)
    jkey = jtuning.make_key("decode_attention", args=jargs, space=jspace, extra={"interpret": True})
    tkey = ttuning.make_key("decode_attention", args=targs, space=tspace, extra={"interpret": True})
    assert tkey.encode() == jkey.encode()
    assert get_spec("decode_attention").defaults(*targs) == jget_spec("decode_attention").defaults(*jargs)


def test_smoke_pretune_exact_hits_the_committed_jax_decode_record(tmp_path, capsys):
    path = tmp_path / "cpu.json"
    shutil.copy("tuned/cpu.json", path)
    jrec = [r for r in jtuning.TuningDB(str(path), autosave=False).records()
            if r.key.name == "decode_attention"]
    assert len(jrec) == 1
    assert tpretune.main(["--interpret", "--smoke", "--kernel", "decode_attention",
                          "--db", str(path)]) == 0
    out = capsys.readouterr().out
    assert "(1 exact hits, 0 searched)" in out
    m = re.search(r"decode_attention/b2h4kh2s128d16: best=(\{[^}]*\})", out)
    assert m and m.group(1) == str(jrec[0].point)


def test_roofline_counts_flops_and_bytes():
    B, H, Kh, S, hd = 8, 28, 4, 32768, 128
    q = torch.empty(B, H, hd, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, Kh, S, hd, dtype=torch.bfloat16, device="meta")
    valid = torch.empty(B, S, dtype=torch.int32, device="meta")
    terms = roofline("decode_attention", q, k, k, valid)
    assert terms.flops == 4.0 * B * H * S * hd
    assert terms.bytes_accessed == 2 * (2 * B * H * hd) + 2 * (2 * B * Kh * S * hd) + 4 * B * S
    assert terms.dominant == "bytes" and math.isclose(terms.bound_s, terms.bytes_accessed / 3.35e12)
    assert math.isclose(terms.compute_s, terms.flops / 67e12)  # fp32 arithmetic on the CUDA cores


# ----------------------------------------------------- split-KV decomposition
@pytest.mark.parametrize("splits", [1, 2, 8])  # 8 = S / block_kv: one tile per split
@pytest.mark.parametrize("H,Kh,hd", [(14, 2, 32), (10, 1, 64)])  # g = 7 (qwen2-7b), 10 (MQA)
def test_split_kv_plain_matches_jax_kernel_and_oracle(splits, H, Kh, hd):
    """The kernel's partial-and-merge form: a valid prefix of 37 slots leaves
    the later splits with no valid slot, which the merge must wipe."""
    B, S, bkv, length = 2, 128, 16, 37
    valid = (np.arange(S) < length).astype(np.int32)[None].repeat(B, 0)
    jargs, targs = _inputs("float32", B, H, Kh, S, hd, valid, seed=11)
    got = tda.decode_attention_plain(*targs, block_kv=bkv, splits=splits)
    _close(_t2np(got), jops.decode_attention(*jargs, block_kv=bkv, interpret=True), VS_KERNEL["float32"])
    _close(_t2np(got), jref.decode_attention_ref(*jargs[:3], length), VS_ORACLE["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", [1, 2, 8])
def test_split_kv_plain_masks(dtype, splits):
    """Rows with no valid slot (mean of V in every split count), a masked
    leading part (whole splits invalid before the valid ones) and scattered
    validity, against the JAX kernel."""
    B, H, Kh, S, hd, bkv = 3, 14, 2, 128, 16, 16
    valid = np.ones((B, S), np.int32)
    valid[0] = 0
    valid[1, :40] = 0
    valid[2] = np.random.RandomState(12).uniform(size=S) < 0.3
    jargs, targs = _inputs(dtype, B, H, Kh, S, hd, valid, seed=13)
    got = tda.decode_attention_plain(*targs, block_kv=bkv, splits=splits)
    assert torch.isfinite(got.float()).all()
    _close(_t2np(got), jops.decode_attention(*jargs, block_kv=bkv, interpret=True), VS_KERNEL[dtype])
    mean_v = targs[2][0].float().mean(dim=1).repeat_interleave(H // Kh, dim=0)
    _close(_t2np(got[0]), mean_v.numpy(), VS_KERNEL[dtype])
    with pytest.raises(ValueError, match="3 splits"):
        tda.decode_attention_plain(*targs, block_kv=bkv, splits=3)


def test_split_count_grid_and_load_width():
    """The pure functions the wrapper launches with: about two blocks per SM
    or more where the tile count allows, every split the same whole tiles."""
    assert [tda.heads_per_block(g) for g in (1, 7, 8, 10, 20, 64)] == [1, 7, 8, 5, 7, 8]
    # qwen2-7b decode on 132 SMs: 32 (row, KV head) pairs, 64 tiles of 512
    assert tda.num_splits(8, 4, 7, 32768, 512, 132) == 16
    assert tda.grid(8, 4, 7, 32768, 512, 132) == (4, 8, 16)
    assert tda.num_splits(8, 4, 7, 32768, 1024, 132) == 16
    # recurrentgemma-2b MQA: two head groups of 5; the tile count caps the splits
    assert tda.grid(8, 1, 10, 2048, 512, 132) == (2, 8, 4)
    assert tda.grid(8, 1, 10, 2048, 64, 132) == (2, 8, 32)
    assert tda.num_splits(1, 1, 1, 64, 64, 132) == 1
    assert tda.num_splits(1, 1, 1, 12 * 64, 64, 6) == 12  # want 12: all 12 tiles
    assert tda.num_splits(2, 1, 1, 12 * 64, 64, 5) == 6  # want 5: the next divisor of 12
    for shape in [(8, 4, 7, 32768, 512), (8, 1, 10, 2048, 64), (3, 2, 3, 96, 32)]:
        n = tda.num_splits(*shape, 132)
        assert (shape[3] // shape[4]) % n == 0
    k = torch.zeros(2, 2, 8, 16, dtype=torch.bfloat16)
    strides = [k.stride(i) for i in range(3)] * 2
    assert tda.load_width((k, k), 2, strides) == 16
    off = torch.zeros(2 * 2 * 8 * 16 + 1, dtype=torch.bfloat16)[1:].view(2, 2, 8, 16)
    assert tda.load_width((off, off), 2, strides) == 2  # 2 bytes off a 16-byte boundary
    wide = torch.zeros(2, 2, 8, 17, dtype=torch.bfloat16)[..., :16]
    assert tda.load_width((wide, wide), 2, [wide.stride(i) for i in range(3)] * 2) == 2
