"""The port's CUDA kernels on the card (``cuda`` marker; each test skips
without a card).  This file imports neither JAX nor ``repro``, so it runs on
a machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernels are held against their plain PyTorch versions on the same
inputs: fp32 at atol=rtol=1e-5 (the same fp32 arithmetic summed in another
order), bf16 at 2e-2 (plus output rounding); decode attention as well.  The scans' bf16 outputs are
held at the JAX tests' bf16 limits (3e-2 lru, 5e-2 rwkv).  The matmul and
flash-attention cases also assert which design ran (``launches_by_design``:
the tensor-core ``wgmma`` kernel or the SIMT one); the ``wgmma`` cases cover
every swizzle width, one and two consumer warpgroups, several turns of the
ring, every instantiated head dim and ``block_kv``, Sq != Skv, GQA and the
strided q that ``ops.flash_attention`` passes.
"""
import json
import math
import re

import numpy as np
import pytest

pytest.importorskip("torch")  # without torch the whole module skips

import torch

from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import linear_scan as tls
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import ops
from repro_torch.kernels.autotuned import autotuned, get_spec, kernel_router, routed, tune_call
from repro_torch.tuning import TuningDB

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _randn(seed, shape, dtype, dev, scale=1.0):
    x = np.random.RandomState(seed).standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(dtype).to(dev)


def _close(got, want):
    tol = TOL[got.dtype]
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(), atol=tol, rtol=tol)


def _ran(counts: dict, before: dict) -> str:
    """The one design whose launch count grew by one since ``before``."""
    (kind,) = [k for k in counts if counts[k] == before[k] + 1]
    assert sum(counts.values()) == sum(before.values()) + 1
    return kind


@pytest.mark.cuda
@pytest.mark.parametrize("bm,bn,bk,bf16_design", [
    (32, 32, 32, "simt"), (64, 32, 96, "simt"), (128, 64, 48, "simt"), (16, 64, 8, "simt"),
    (64, 32, 64, "wgmma"), (128, 64, 32, "wgmma"),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_kernel_matches_plain(dtype, bm, bn, bk, bf16_design):
    dev = _card()
    a = _randn(0, (256, 192), dtype, dev)
    b = _randn(1, (192, 128), dtype, dev, 1.0 / math.sqrt(192))
    before, by_design = tmm.launches, dict(tmm.launches_by_design)
    got = ops.matmul(a, b, bm=bm, bn=bn, bk=bk)
    assert tmm.launches == before + 1 and got.dtype == dtype and got.is_cuda
    assert _ran(tmm.launches_by_design, by_design) == (bf16_design if dtype == torch.bfloat16 else "simt")
    _close(got, tmm.matmul_plain(a, b, bm=bm, bn=bn, bk=bk))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,bm,bn,bk", [
    (256, 1024, 512, 128, 256, 64),  # the default tile; 16 k-tiles over a 4-stage ring
    (512, 1024, 256, 128, 128, 32),  # 32 k-tiles over 8 stages
    (256, 512, 256, 64, 128, 32),  # non-square tiles, one consumer warpgroup
    (256, 512, 256, 128, 64, 64),
    (512, 768, 256, 256, 128, 64),  # two 64-row slices per consumer warpgroup
    (128, 512, 256, 64, 256, 128),  # bk 128: two swizzle rows of A
    (128, 768, 128, 64, 32, 256),  # 64-byte swizzle of B, bk 256
    (128, 96, 64, 64, 16, 16),  # 32-byte swizzles
    (256, 960, 128, 128, 64, 192),  # bk 192, five ring turns
])
def test_matmul_wgmma_matches_plain(M, K, N, bm, bn, bk):
    dev = _card()
    a = _randn(60, (M, K), torch.bfloat16, dev)
    b = _randn(61, (K, N), torch.bfloat16, dev, 1.0 / math.sqrt(K))
    by_design = dict(tmm.launches_by_design)
    got = ops.matmul(a, b, bm=bm, bn=bn, bk=bk)
    assert _ran(tmm.launches_by_design, by_design) == "wgmma"
    _close(got, tmm.matmul_plain(a, b, bm=bm, bn=bn, bk=bk))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,M,K,N,want", [
    (torch.float32, 256, 512, 512, "simt"),  # 128/128/32: fp32 never takes the tensor cores
    (torch.bfloat16, 256, 512, 512, "wgmma"),  # 128/256/64
    (torch.bfloat16, 256, 512, 384, "wgmma"),  # N not a multiple of 256: 128/128/32
    (torch.bfloat16, 256, 96, 512, "wgmma"),  # K not a multiple of 64: 128/128/32
])
def test_matmul_runs_without_knobs_at_every_dtype(dtype, M, K, N, want):
    """ops.matmul without knobs and a cold ``autotuned`` call (the registry's
    defaults) both run, on the design the default tile picks."""
    dev = _card()
    a = _randn(64, (M, K), dtype, dev)
    b = _randn(65, (K, N), dtype, dev, 1.0 / math.sqrt(K))
    by_design = dict(tmm.launches_by_design)
    got = ops.matmul(a, b)
    assert _ran(tmm.launches_by_design, by_design) == want
    bm, bn, bk = tmm.default_tiles(M, N, K, a.element_size())
    _close(got, tmm.matmul_plain(a, b, bm=bm, bn=bn, bk=bk))
    by_design = dict(tmm.launches_by_design)
    got = autotuned("matmul", a, b, db=TuningDB(None))
    assert _ran(tmm.launches_by_design, by_design) == want
    _close(got, tmm.matmul_plain(a, b, **get_spec("matmul").defaults(a, b)))


@pytest.mark.cuda
def test_matmul_misaligned_operand_runs_simt_or_raises_before_launch():
    dev = _card()
    a = _randn(66, (256 * 512 + 1,), torch.bfloat16, dev)[1:].view(256, 512)  # 2 bytes off 16
    b = _randn(67, (512, 512), torch.bfloat16, dev, 1.0 / math.sqrt(512))
    assert a.is_contiguous() and a.data_ptr() % 16 == 2
    by_design = dict(tmm.launches_by_design)
    got = ops.matmul(a, b)  # the default falls back to the tile SIMT runs
    assert _ran(tmm.launches_by_design, by_design) == "simt"
    _close(got, tmm.matmul_plain(a, b, bm=128, bn=128, bk=32))
    before = tmm.launches
    with pytest.raises(ValueError, match="accumulators"):  # a tile only wgmma runs
        ops.matmul(a, b, bm=128, bn=256, bk=64)
    assert tmm.launches == before
    torch.cuda.synchronize()  # the context is still healthy


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Kh,Sq,Skv,hd,bq,bkv,bf16_design", [
    (1, 2, 2, 32, 32, 16, 16, 16, "simt"),
    (2, 4, 2, 64, 64, 32, 32, 16, "simt"),
    (1, 8, 1, 64, 64, 16, 16, 64, "simt"),
    (1, 2, 1, 128, 128, 64, 64, 32, "wgmma"),
    (1, 4, 2, 32, 64, 128, 16, 32, "simt"),  # Sq != Skv: top-left causal alignment
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(dtype, causal, B, H, Kh, Sq, Skv, hd, bq, bkv, bf16_design):
    dev = _card()
    q = _randn(2, (B, Sq, H, hd), dtype, dev)
    k = _randn(3, (B, Kh, Skv, hd), dtype, dev)
    v = _randn(4, (B, Kh, Skv, hd), dtype, dev)
    before, by_design = tfa.launches, dict(tfa.launches_by_design)
    got = ops.flash_attention(q, k, v, causal=causal, block_q=bq, block_kv=bkv)
    assert tfa.launches == before + 1 and got.shape == q.shape
    assert _ran(tfa.launches_by_design, by_design) == (bf16_design if dtype == torch.bfloat16 else "simt")
    want = tfa.flash_attention_plain(q.transpose(1, 2), k, v, causal=causal,
                                     block_q=bq, block_kv=bkv).transpose(1, 2)
    _close(got, want)


def _flash_wgmma_case(B, H, Kh, Sq, Skv, hd, bq, bkv, causal):
    dev = _card()
    q = _randn(70, (B, Sq, H, hd), torch.bfloat16, dev)  # ops passes the transposed view
    k = _randn(71, (B, Kh, Skv, hd), torch.bfloat16, dev)
    v = _randn(72, (B, Kh, Skv, hd), torch.bfloat16, dev)
    by_design = dict(tfa.launches_by_design)
    got = ops.flash_attention(q, k, v, causal=causal, block_q=bq, block_kv=bkv)
    assert _ran(tfa.launches_by_design, by_design) == "wgmma"
    want = tfa.flash_attention_plain(q.transpose(1, 2), k, v, causal=causal,
                                     block_q=bq, block_kv=bkv).transpose(1, 2)
    tol = 5e-3  # chip_smoke.py's bf16 limit for flash attention
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_wgmma_kernels_launch_from_a_fresh_thread():
    """The tuner launches candidates from worker threads; the tensor maps
    are encoded there too (a thread with no current context once refused
    every tensor-core launch with "invalid argument")."""
    import threading

    dev = _card()
    a = _randn(80, (256, 256), torch.bfloat16, dev)
    q = _randn(81, (1, 128, 2, 64), torch.bfloat16, dev)
    k = _randn(82, (1, 2, 128, 64), torch.bfloat16, dev)
    out, errors = {}, []

    def work():
        try:
            out["mm"] = ops.matmul(a, a, bm=128, bn=128, bk=64)
            out["fa"] = ops.flash_attention(q, k, k, block_q=128, block_kv=64)
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    th = threading.Thread(target=work)
    th.start()
    th.join()
    assert not errors, errors
    _close(out["mm"], tmm.matmul_plain(a, a, bm=128, bn=128, bk=64))
    want = tfa.flash_attention_plain(q.transpose(1, 2), k, k, block_q=128, block_kv=64).transpose(1, 2)
    torch.testing.assert_close(out["fa"].float().cpu(), want.float().cpu(), atol=5e-3, rtol=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("bkv", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_wgmma_every_head_dim_and_block_kv(hd, bkv, causal):
    bq = 128 if bkv % 32 == 0 else 64  # one and two consumer warpgroups
    _flash_wgmma_case(1, 4, 2, 256, 256, hd, bq, bkv, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Kh,Sq,Skv,hd,bq,bkv", [
    (2, 14, 2, 256, 256, 128, 128, 128),  # GQA g = 7, the default tile
    (1, 4, 2, 64, 256, 64, 64, 32),  # Sq < Skv: top-left, later keys masked
    (1, 4, 1, 256, 128, 32, 128, 64),  # Sq > Skv: late rows see every key
    (2, 28, 4, 512, 512, 128, 64, 64),  # qwen2-7b heads
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_wgmma_gqa_and_unequal_lengths(causal, B, H, Kh, Sq, Skv, hd, bq, bkv):
    _flash_wgmma_case(B, H, Kh, Sq, Skv, hd, bq, bkv, causal)


@pytest.mark.cuda
def test_oversized_tiles_raise_before_any_launch():
    dev = _card()
    a = _randn(0, (512, 512), torch.bfloat16, dev)
    before = tmm.launches
    with pytest.raises(ValueError, match="shared memory|accumulators"):
        ops.matmul(a, a, bm=256, bn=256, bk=256)
    with pytest.raises(ValueError, match="interpret=True"):
        ops.matmul(a, a, interpret=True)
    assert tmm.launches == before
    q = _randn(1, (1, 512, 2, 128), torch.bfloat16, dev)
    kv = _randn(2, (1, 2, 512, 128), torch.bfloat16, dev)
    with pytest.raises(ValueError, match="threads"):
        ops.flash_attention(q, kv, kv, block_q=512, block_kv=64)
    torch.cuda.synchronize()  # the context is still healthy
    ops.matmul(a, a, bm=64, bn=64, bk=64)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_tune_then_replay_launches_once(tmp_path):
    dev = _card()
    a = _randn(5, (128, 128), torch.float32, dev)
    b = _randn(6, (128, 128), torch.float32, dev)
    rec = tune_call("matmul", a, b, db=TuningDB(str(tmp_path / "db.json")), max_iter=2)
    assert rec.key.backend == "cuda" and rec.key.device_kind == torch.cuda.get_device_name(dev)
    before = tmm.launches
    out = autotuned("matmul", a, b, db=TuningDB(str(tmp_path / "db.json")))
    assert tmm.launches == before + 1
    assert torch.equal(out, get_spec("matmul").fn(a, b, **rec.point))


@pytest.mark.cuda
def test_fixed_policy_times_no_other_candidates_launches():
    """With several build threads, every rep of the fixed policy sees exactly
    its own launch on the card: the round's warm launches all finished."""
    dev = _card()
    a = _randn(7, (1024, 1024), torch.float32, dev)
    b = _randn(8, (1024, 1024), torch.float32, dev, 1.0 / 32)
    extra = []

    def cost(ex, *args):
        torch.cuda.synchronize()
        before = tmm.launches
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        ex(*args)
        e1.record()
        torch.cuda.synchronize()
        extra.append(tmm.launches - before - 1)
        return e0.elapsed_time(e1)

    rec = tune_call("matmul", a, b, db=TuningDB(None), measure="fixed", jobs=4, cost_fn=cost,
                    max_iter=4)
    assert rec is not None and math.isfinite(rec.cost) and extra
    assert extra == [0] * len(extra)


SCAN_TOL = {"lru": {torch.float32: 1e-5, torch.bfloat16: 3e-2},
            "rwkv": {torch.float32: 1e-5, torch.bfloat16: 5e-2}}


def _scan_close(kind, got, want):
    tol = SCAN_TOL[kind][got.dtype]
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,chunk,block_d", [
    (2, 64, 32, 16, 16), (2, 64, 32, 32, 32), (2, 64, 32, 64, 16), (1, 128, 256, 16, 128),
    (3, 96, 96, 32, 32), (1, 64, 2560, 4, 128), (2, 32, 64, 128, 64),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lru_scan_kernel_matches_plain(dtype, B, T, D, chunk, block_d):
    dev = _card()
    a = torch.sigmoid(_randn(10, (B, T, D), torch.float32, dev)).to(dtype)
    b = _randn(11, (B, T, D), dtype, dev)
    h0 = _randn(12, (B, D), torch.float32, dev)
    before = tls.launches["lru_scan"]
    hs, hT = ops.lru_scan(a, b, h0, chunk=chunk, block_d=block_d)
    assert tls.launches["lru_scan"] == before + 1
    assert hs.dtype == dtype and hT.dtype == torch.float32 and hs.is_cuda
    want_hs, want_hT = tls.lru_scan_plain(a, b, h0, chunk=min(chunk, T), block_d=min(block_d, D))
    _scan_close("lru", hs, want_hs)
    _scan_close("lru", hT, want_hT)


def _lru_args(B, T, D, dtype, dev, seed=10):
    a = torch.sigmoid(_randn(seed, (B, T, D), torch.float32, dev)).to(dtype)
    return a, _randn(seed + 1, (B, T, D), dtype, dev), _randn(seed + 2, (B, D), torch.float32, dev)


def _lru_against_both_plain(a, b, h0, chunk, block_d, hs, hT):
    """The kernel's output against the exact oracle and against its own
    segmented arithmetic at the segment count it ran."""
    B, T, D = a.shape
    L, bd = min(chunk, T), min(block_d, D)
    nseg = tls.lru_segments(B, T, D, L, bd, a.element_size(), tda.sm_count(a.device))
    for want_hs, want_hT in (tls.lru_scan_plain(a, b, h0, chunk=L, block_d=bd),
                             tls.lru_scan_segmented_plain(a, b, h0, segments=nseg)):
        _scan_close("lru", hs, want_hs)
        _scan_close("lru", hT, want_hT)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [4, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lru_segmented_kernel_at_the_served_shape(dtype, chunk):
    """recurrentgemma-2b's prefill scan over the whole tuning space (chunk
    16..256) and serving's chunk 4, against both plain versions; fp32 at
    chunk 256 needs a 256 KB one-chunk segment and is refused before launch.
    A second launch gives the same bits (the carry is chained, not raced)."""
    dev = _card()
    a, b, h0 = _lru_args(8, 2048, 2560, dtype, dev)
    before = tls.launches["lru_scan"]
    if dtype == torch.float32 and chunk == 256:
        with pytest.raises(ValueError, match="shared memory"):
            ops.lru_scan(a, b, h0, chunk=chunk)
        assert tls.launches["lru_scan"] == before
        return
    hs, hT = ops.lru_scan(a, b, h0, chunk=chunk)
    hs2, hT2 = ops.lru_scan(a, b, h0, chunk=chunk)
    assert tls.launches["lru_scan"] == before + 2
    assert torch.equal(hs, hs2) and torch.equal(hT, hT2)
    _lru_against_both_plain(a, b, h0, chunk, tls.LRU_BLOCK_D, hs, hT)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,chunk,block_d", [
    (2, 64, 96, 16, 32), (2, 64, 96, 32, 96), (2, 64, 96, 64, 24), (2, 64, 96, 16, 6),
    (2, 64, 96, 4, 96), (3, 96, 40, 32, 8), (1, 48, 5, 16, 5),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lru_segmented_kernel_small_odd_shapes(dtype, B, T, D, chunk, block_d):
    """Odd widths, channel blocks that are not a multiple of 4 (element
    copies), a misaligned view (element copies) and an aligned one."""
    dev = _card()
    a, b, h0 = _lru_args(B, T, D, dtype, dev, seed=13)
    hs, hT = ops.lru_scan(a, b, h0, chunk=chunk, block_d=block_d)
    _lru_against_both_plain(a, b, h0, chunk, block_d, hs, hT)
    off = torch.empty(B * T * D + 1, dtype=dtype, device=dev)[1:].view(B, T, D)
    off.copy_(a)
    hs, hT = ops.lru_scan(off, b, h0, chunk=chunk, block_d=block_d)
    _lru_against_both_plain(a, b, h0, chunk, block_d, hs, hT)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lru_segmented_kernel_long_carry_chains(dtype):
    """One batch row and one channel block: every segment waits on the one
    before it.  4096 segments of one step (through the launch entry point),
    then the derived count at chunk 1 (512 segments of 8); the same bits on
    every launch."""
    dev = _card()
    a, b, h0 = _lru_args(1, 4096, 64, dtype, dev, seed=17)
    want = tls.lru_scan_plain(a, b, h0, chunk=1, block_d=64)
    first = tls._lru_launch(a, b, h0, 1, 64, 4096)
    for nseg in (4096, 4096, tls.lru_segments(1, 4096, 64, 1, 64, a.element_size(),
                                              tda.sm_count(dev))):
        hs, hT = tls._lru_launch(a, b, h0, 1, 64, nseg)
        _scan_close("lru", hs, want[0])
        _scan_close("lru", hT, want[1])
        _scan_close("lru", hs, tls.lru_scan_segmented_plain(a, b, h0, segments=nseg)[0])
        if nseg == 4096:
            assert torch.equal(hs, first[0]) and torch.equal(hT, first[1])
    assert tls.lru_segments(1, 4096, 64, 1, 64, 4, 132) == 512


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,hd,chunk", [
    (1, 32, 2, 8, 8), (2, 64, 2, 16, 16), (1, 64, 1, 32, 32), (2, 64, 3, 64, 4),
    (1, 128, 2, 64, 128), (2, 48, 2, 32, 16),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv_scan_kernel_matches_plain(dtype, B, T, H, hd, chunk):
    dev = _card()
    r, k, v = (_randn(20 + i, (B, T, H, hd), dtype, dev) for i in range(3))
    lw = -torch.exp(_randn(23, (B, T, H, hd), torch.float32, dev))
    u = _randn(24, (H, hd), torch.float32, dev)
    s0 = _randn(25, (B, H, hd, hd), torch.float32, dev)
    before = tls.launches["rwkv_scan"]
    y, sT = ops.rwkv_scan(r, k, v, lw, u, s0, chunk=chunk)
    assert tls.launches["rwkv_scan"] == before + 1
    assert y.dtype == dtype and sT.dtype == torch.float32
    want_y, want_s = tls.rwkv_scan_plain(r, k, v, lw, u, s0, chunk=min(chunk, T))
    _scan_close("rwkv", y, want_y)
    _scan_close("rwkv", sT, want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [8, 64])
def test_rwkv_scan_kernel_strong_decay(hd):
    dev = _card()
    B, T, H = 1, 64, 2
    r, k, v = (_randn(30 + i, (B, T, H, hd), torch.float32, dev) for i in range(3))
    lw = torch.full((B, T, H, hd), -14.0, device=dev)
    u = _randn(33, (H, hd), torch.float32, dev)
    s0 = torch.zeros(B, H, hd, hd, device=dev)
    y, _ = ops.rwkv_scan(r, k, v, lw, u, s0, chunk=16)
    assert bool(torch.isfinite(y).all())
    _scan_close("rwkv", y, tls.rwkv_scan_plain(r, k, v, lw, u, s0, chunk=16)[0])


@pytest.mark.cuda
def test_scan_knobs_the_kernels_cannot_run_raise_before_launch():
    dev = _card()
    a = _randn(40, (1, 256, 256), torch.float32, dev)
    h0 = torch.zeros(1, 256, device=dev)
    before = dict(tls.launches)
    with pytest.raises(ValueError, match="shared memory"):
        ops.lru_scan(a, a, h0, chunk=256, block_d=256)
    r = _randn(41, (1, 32, 1, 128), torch.float32, dev)
    with pytest.raises(ValueError, match="head dim"):
        ops.rwkv_scan(r, r, r, -r.abs(), torch.zeros(1, 128, device=dev),
                      torch.zeros(1, 1, 128, 128, device=dev), chunk=16)
    assert tls.launches == before
    ops.lru_scan(a, a, h0, chunk=16)
    torch.cuda.synchronize()


def _decode_inputs(B, H, Kh, S, hd, dtype, dev, valid):
    q = _randn(50, (B, H, hd), dtype, dev)
    k = _randn(51, (B, Kh, S, hd), dtype, dev)
    v = _randn(52, (B, Kh, S, hd), dtype, dev)
    return q, k, v, torch.as_tensor(np.asarray(valid, np.int32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("length", [1, 37, 128])
@pytest.mark.parametrize("bkv", [16, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain(dtype, bkv, length):
    dev = _card()
    B, H, Kh, S, hd = 2, 4, 2, 128, 32
    args = _decode_inputs(B, H, Kh, S, hd, dtype, dev, (np.arange(S) < length)[None].repeat(B, 0))
    before = tda.launches
    got = ops.decode_attention(*args, block_kv=bkv)
    assert tda.launches == before + 1 and got.dtype == dtype and got.shape == (B, H, hd)
    _close(got, tda.decode_attention_plain(*args, block_kv=bkv))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Kh,S,hd,bkv", [
    (2, 2, 2, 256, 16, 64),  # g = 1
    (1, 4, 2, 512, 64, 256),  # g = 2
    (2, 28, 4, 2048, 128, 1024),  # qwen2-7b heads, the largest tile of the JAX space
    (2, 10, 1, 1024, 256, 1024),  # recurrentgemma-2b MQA at hd 256
    (1, 40, 2, 256, 128, 64),  # g = 20: two register groups of heads
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_ring_validity_and_groups(dtype, B, H, Kh, S, hd, bkv):
    dev = _card()
    valid = np.random.RandomState(9).uniform(size=(B, S)) < 0.4
    args = _decode_inputs(B, H, Kh, S, hd, dtype, dev, valid)
    _close(ops.decode_attention(*args, block_kv=bkv), tda.decode_attention_plain(*args, block_kv=bkv))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_all_invalid_row_is_the_mean_of_v(dtype):
    dev = _card()
    B, H, Kh, S, hd = 2, 14, 2, 512, 128
    valid = np.ones((B, S), bool)
    valid[0] = False
    valid[1, :200] = False  # leading all-invalid tiles are wiped later
    q, k, v, vd = _decode_inputs(B, H, Kh, S, hd, dtype, dev, valid)
    got = ops.decode_attention(q, k, v, vd, block_kv=64)
    assert bool(torch.isfinite(got.float()).all())
    mean_v = v[0].float().mean(dim=1).repeat_interleave(H // Kh, dim=0)
    tol = TOL[dtype]
    torch.testing.assert_close(got[0].float(), mean_v, atol=tol, rtol=tol)
    _close(got, tda.decode_attention_plain(q, k, v, vd, block_kv=64))


@pytest.mark.cuda
def test_decode_tiles_the_kernel_cannot_run_raise_before_launch():
    dev = _card()
    q, k, v, vd = _decode_inputs(1, 64, 1, 8192, 128, torch.bfloat16, dev, np.ones((1, 8192)))
    before = tda.launches
    with pytest.raises(ValueError, match="shared memory"):
        ops.decode_attention(q, k, v, vd, block_kv=8192)  # 8 heads' fp32 scores and the ring
    with pytest.raises(ValueError, match="int32"):
        ops.decode_attention(q, k, v, vd.long(), block_kv=64)
    assert tda.launches == before
    assert get_spec("decode_attention").defaults(q, k, v, vd) == {"block_kv": 512}
    ops.decode_attention(q, k, v, vd, block_kv=1024)  # the space's largest tile at g = 64
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_routed_decode_on_the_card():
    """The adaptive route launches the kernel on every call (no plain
    fallback), its accounting balances, and after the search it serves the
    committed point."""
    dev = _card()
    B, H, Kh, S, hd = 4, 28, 4, 4096, 128
    args = _decode_inputs(B, H, Kh, S, hd, torch.bfloat16, dev, np.ones((B, S)))
    db = TuningDB(None)
    router = kernel_router(db=db, epsilon=0.5, fresh=True)
    before = tda.launches
    for i in range(120):
        out = routed("decode_attention", *args, router=router)
        router.wait_pending()
        if router.stats()["searches_completed"]:
            break
    st = router.stats()
    assert st["searches_completed"] == 1 and st["calls"] == st["explores"] + st["exploits"]
    assert tda.launches - before == st["calls"]
    (rec,) = db.records()
    assert rec.key.backend == "cuda"
    out = routed("decode_attention", *args, router=router)
    assert torch.equal(out, ops.decode_attention(*args, **rec.point))


# --------------------------------------------- split-KV decode (the redesign)
@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Kh,S,hd,bkv", [
    (1, 7, 1, 4096, 128, 64),  # 64 tiles: many splits, one tile each on a 132-SM card
    (8, 28, 4, 128, 128, 64),  # 2 tiles: the tile count caps the splits
    (34, 8, 8, 128, 64, 64),  # 272 (row, KV head) blocks already: one split
    (2, 10, 1, 2048, 256, 64),  # recurrentgemma-2b MQA: two head groups of 5
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_split_kv_matches_plain_at_its_split_count(dtype, B, H, Kh, S, hd, bkv):
    """Leading and whole-split invalid runs, a row with no valid slot, and
    the kernel against the plain version at its own split count and at one."""
    dev = _card()
    valid = np.random.RandomState(14).uniform(size=(B, S)) < 0.5
    valid[0, : S * 3 // 4] = False  # every split but the last few holds no valid slot
    if B > 1:
        valid[1] = False  # no valid slot at all: the mean of V
    q, k, v, vd = _decode_inputs(B, H, Kh, S, hd, dtype, dev, valid)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = tda.grid(B, Kh, H // Kh, S, bkv, n_sm)
    before = dict(tda.launches_by_design)
    got = ops.decode_attention(q, k, v, vd, block_kv=bkv)
    assert _ran(tda.launches_by_design, before) == "vec16"
    assert bool(torch.isfinite(got.float()).all())
    _close(got, tda.decode_attention_plain(q, k, v, vd, block_kv=bkv, splits=grid[2]))
    _close(got, tda.decode_attention_plain(q, k, v, vd, block_kv=bkv))
    if B > 1:
        mean_v = v[1].float().mean(dim=1).repeat_interleave(H // Kh, dim=0)
        torch.testing.assert_close(got[1].float(), mean_v, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
def test_decode_ring_buffer_mqa_mask():
    """recurrentgemma-2b's ring after 2048 + 64 tokens, at several tiles."""
    dev = _card()
    B, H, Kh, W, hd, t_pos = 2, 10, 1, 2048, 256, 2048 + 63
    slots = np.arange(W)
    pos = slots + ((t_pos - slots) // W) * W
    valid = ((pos >= 0) & (pos <= t_pos) & (t_pos - pos < W))[None].repeat(B, 0)
    args = _decode_inputs(B, H, Kh, W, hd, torch.bfloat16, dev, valid)
    for bkv in (64, 256, 1024):
        n = tda.num_splits(B, Kh, H // Kh, W, bkv, torch.cuda.get_device_properties(dev).multi_processor_count)
        _close(ops.decode_attention(*args, block_kv=bkv),
               tda.decode_attention_plain(*args, block_kv=bkv, splits=n))


@pytest.mark.cuda
def test_decode_misaligned_view_takes_element_loads():
    """K and V 2 bytes off a 16-byte boundary, or with a row stride of 17
    elements: the same kernel fills its ring with element loads, never a
    launch error."""
    dev = _card()
    B, H, Kh, S, hd = 2, 14, 2, 512, 64
    q, k, v, vd = _decode_inputs(B, H, Kh, S, hd, torch.bfloat16, dev, np.ones((B, S)))
    flat = torch.empty(k.numel() + 1, dtype=k.dtype, device=dev)
    k_off = flat[1:].view(k.shape)
    k_off.copy_(k)
    v_wide = torch.zeros(B, Kh, S, hd + 1, dtype=v.dtype, device=dev)[..., :hd]
    v_wide.copy_(v)
    before = dict(tda.launches_by_design)
    got = ops.decode_attention(q, k_off, v_wide, vd, block_kv=128)
    assert _ran(tda.launches_by_design, before) == "narrow"
    _close(got, ops.decode_attention(q, k, v, vd, block_kv=128))


@pytest.mark.cuda
def test_redesigned_kernels_launch_from_a_fresh_thread():
    import threading

    dev = _card()
    q, k, v, vd = _decode_inputs(2, 28, 4, 1024, 128, torch.bfloat16, dev, np.ones((2, 1024)))
    r, kk, vv = (_randn(60 + i, (1, 64, 2, 64), torch.bfloat16, dev) for i in range(3))
    lw = -torch.exp(_randn(63, (1, 64, 2, 64), torch.float32, dev))
    u, s0 = _randn(64, (2, 64), torch.float32, dev), _randn(65, (1, 2, 64, 64), torch.float32, dev)
    out, errors = {}, []

    def work():
        try:
            out["da"] = ops.decode_attention(q, k, v, vd, block_kv=128)
            out["rwkv"] = ops.rwkv_scan(r, kk, vv, lw, u, s0, chunk=16)
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    th = threading.Thread(target=work)
    th.start()
    th.join()
    assert not errors, errors
    _close(out["da"], tda.decode_attention_plain(q, k, v, vd, block_kv=128))
    want_y, want_s = tls.rwkv_scan_plain(r, kk, vv, lw, u, s0)
    _scan_close("rwkv", out["rwkv"][0], want_y)
    _scan_close("rwkv", out["rwkv"][1], want_s)


# ------------------------------------- sub-chunked tensor-core RWKV (the redesign)
@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,chunk", [
    (2, 64, 3, 4), (1, 128, 2, 16), (1, 256, 2, 128), (2, 512, 2, 32), (1, 48, 2, 4),
])
def test_rwkv_tensor_core_design_matches_plain(B, T, H, chunk):
    """y at the bf16 limit 5e-2, the fp32 state at 1e-5; launches_by_design
    names the tensor-core design."""
    dev = _card()
    r, k, v = (_randn(70 + i, (B, T, H, 64), torch.bfloat16, dev) for i in range(3))
    lw = -torch.exp(_randn(73, (B, T, H, 64), torch.float32, dev))
    u = _randn(74, (H, 64), torch.float32, dev, 0.5)
    s0 = _randn(75, (B, H, 64, 64), torch.float32, dev)
    before = dict(tls.launches_by_design)
    y, sT = ops.rwkv_scan(r, k, v, lw, u, s0, chunk=chunk)
    assert _ran(tls.launches_by_design, before) == "tc"
    want_y, want_s = tls.rwkv_scan_plain(r, k, v, lw, u, s0, chunk=chunk)
    _scan_close("rwkv", y, want_y)
    _scan_close("rwkv", sT, want_s)
    yp, sp = tls.rwkv_scan_subchunk_plain(r, k, v, lw, u, s0)
    _scan_close("rwkv", y, yp)
    _scan_close("rwkv", sT, sp)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,T,want", [
    (torch.bfloat16, 64, 64, "tc"), (torch.float32, 64, 64, "per_token"),
    (torch.bfloat16, 32, 64, "per_token"), (torch.bfloat16, 64, 8, "per_token"),
])
def test_rwkv_strong_decay_on_each_design(dtype, hd, T, want):
    dev = _card()
    B, H = 1, 2
    r, k, v = (_randn(80 + i, (B, T, H, hd), dtype, dev) for i in range(3))
    lw = torch.full((B, T, H, hd), -14.0, device=dev)
    u = _randn(83, (H, hd), torch.float32, dev)
    s0 = _randn(84, (B, H, hd, hd), torch.float32, dev)
    before = dict(tls.launches_by_design)
    y, sT = ops.rwkv_scan(r, k, v, lw, u, s0, chunk=4 if T < 16 else 16)
    assert _ran(tls.launches_by_design, before) == want
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(sT).all())
    want_y, want_s = tls.rwkv_scan_plain(r, k, v, lw, u, s0)
    _scan_close("rwkv", y, want_y)
    _scan_close("rwkv", sT, want_s)


# ------------------------------------------------------ decode as CUDA graphs
def _tiny_decoder(arch, dev, B=2, P=16, extra=24):
    from repro_torch import configs
    from repro_torch.models import ExecConfig, Model

    cfg = configs.get_tiny(arch)
    model = Model(cfg, ExecConfig(attn_impl="cuda", rec_chunk=4), device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device=dev),
             "max_len": P + extra}

    def prefill():
        h, states = model.prefill(batch)
        return model.logits(h[:, None])[:, 0].argmax(-1)[:, None], states

    return model, prefill


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "rwkv6_7b"])
def test_decode_graphs_give_the_eager_loops_tokens(arch):
    """Every decode depth the server tunes, as one CUDA graph of k steps,
    emits the eager loop's 16 greedy tokens; a capture between replays (a
    drift re-tune's rebuild) runs its warm-up on scratch copies and leaves
    the stream's next tokens unchanged."""
    from repro_torch.launch.serve import DECODE_KS, DecodeGraphs

    dev = _card()
    P, n = 16, 16
    model, prefill = _tiny_decoder(arch, dev, P=P)
    tok, states = prefill()
    eager = []
    for i in range(n):
        logits, states = model.decode_step(tok, states, P + i)
        tok = logits.argmax(-1)[:, None]
        eager.append(tok)
    eager = torch.cat(eager, dim=1)
    for k in DECODE_KS:
        tok, states = prefill()
        graphs = DecodeGraphs(model, tok, states, P)
        run = graphs.build(k)
        token, states, pos = tok, states, P  # the first call loads the static set
        got = []
        for _ in range(n // k):
            token, states, pos, toks = run(token, states, pos)
            got.append(toks.clone())
        assert torch.equal(torch.cat(got, dim=1), eager), k
        assert pos is graphs.pos and int(pos) == P + n
    tok, states = prefill()
    graphs = DecodeGraphs(model, tok, states, P)
    run = graphs.build(4)
    token, states, pos, toks = run(graphs.token, graphs.states, graphs.pos)
    got = [toks.clone()]
    rebuilt = graphs.build(4)
    graphs.build(8)
    for _ in range(3):
        token, states, pos, toks = rebuilt(token, states, pos)
        got.append(toks.clone())
    assert torch.equal(torch.cat(got, dim=1), eager)
    assert graphs.captures == 3


@pytest.mark.cuda
def test_serve_tiny_on_the_card_decodes_through_graphs(tmp_path, capsys):
    """The launcher on the card: the first run captures every depth on the
    router's pool (none in-band) and commits a depth under the graph form's
    key; the second run is a DB hit."""
    from repro_torch.launch import serve

    _card()
    db = str(tmp_path / "serve.json")
    argv = ["--arch", "recurrentgemma_2b", "--tiny", "--prompt-len", "16", "--gen", "64",
            "--epsilon", "0.5", "--db", db]
    first = serve.serve(argv)
    text = capsys.readouterr().out
    assert not first["db_hit"] and first["graphs"].captures >= len(serve.DECODE_KS)
    assert re.search(r"\(0 in-band\)", text), text
    assert first["router"]["inband_builds"] == 0
    (rec,) = TuningDB(db, autosave=False).records()
    assert json.loads(rec.key.extra)["decode"] == "cuda_graph"
    second = serve.serve(argv)
    assert second["db_hit"] and "tuning db hit" in capsys.readouterr().out
