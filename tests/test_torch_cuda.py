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
strided q that ``ops.flash_attention`` passes.  The backward kernels (the
scans' and flash attention's) are held against their plain versions by
||kernel - plain|| / ||plain||; flash's also for two bit-identical calls, a
fixed kernel count, no S² allocation and a train step that never reaches
the oracle.
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


#: a backward output against its plain version: ||got - want|| / ||want||,
#: by the output's dtype.  The gradients are heavy-tailed sums of products
#: that cancel, so an element-wise limit tied to the largest |plain| would
#: pass a missing term; a bf16 output rounds each element once (about 2e-3
#: of the norm), an fp32 one sums the same products in another order.
BWD_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _bwd_rel(got, want):
    d = (got.float().cpu() - want.float().cpu()).norm().item()
    w = want.float().cpu().norm().item()
    return d / w if w > 0 else (0.0 if d == 0 else math.inf)


def _bwd_close(got, want, what):
    err, limit = _bwd_rel(got, want), BWD_REL[got.dtype]
    assert err <= limit, f"{what}: ||got - want|| / ||want|| = {err:.3e} over {limit:g}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_limit_rejects_a_dropped_u_term(dtype):
    """The limit that holds the backward kernels (on the CPU, through the
    plain version): dk and dv with their u terms dropped (the gradient at
    u = 0) fail it at heavy-tailed decays lw = -exp(randn), while the bf16
    gradient against the same gradient from fp32 inputs passes."""
    dev = torch.device("cpu")
    B, T, H, hd = 1, 64, 2, 64
    r, k, v = (_randn(100 + i, (B, T, H, hd), dtype, dev) for i in range(3))
    lw = -torch.exp(_randn(103, (B, T, H, hd), torch.float32, dev))
    u = _randn(104, (H, hd), torch.float32, dev, 0.5)
    s0 = _randn(105, (B, H, hd, hd), torch.float32, dev)
    gy = _randn(106, (B, T, H, hd), dtype, dev)
    gsT = _randn(107, (B, H, hd, hd), torch.float32, dev)
    want = tls.rwkv_scan_bwd_plain(r, k, v, lw, u, s0, gy, gsT)
    no_u = tls.rwkv_scan_bwd_plain(r, k, v, lw, torch.zeros_like(u), s0, gy, gsT)
    for i, name in ((1, "dk"), (2, "dv")):
        assert _bwd_rel(no_u[i], want[i]) > BWD_REL[dtype], name
    if dtype == torch.bfloat16:
        exact = tls.rwkv_scan_bwd_plain(r.float(), k.float(), v.float(), lw, u, s0, gy.float(), gsT)
        for name, g_, w_ in zip(("dr", "dk", "dv"), want, exact):
            _bwd_close(g_, w_, name)


#: the lru backward kernel against its own arithmetic in plain PyTorch
#: (``lru_scan_bwd_segmented_plain`` at the kernel's tiling), norm-wise: the
#: same association, the kernel's fused multiply-adds against the plain
#: version's multiply and add (fp32: 6e-8 to 2e-7 measured on an H100);
#: in bf16 an element that rounds the other way moves the norm by up to
#: 2^-8 / sqrt(n), 2.5e-4 at the smallest shape here (n = 240)
LRU_BWD_SEG_REL = {torch.float32: 1e-6, torch.bfloat16: 1e-3}


@pytest.mark.cuda
@pytest.mark.parametrize("long_memory", [False, True])
@pytest.mark.parametrize("B,T,D,chunk,block_d", [
    (2, 64, 32, 16, 16), (1, 64, 96, 4, 96), (3, 96, 40, 32, 8), (1, 48, 5, 16, 5),
    (4, 256, 2560, 8, 128), (1, 2048, 256, 8, 128), (4, 2048, 2560, 8, 128),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lru_backward_kernel_matches_plain(dtype, B, T, D, chunk, block_d, long_memory):
    """The backward kernel (one launch, no forward launch) against the plain
    reverse recurrence and against its own segmented arithmetic, with g and
    g_T nonzero, at a = sigmoid(N(0, 1)) and at long-memory decays a = 0.9 +
    0.0999·U(0, 1); two calls bit-identical.  Odd widths take element
    copies; (4, 256, 2560) is recurrentgemma-2b's training call; the T 2048
    shapes do not fit a block's shared memory and are streamed in tiles."""
    dev = _card()
    a, b, h0 = _lru_args(B, T, D, dtype, dev, seed=60)
    if long_memory:
        u = np.random.RandomState(65).uniform(size=(B, T, D)).astype(np.float32)
        a = torch.from_numpy(0.9 + 0.0999 * u).to(dtype).to(dev)
    ghs = _randn(63, (B, T, D), dtype, dev)
    ghT = _randn(64, (B, D), torch.float32, dev)
    before = dict(tls.launches)
    got = tls.lru_scan_bwd(a, b, h0, ghs, ghT, chunk=chunk, block_d=block_d)
    assert tls.launches["lru_scan"] == before["lru_scan"]
    assert tls.launches["lru_scan_bwd"] == before["lru_scan_bwd"] + 1
    again = tls.lru_scan_bwd(a, b, h0, ghs, ghT, chunk=chunk, block_d=block_d)
    want = tls.lru_scan_bwd_plain(a, b, h0, ghs, ghT, chunk=min(chunk, T), block_d=min(block_d, D))
    tiling = tls.lru_bwd_tiling(T, D, a.element_size())
    assert (tiling.tiles > 1) == (T == 2048)
    seg = tls.lru_scan_bwd_segmented_plain(a, b, h0, ghs, ghT, subsegments=tiling.nsub,
                                           tile=tiling.tile if tiling.tiles > 1 else 0)
    for name, g_, w_, s_, a_ in zip(("da", "db", "dh0"), got, want, seg, again):
        assert g_.dtype == w_.dtype and g_.shape == w_.shape
        _bwd_close(g_, w_, name)
        err = _bwd_rel(g_, s_)
        assert err <= LRU_BWD_SEG_REL[g_.dtype], f"{name} against the segmented plain version: {err:.3e}"
        assert torch.equal(g_, a_), f"{name}: two calls on the same inputs differ"


@pytest.mark.cuda
def test_lru_backward_kernel_without_final_state_cotangent():
    """g_T = None reaches the kernel as a null pointer (zero), with nothing
    launched to make zeros; an input that starts off a 16-byte boundary
    takes element copies."""
    dev = _card()
    a, b, h0 = _lru_args(2, 64, 32, torch.float32, dev, seed=66)
    ghs = _randn(69, (2, 64, 32), torch.float32, dev)
    got = tls.lru_scan_bwd(a, b, h0, ghs, None, chunk=16)
    want = tls.lru_scan_bwd_plain(a, b, h0, ghs, None, chunk=16)
    for name, g_, w_ in zip(("da", "db", "dh0"), got, want):
        _bwd_close(g_, w_, name)
    big = _randn(70, (2 * 64 * 32 + 1,), torch.float32, dev)
    off = big[1:].view(2, 64, 32)  # starts 4 bytes past a 16-byte boundary
    off.copy_(a)
    got = tls.lru_scan_bwd(off, b, h0, ghs, None, chunk=16)
    for name, g_, w_ in zip(("da", "db", "dh0"), got, want):
        _bwd_close(g_, w_, name)


RWKV_BWD_SHAPES = [(2, 64, 2, 8), (1, 64, 2, 16), (2, 48, 1, 32), (1, 13, 1, 64), (1, 36, 2, 64),
                   (1, 256, 4, 64), (1, 256, 2, 8), (1, 100, 1, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,hd", RWKV_BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv_backward_kernel_matches_plain(dtype, B, T, H, hd):
    """Every head dim; T = 13 (chunk 1) and 36 (chunk 9) where the derived
    chunk is not a power of two; several checkpoint segments of one chunk
    (hd 8, T 256), of 8 chunks (hd 64, T 256) and of 5 chunks of 10 (T 100);
    gy and gs_T nonzero."""
    dev = _card()
    r, k, v = (_randn(70 + i, (B, T, H, hd), dtype, dev) for i in range(3))
    lw = -torch.exp(_randn(73, (B, T, H, hd), torch.float32, dev))
    u = _randn(74, (H, hd), torch.float32, dev, 0.5)
    s0 = _randn(75, (B, H, hd, hd), torch.float32, dev)
    gy = _randn(76, (B, T, H, hd), dtype, dev)
    gsT = _randn(77, (B, H, hd, hd), torch.float32, dev)
    before = tls.launches["rwkv_scan_bwd"]
    got = tls.rwkv_scan_bwd(r, k, v, lw, u, s0, gy, gsT)
    assert tls.launches["rwkv_scan_bwd"] == before + 1
    want = tls.rwkv_scan_bwd_plain(r, k, v, lw, u, s0, gy, gsT)
    for name, g_, w_ in zip(("dr", "dk", "dv", "dlw", "du", "ds0"), got, want):
        assert g_.dtype == w_.dtype and g_.shape == w_.shape
        assert bool(torch.isfinite(g_.float()).all()), name
        _bwd_close(g_, w_, name)


@pytest.mark.cuda
@pytest.mark.parametrize("slices", [1, 2, 4, 8])
@pytest.mark.parametrize("B", [1, 2])
def test_rwkv_backward_kernel_at_every_slice_count(B, slices):
    """The launch at 1, 2, 4 and 8 row slices a (head, batch row)
    (clusters of that many blocks), bf16 at head dim 64 over two checkpoint
    segments, gy and gs_T nonzero: all six outputs against the plain
    version, two calls bit-identical, and the same bits as one block a
    (head, batch row) (every sum runs in the one-block order)."""
    dev = _card()
    T, H, hd = 128, 2, 64
    r, k, v = (_randn(120 + i, (B, T, H, hd), torch.bfloat16, dev) for i in range(3))
    lw = -torch.exp(_randn(123, (B, T, H, hd), torch.float32, dev))
    u = _randn(124, (H, hd), torch.float32, dev, 0.5)
    s0 = _randn(125, (B, H, hd, hd), torch.float32, dev)
    gy = _randn(126, (B, T, H, hd), torch.bfloat16, dev)
    gsT = _randn(127, (B, H, hd, hd), torch.float32, dev)
    L = tls.rwkv_bwd_chunk(T, hd)
    args = (r, k, v, lw, u, s0, gy, gsT, L, tls.rwkv_bwd_segment(T, L), slices)
    got = tls._rwkv_bwd_launch(*args)
    again = tls._rwkv_bwd_launch(*args)
    one = tls._rwkv_bwd_launch(*args[:-1], 1)
    want = tls.rwkv_scan_bwd_plain(r, k, v, lw, u, s0, gy, gsT)
    for name, g_, w_, a_, o_ in zip(("dr", "dk", "dv", "dlw", "du", "ds0"), got, want, again, one):
        assert bool(torch.isfinite(g_.float()).all()), name
        _bwd_close(g_, w_, name)
        assert torch.equal(g_, a_), f"{name}: two calls on the same inputs differ"
        assert torch.equal(g_, o_), f"{name}: {slices} slices differ from one"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv_backward_kernel_strong_decay(dtype):
    """lw = -14 (w underflows to ~8e-7): the states come from checkpoints,
    never from dividing by w."""
    dev = _card()
    B, T, H, hd = 1, 64, 2, 64
    r, k, v = (_randn(80 + i, (B, T, H, hd), dtype, dev) for i in range(3))
    lw = torch.full((B, T, H, hd), -14.0, device=dev)
    u = _randn(83, (H, hd), torch.float32, dev, 0.5)
    s0 = _randn(84, (B, H, hd, hd), torch.float32, dev)
    gy = _randn(85, (B, T, H, hd), dtype, dev)
    gsT = _randn(86, (B, H, hd, hd), torch.float32, dev)
    got = tls.rwkv_scan_bwd(r, k, v, lw, u, s0, gy, gsT)
    for name, g_, w_ in zip(("dr", "dk", "dv", "dlw", "du", "ds0"), got,
                            tls.rwkv_scan_bwd_plain(r, k, v, lw, u, s0, gy, gsT)):
        assert bool(torch.isfinite(g_.float()).all()), name
        _bwd_close(g_, w_, name)


@pytest.mark.cuda
def test_scan_backward_under_autograd_calls_no_oracle():
    """``ops.lru_scan`` and ``ops.rwkv_scan`` under autograd on CUDA tensors:
    the backward launches its kernel once and never runs a per-token oracle
    (both are replaced by functions that raise)."""
    from repro_torch.kernels import ref as tref

    dev = _card()
    a, b, h0 = _lru_args(2, 64, 32, torch.float32, dev, seed=90)
    r, k, v = (_randn(91 + i, (1, 32, 2, 64), torch.bfloat16, dev) for i in range(3))
    lw = -torch.exp(_randn(94, (1, 32, 2, 64), torch.float32, dev))
    u, s0 = _randn(95, (2, 64), torch.float32, dev), _randn(96, (1, 2, 64, 64), torch.float32, dev)
    lru_leaves = [t.clone().requires_grad_(True) for t in (a, b, h0)]
    rwkv_leaves = [t.clone().requires_grad_(True) for t in (r, k, v, lw, u, s0)]
    lru_want = tls.lru_scan_bwd_plain(a, b, h0, torch.ones_like(a), torch.ones_like(h0), chunk=16,
                                      block_d=32)
    y_ones = torch.ones_like(r)
    rwkv_want = tls.rwkv_scan_bwd_plain(r, k, v, lw, u, s0, y_ones, torch.ones_like(s0))
    oracles = (tref.lru_scan_ref, tref.rwkv_scan_ref)

    def refuse(*a_, **k_):
        raise AssertionError("a backward ran the per-token oracle")

    before = dict(tls.launches)
    tref.lru_scan_ref = tref.rwkv_scan_ref = refuse
    try:
        hs, hT = ops.lru_scan(*lru_leaves, chunk=16, block_d=32)
        (hs.sum() + hT.sum()).backward()
        y, sT = ops.rwkv_scan(*rwkv_leaves, chunk=16)
        (y.float().sum() + sT.sum()).backward()
    finally:
        tref.lru_scan_ref, tref.rwkv_scan_ref = oracles
    assert {n_: tls.launches[n_] - before[n_] for n_ in before} == {
        "lru_scan": 1, "rwkv_scan": 1, "lru_scan_bwd": 1, "rwkv_scan_bwd": 1}
    for name, leaf, w_ in zip(("da", "db", "dh0"), lru_leaves, lru_want):
        _bwd_close(leaf.grad, w_, name)
    for name, leaf, w_ in zip(("dr", "dk", "dv", "dlw", "du", "ds0"), rwkv_leaves, rwkv_want):
        _bwd_close(leaf.grad, w_, name)


# (B, Sq, Skv, H, Kh, hd): every head dim, MHA, GQA (g = 7, qwen2-7b's) and
# MQA, Sq < Skv and Sq > Skv, and two shapes the tensor-core design does not
# take (not multiples of 64), which run the CUDA-core design in bf16 too
FLASH_BWD_SHAPES = [(1, 128, 128, 4, 2, 16), (2, 128, 128, 4, 4, 32), (1, 256, 256, 8, 1, 64),
                    (1, 128, 128, 14, 2, 128), (1, 128, 256, 4, 2, 64), (1, 256, 128, 4, 2, 128),
                    (1, 96, 96, 4, 2, 64), (1, 48, 80, 2, 2, 16)]


def _flash_bwd_inputs(B, Sq, Skv, H, Kh, hd, dtype, dev, causal, seed=110):
    """q and dO as (B,H,Sq,hd) views of (B,Sq,H,hd) tensors and k, v as views
    of (B,Skv,Kh,hd) ones, as ``ops.flash_attention`` and ``attn_apply``
    hand them in; o and lse from the forward kernel."""
    q = _randn(seed, (B, Sq, H, hd), dtype, dev).transpose(1, 2)
    k = _randn(seed + 1, (B, Skv, Kh, hd), dtype, dev).transpose(1, 2)
    v = _randn(seed + 2, (B, Skv, Kh, hd), dtype, dev).transpose(1, 2)
    do = _randn(seed + 3, (B, Sq, H, hd), dtype, dev).transpose(1, 2)
    blocks = {"block_q": 64, "block_kv": 64} if Sq % 64 == 0 and Skv % 64 == 0 else \
        {"block_q": 16, "block_kv": 16}
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, return_lse=True, **blocks)
    return q, k, v, o, lse, do, blocks


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv,H,Kh,hd", FLASH_BWD_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernel_matches_plain(dtype, causal, B, Sq, Skv, H, Kh, hd):
    """dq, dk and dv against ``flash_attention_bwd_plain`` on the same o and
    lse (norm-wise, ``BWD_REL``), the design that ran (tensor cores for bf16
    at multiples of 64), the forward's lse against the plain version's, the
    outputs in the layouts of q, k and v, and two calls bit-identical."""
    dev = _card()
    q, k, v, o, lse, do, blocks = _flash_bwd_inputs(B, Sq, Skv, H, Kh, hd, dtype, dev, causal)
    _, lse_plain = tfa.flash_attention_plain(q, k, v, causal=causal, return_lse=True, **blocks)
    torch.testing.assert_close(lse.cpu(), lse_plain.cpu(), atol=1e-5, rtol=1e-5)
    before, by_design = tfa.bwd_launches, dict(tfa.launches_by_design)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, **blocks)
    assert tfa.bwd_launches == before + 1
    want_design = "bwd_wgmma" if dtype == torch.bfloat16 and Sq % 64 == 0 and Skv % 64 == 0 else "bwd_simt"
    assert _ran(tfa.launches_by_design, by_design) == want_design
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, **blocks)
    again = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, **blocks)
    for name, g_, w_, t_, a_ in zip(("dq", "dk", "dv"), got, want, (q, k, v), again):
        assert g_.dtype == t_.dtype and g_.shape == t_.shape and g_.stride() == t_.stride(), name
        assert bool(torch.isfinite(g_.float()).all()), name
        _bwd_close(g_, w_, name)
        assert torch.equal(g_, a_), f"{name}: two calls on the same inputs differ"


# (B, S, H, Kh, hd) causal Sq == Skv where the dK/dV pass splits a group's
# heads: qwen2-7b's layer at 512 tokens (g = 7 over 7 blocks), g = 2 over 2
FLASH_BWD_SPLIT_SHAPES = [(1, 512, 28, 4, 128), (1, 1152, 16, 8, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Kh,hd", FLASH_BWD_SPLIT_SHAPES)
def test_flash_backward_head_split_matches_plain(B, S, H, Kh, hd):
    """Causal bf16 at shapes whose KV tiles alone do not fill the SMs: the
    head split is > 1, the three kernels' result holds against the plain
    version, and two calls give the same bits (the partials are summed in
    split order)."""
    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = tfa.bwd_head_splits(B, Kh, H // Kh, S, sms)
    assert splits > 1 and (H // Kh) % splits == 0
    q, k, v, o, lse, do, blocks = _flash_bwd_inputs(B, S, S, H, Kh, hd, torch.bfloat16, dev, True)
    by_design = dict(tfa.launches_by_design)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True, **blocks)
    assert _ran(tfa.launches_by_design, by_design) == "bwd_wgmma"
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True, **blocks)
    again = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True, **blocks)
    for name, g_, w_, a_ in zip(("dq", "dk", "dv"), got, want, again):
        _bwd_close(g_, w_, name)
        assert torch.equal(g_, a_), f"{name}: two calls on the same inputs differ"


@pytest.mark.cuda
def test_flash_backward_limit_rejects_a_dropped_d_term():
    """The limit that holds the backward kernel rejects dq and dk computed
    without D (dS = P dP, the planted fault chip_smoke.py also rejects)."""
    dev = _card()
    q, k, v, o, lse, do, blocks = _flash_bwd_inputs(1, 256, 256, 4, 2, 64, torch.bfloat16, dev, True)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True, **blocks)
    no_d = tfa.flash_attention_bwd_plain(q, k, v, torch.zeros_like(o), lse, do, causal=True, **blocks)
    for name, g_, f_ in zip(("dq", "dk"), got, no_d):
        assert _bwd_rel(f_, g_) > BWD_REL[torch.bfloat16], name


@pytest.mark.cuda
def test_flash_backward_kernels_a_call_fixed_in_s():
    """One backward call under ``torch.profiler`` launches the same device
    kernels at 512 and 2048 tokens (three: the dq pass with D, the dK/dV
    pass, the sum of its head splits' partials, which runs at every split)."""
    from torch.profiler import ProfilerActivity, profile

    dev = _card()
    seen = {}
    for S in (512, 2048):
        q, k, v, o, lse, do, blocks = _flash_bwd_inputs(1, S, S, 8, 2, 128, torch.bfloat16, dev, True)
        tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
            torch.cuda.synchronize()
        seen[S] = sorted(e.name for e in prof.events() if e.device_type.name == "CUDA"
                         and "memcpy" not in e.name.lower() and "memset" not in e.name.lower())
    assert seen[512] == seen[2048] and len(seen[512]) == tfa.BWD_KERNELS["wgmma"], seen


@pytest.mark.cuda
def test_flash_backward_allocates_no_score_matrix():
    """The backward at (1, 4096, 8, 64) allocates its outputs and D, far
    under one (B, H, S, S) fp32 tensor (537 MB), which the oracle it
    replaced made several of."""
    dev = _card()
    B, S, H, hd = 1, 4096, 8, 64
    q, k, v, o, lse, do, _ = _flash_bwd_inputs(B, S, S, H, H, hd, torch.bfloat16, dev, False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    grads = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    assert peak < B * H * S * S * 4, peak
    assert peak < 4 * sum(g.numel() * g.element_size() for g in grads), peak


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", (1e-5, 1e-5)), ("bfloat16", (1e-3, 1e-2))])
def test_flash_train_step_on_the_kernel_path_runs_no_oracle(dtype, tol):
    """One ``make_train_step`` update of tiny qwen2-7b at 64 tokens on the
    card with ``ref.flash_attention_ref`` replaced by a function that
    raises: the backward launches its kernel once per layer (the tensor-core
    design in bf16, the CUDA-core one in fp32), and the loss and gradient
    norm match the plain path's from the same weights (relative tol)."""
    from repro_torch.data import make_batch_for
    from repro_torch.kernels import ref as tref
    from repro_torch.optim import AdamW
    from repro_torch.train import make_train_step

    def refuse(*a_, **k_):
        raise AssertionError("the flash backward ran the oracle")

    dev = _card()
    metrics, oracle = {}, tref.flash_attention_ref
    tref.flash_attention_ref = refuse
    try:
        for impl in ("cuda", "xla"):
            before, by_design = tfa.bwd_launches, dict(tfa.launches_by_design)
            model = _tiny_train("qwen2_7b", dev, impl, dtype)
            batch = make_batch_for(model.cfg, 2, 64, step=0, seed=0, device=dev)
            opt = AdamW(lr=1e-3)
            params = model.params()
            _, _, metrics[impl] = make_train_step(model, opt)(params, opt.init(params), batch)
            torch.cuda.synchronize()
            n_layers = model.cfg.n_layers if impl == "cuda" else 0
            design = "bwd_wgmma" if dtype == "bfloat16" else "bwd_simt"
            assert tfa.bwd_launches - before == n_layers
            assert tfa.launches_by_design[design] - by_design[design] == n_layers
    finally:
        tref.flash_attention_ref = oracle
    for k_, t_ in zip(("loss", "grad_norm"), tol):
        got, want = metrics["cuda"][k_].item(), metrics["xla"][k_].item()
        assert abs(got - want) <= t_ * abs(want), (k_, got, want)


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
    if cfg.is_encdec or cfg.family == "vlm":  # the modality-stub context
        ctx = 0.1 * torch.randn((B, cfg.ctx_tokens, cfg.d_model), generator=gen, device=dev)
        batch["frames" if cfg.is_encdec else "ctx_embeds"] = ctx

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
@pytest.mark.parametrize("arch", ["seamless_m4t_large_v2", "llama_3_2_vision_11b",
                                  "moonshot_v1_16b_a3b", "arctic_480b"])
def test_family_decode_graphs_give_the_eager_loops_tokens(arch):
    """The encoder-decoder, VLM and MoE families decode as CUDA graphs: a
    cross block's context K/V is read in place (never copied), and the MoE
    dispatch is shape-static, so every depth emits the eager loop's tokens."""
    from repro_torch.launch.serve import DECODE_KS, DecodeGraphs

    dev = _card()
    P, n = 16, 16
    model, prefill = _tiny_decoder(arch, dev, P=P)
    cfg = model.cfg
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
        for st, live in zip(graphs.states, states):
            for name in ("xk", "xv"):
                assert name not in st or st[name] is live[name]
        run = graphs.build(k)
        token, states, pos = tok, states, P
        got = []
        for _ in range(n // k):
            token, states, pos, toks = run(token, states, pos)
            got.append(toks.clone())
        assert torch.equal(torch.cat(got, dim=1), eager), k
    assert ("cross" in cfg.pattern) == (cfg.family in ("audio", "vlm"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_runs_the_flash_kernel_non_causal(dtype):
    """An encoder at head dim 64 (the served seamless shape's) on the flash
    kernel against the plain path: one non-causal launch a layer, of the
    tensor-core design in bf16."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import ExecConfig, Model

    dev = _card()
    cfg = dataclasses.replace(configs.get_tiny("seamless_m4t_large_v2"), d_model=256,
                              d_head=64, compute_dtype=dtype)
    assert cfg.d_head == 64
    model = Model(cfg, ExecConfig(attn_impl="cuda"), device=dev, seed=0)
    frames = _randn(90, (2, 512, 256), torch.float32, dev, 0.1)
    before, by_design = tfa.launches, dict(tfa.launches_by_design)
    got = model.encode(frames)
    assert tfa.launches == before + cfg.enc_layers
    if dtype == "bfloat16":
        assert tfa.launches_by_design["wgmma"] == by_design["wgmma"] + cfg.enc_layers
    model.exec_cfg = ExecConfig(attn_impl="xla")
    want = model.encode(frames)
    tol = 1e-4 if dtype == "float32" else 3e-2
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(), atol=tol, rtol=tol)


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


# ------------------------------------------------------------------ training
def _tiny_train(arch, dev, impl, dtype="float32"):
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import ExecConfig, TrainModel

    cfg = dataclasses.replace(configs.get_tiny(arch), compute_dtype=dtype)
    return TrainModel(cfg, ExecConfig(attn_impl=impl, rec_chunk=8, block_q=64, block_kv=64),
                      device=dev, seed=0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2_7b", "recurrentgemma_2b"])
def test_tiny_train_step_on_the_card_kernel_path_matches_plain(arch):
    """One ``make_train_step`` update on the card through the kernels (flash
    for qwen2-7b's attention, lru_scan for recurrentgemma-2b's RG-LRU
    layers, each under autograd) against the plain path from the same
    weights, in fp32 compute: loss and gradient norm at 1e-5, every
    gradient leaf within 1e-4 of its largest magnitude.  Each lru backward
    launches its one kernel (no forward launch)."""
    from repro_torch.data import make_batch_for
    from repro_torch.optim import AdamW
    from repro_torch.train import make_loss_fn, make_train_step

    dev = _card()
    counted = lambda: (tfa.launches, tls.launches["lru_scan"], tls.launches["lru_scan_bwd"])  # noqa: E731
    grads, metrics, before = {}, {}, counted()
    for impl in ("cuda", "xla"):
        model = _tiny_train(arch, dev, impl)
        batch = make_batch_for(model.cfg, 4, 32, step=0, seed=0, device=dev)
        loss, _ = make_loss_fn(model)(model.params(), batch)
        loss.backward()
        grads[impl] = {n: p.grad.detach().clone() for n, p in model.params().items()}
        opt = AdamW(lr=1e-3)
        params = model.params()
        _, _, metrics[impl] = make_train_step(model, opt, microbatches=2)(params, opt.init(params),
                                                                         batch)
        if impl == "cuda":
            launched = tuple(n - b for n, b in zip(counted(), before))
            assert launched == ((2 + 4, 0, 0) if arch == "qwen2_7b"
                                else (0, 4 + 8, 4 + 8)), launched
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(metrics["cuda"][k], metrics["xla"][k], atol=1e-5, rtol=1e-5)
    for n, g in grads["cuda"].items():
        scale = grads["xla"][n].abs().max().item()
        assert (g - grads["xla"][n]).abs().max().item() <= 1e-4 * scale + 1e-12, n


@pytest.mark.cuda
def test_save_async_then_an_optimizer_step_restores_the_snapshot(tmp_path):
    """``save_async`` copies the card's tensors to the host before it
    returns: an optimizer step launched right after it (in place, on the
    same stream) does not reach the checkpoint."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import make_batch_for
    from repro_torch.optim import AdamW, tree_leaves
    from repro_torch.train import make_train_step

    dev = _card()
    model = _tiny_train("qwen2_7b", dev, "cuda", "bfloat16")
    opt = AdamW(lr=1e-2)
    params = model.params()
    state = opt.init(params)
    step = make_train_step(model, opt)
    step(params, state, make_batch_for(model.cfg, 4, 32, step=0, device=dev))
    snapshot = [t.detach().clone() for t in tree_leaves((params, state))]
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save_async(0, (params, state))
    step(params, state, make_batch_for(model.cfg, 4, 32, step=1, device=dev))
    loaded, got, _ = ckpt.restore((params, state))
    assert got == 0
    leaves = tree_leaves(loaded)
    assert all(a.is_cuda and torch.equal(a, b) for a, b in zip(leaves, snapshot))
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves((params, state)), snapshot))


# ------------------------------------------------------------ parallel layer
@pytest.mark.cuda
def test_device_pool_pins_each_members_measurements_to_its_card():
    """``local_device_pool`` slots sit on the cards; ``device_bound_measure``
    makes each slot's card current in the worker thread that measures, and
    the race's winner is a legal tile whose output matches the plain
    version."""
    import threading

    from repro_torch.core import CSA, RandomSearch
    from repro_torch.core.costs import ExecutableCache
    from repro_torch.parallel.devices import local_device_pool
    from repro_torch.tuning.fleet import ShardedPortfolio, device_bound_measure

    _card()
    n = torch.cuda.device_count()
    slots = local_device_pool(4, cache=ExecutableCache(maxsize=16))
    assert [s.device for s in slots] == [torch.device("cuda", i % n) for i in range(4)]
    a = _randn(0, (256, 192), torch.bfloat16, "cuda")
    b = _randn(1, (192, 128), torch.bfloat16, "cuda", 1 / math.sqrt(192))
    spec = get_spec("matmul")
    space = spec.space(a, b)
    seen = []

    def measure(i, points):
        slot = slots[i % 4]
        out = []
        for z in points:
            knobs = space.decode(z)
            try:
                spec.check(a, b, interpret=False, **knobs)
            except ValueError:
                out.append(float("inf"))
                continue
            aa, bb = a.to(slot.device), b.to(slot.device)
            got = ops.matmul(aa, bb, **knobs)
            seen.append((torch.cuda.current_device(), slot.device.index, got.device.index,
                         threading.get_ident()))
            out.append(float(sum(knobs.values())))  # a deterministic cost
        return out

    members = [CSA(3, num_opt=2, max_iter=3, seed=s) for s in range(2)] + [RandomSearch(3, max_iter=6, seed=2)]
    res = ShardedPortfolio(members, rung=2).run(device_bound_measure(measure, slots))
    assert seen and all(cur == want == dev for cur, want, dev, _ in seen)
    best = space.decode(res.best_x)
    _close(ops.matmul(a, b, **best), tmm.matmul_plain(a, b, **best))


def _nccl_group():
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)


@pytest.mark.cuda
def test_collectives_pipeline_and_compressed_dp_on_a_one_rank_nccl_group():
    import dataclasses

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.data import make_batch_for
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ExecConfig, TrainModel
    from repro_torch.optim import AdamW
    from repro_torch.parallel.collectives import (chunked_psum, int8_psum, make_compressed_dp_step,
                                                  topk_psum)
    from repro_torch.parallel.pipeline import gpipe_apply
    from repro_torch.train import make_loss_fn, make_train_step

    _card()
    _nccl_group()
    try:
        mesh = make_mesh((1,), ("data",))
        assert mesh.device_type == "cuda"
        group = mesh.get_group("data")
        g = _randn(2, (384, 640), torch.float32, "cuda", 1e-2)
        r = int8_psum(g, group)
        amax = g.abs().max()
        # scale/2, plus the fp32 rounding of the divide and the multiply
        limit = (amax / 127.0).item() / 2 + 2 * amax.item() * 2.0 ** -23
        assert (r - g).abs().max().item() <= limit
        s, e = topk_psum(g, group, 0.05, torch.zeros_like(g))
        assert torch.equal(s + e, g) and int((s != 0).sum()) >= int(g.numel() * 0.05)
        whole = g.clone()
        dist.all_reduce(whole, group=group)
        for cb in (4096, 1 << 20, 1 << 30):
            assert torch.equal(chunked_psum(g, group, cb), whole)

        x = _randn(3, (3, 8, 64), torch.float32, "cuda")
        w = _randn(4, (1, 64, 64), torch.float32, "cuda", 0.125).requires_grad_(True)
        y = gpipe_apply(mesh, "data", lambda wp, xm: torch.tanh(xm @ wp), w, x)
        (y ** 2).sum().backward()
        gw, w.grad = w.grad.clone(), None
        y_ref = torch.tanh(x @ w[0])
        (y_ref ** 2).sum().backward()
        _close(y.detach(), y_ref.detach())
        torch.testing.assert_close(gw, w.grad, atol=1e-4, rtol=1e-4)

        cfg = dataclasses.replace(configs.get_tiny("qwen2_7b"), compute_dtype="float32")
        batches = [make_batch_for(cfg, 2, 16, step=i, seed=0, device="cuda") for i in range(2)]
        losses = {}
        for method in ("train_step", "exact"):
            model = TrainModel(cfg, ExecConfig(attn_impl="cuda"), device="cuda", seed=0)
            params = model.params()
            opt = AdamW(lr=1e-3)
            st = opt.init(params)
            if method == "train_step":
                step = make_train_step(model, opt)
            else:
                step, init_err = make_compressed_dp_step(make_loss_fn(model), opt, mesh, method="exact")
                err = init_err(params)
            out = []
            for batch in batches:
                if method == "train_step":
                    params, st, m = step(params, st, batch)
                else:
                    params, st, err, m = step(params, st, err, batch)
                out.append(m["loss"].item())
            losses[method] = out
        assert losses["exact"] == losses["train_step"]
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_train_distributed_under_torchrun_on_the_card():
    """``launch.train --distributed`` under torchrun takes NCCL and
    ``cuda:LOCAL_RANK`` and trains the steps the plain launcher trains."""
    import os
    import subprocess
    import sys

    from repro_torch.launch import train

    _card()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = ["--arch", "qwen2_7b", "--tiny", "--steps", "3", "--global-batch", "2", "--seq-len", "16"]
    plain = train.train(args)
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", "1", "-m", "repro_torch.launch.train",
                           "--distributed", *args], capture_output=True, text=True, cwd=root,
                          env=dict(os.environ, PYTHONPATH=os.path.join(root, "src")), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout[proc.stdout.index("{"):])
    assert got["steps"] == 3 and got["final_loss"] == plain["final_loss"]


@pytest.mark.cuda
def test_step_counter_counts_the_same_on_the_card():
    """``core.costs.StepCounter`` on CUDA tensors: a product's FLOPs are
    2·M·N·K and a copy's bytes its input and output exactly, as on the dry
    run's meta tensors, and the peak counts the live storages."""
    from repro_torch.core.costs import StepCounter

    dev = _card()
    M, K, N = 256, 384, 512
    a = torch.randn(M, K, device=dev, dtype=torch.bfloat16)
    b = torch.randn(K, N, device=dev, dtype=torch.bfloat16)
    for device in ("cuda", "meta"):
        x, y = (a, b) if device == "cuda" else (a.to("meta"), b.to("meta"))
        counter = StepCounter(device=device)
        counter.hold([x, y])
        with counter:
            c = x @ y
            d = c.clone()
        assert counter.flops == 2 * M * N * K
        assert counter.bytes_accessed == 2 * (M * K + K * N + M * N) + 2 * (2 * M * N)
        assert counter.peak_bytes == 2 * (M * K + K * N + 2 * M * N)
        assert counter.coll_bytes == 0 and d.shape == (M, N)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,H,Kh,hd,Skv", [(2, 256, 8, 2, 128, 256), (8, 1, 28, 4, 128, 2112),
                                              (2, 128, 16, 16, 64, 512)])
def test_sdpa_scores_take_the_bf16_product_form_on_the_card(B, Sq, H, Kh, hd, Skv):
    """The attention's scores from bf16 q and k multiplied with fp32 output
    (``aten::bmm.dtype``) against the upcast form's fp32 product: values at
    1e-6 of the largest score; on integer-valued data, where every sum is
    exact in fp32, the gradients of q and k equal the upcast form's (1e-5);
    and ``_sdpa``'s output against the upcast form's within two bf16 steps."""
    from repro_torch.models import attention as tattn

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = H // Kh
    qh = _randn(0, (B, Sq, Kh, g, hd), torch.bfloat16, dev)
    k = _randn(1, (B, Kh, Skv, hd), torch.bfloat16, dev)

    def upcast(qh_, k_):
        return torch.einsum("bqkgh,bksh->bkgqs", qh_.float(), k_.float())

    got, want = tattn._scores("bqkgh,bksh->bkgqs", qh, k), upcast(qh, k)
    assert got.dtype == torch.float32 and got.shape == want.shape and not got._is_view()
    assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()
    rng = np.random.RandomState(2)
    qi = torch.from_numpy(rng.randint(-4, 5, qh.shape)).bfloat16().to(dev)
    ki = torch.from_numpy(rng.randint(-4, 5, k.shape)).bfloat16().to(dev)
    w = torch.from_numpy(rng.randint(-3, 4, want.shape)).float().to(dev)
    grads = {}
    for name, form in (("bf16 product", lambda a, b: tattn._scores("bqkgh,bksh->bkgqs", a, b)),
                       ("upcast", upcast)):
        a, b = qi.clone().requires_grad_(), ki.clone().requires_grad_()
        (form(a, b) * w).sum().backward()
        grads[name] = (a.grad, b.grad)
    for got_, want_ in zip(grads["bf16 product"], grads["upcast"]):
        assert got_.dtype == torch.bfloat16
        torch.testing.assert_close(got_.float(), want_.float(), atol=1e-5, rtol=1e-5)
    q = qh.reshape(B, Sq, H, hd)
    v = _randn(3, (B, Kh, Skv, hd), torch.bfloat16, dev)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=dev)
    out = tattn._sdpa(q, k, v, mask)
    p = torch.softmax(upcast(qh, k) * (1.0 / math.sqrt(hd)), -1).to(v.dtype)
    ref = torch.einsum("bkgqs,bksh->bqkgh", p, v).reshape(B, Sq, H, hd)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama_3_2_vision_11b", "starcoder2_15b"])
def test_tiny_vlm_and_starcoder2_prefill_and_graph_decode_on_the_card(arch, monkeypatch):
    """Tiny llama-3.2-vision-11b (cross attention over the context) and
    starcoder2-15b (LayerNorm, the GELU MLP, q/k/v biases) in bf16 on the
    card: the prefill's last hidden state in the bf16 product form against
    the same prefill with the scores upcast first (within two bf16 steps of
    its magnitude), and every decode depth as a CUDA graph emitting the
    eager loop's tokens."""
    from repro_torch.launch.serve import DECODE_KS, DecodeGraphs
    from repro_torch.models import attention as tattn

    dev = _card()
    P, n = 16, 16
    model, prefill = _tiny_decoder(arch, dev, P=P)
    cfg = model.cfg
    gen = torch.Generator(device=dev).manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, P), generator=gen, device=dev), "max_len": P + 24}
    if cfg.family == "vlm":
        batch["ctx_embeds"] = 0.1 * torch.randn((2, cfg.ctx_tokens, cfg.d_model), generator=gen, device=dev)
    h_new, _ = model.prefill(batch)
    with monkeypatch.context() as m:
        m.setattr(tattn, "_scores", lambda eq, a, b: torch.einsum(eq, a.float(), b.float()))
        h_old, _ = model.prefill(batch)
    assert h_new.dtype == torch.bfloat16
    scale = h_old.float().abs().max().item()
    assert (h_new.float() - h_old.float()).abs().max().item() <= 2 ** -6 * scale
    tok, states = prefill()
    eager = []
    for i in range(n):
        logits, states = model.decode_step(tok, states, P + i)
        tok = logits.argmax(-1)[:, None]
        eager.append(tok)
    eager = torch.cat(eager, dim=1)
    for k in DECODE_KS:
        tok, states = prefill()
        run = DecodeGraphs(model, tok, states, P).build(k)
        token, states_, pos, got = tok, states, P, []
        for _ in range(n // k):
            token, states_, pos, toks = run(token, states_, pos)
            got.append(toks.clone())
        assert torch.equal(torch.cat(got, dim=1), eager), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", (1e-5, 1e-5)), ("bfloat16", (1e-3, 1e-2))])
@pytest.mark.parametrize("arch", ["seamless_m4t_large_v2", "moonshot_v1_16b_a3b"])
def test_tiny_family_train_step_on_the_card_kernel_path_matches_plain(arch, dtype, tol):
    """One ``make_train_step`` update (2 microbatches) of tiny seamless (the
    encoder on flash non-causal, the decoder's self-attention causal, the
    cross attention's scores in the bf16 product form under autograd in
    bf16) and tiny moonshot (flash causal, the MoE dispatch) on the kernel
    path against the plain path from the same weights: loss at tol[0] and
    gradient norm at tol[1] relative (fp32 1e-5; bf16 1e-3 and 1e-2, as
    ``chip_smoke.py`` holds the full-width models), and the flash launches
    the model implies: one per self-attention layer and encoder layer, per
    forward pass (the loss's, then one per microbatch)."""
    from repro_torch.data import make_batch_for
    from repro_torch.optim import AdamW
    from repro_torch.train import make_train_step

    dev = _card()
    metrics = {}
    for impl in ("cuda", "xla"):
        before = tfa.launches
        model = _tiny_train(arch, dev, impl, dtype)
        cfg = model.cfg
        batch = make_batch_for(cfg, 4, 32, step=0, seed=0, device=dev)
        opt = AdamW(lr=1e-3)
        params = model.params()
        _, _, metrics[impl] = make_train_step(model, opt, microbatches=2)(params, opt.init(params), batch)
        per_forward = sum(1 for kind in cfg.pattern if kind in ("attn", "cross")) + cfg.enc_layers
        assert tfa.launches - before == (2 * per_forward if impl == "cuda" else 0)
    for k, t in zip(("loss", "grad_norm"), tol):
        got, want = metrics["cuda"][k].item(), metrics["xla"][k].item()
        assert abs(got - want) <= t * abs(want), (k, got, want)


# ------------------------------------- latent attention and grouped experts
# (B, S, H, block, causal): latent attention's widths (query/key heads 192,
# value heads 128) on the tensor-core design, one and two consumer
# warpgroups, the ring turning, a non-causal pass, Moonlight's 16 heads
MLA_FLASH_SHAPES = [(1, 256, 2, 64, True), (2, 384, 3, 128, True), (1, 512, 2, 64, False),
                    (1, 1024, 16, 128, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,block,causal", MLA_FLASH_SHAPES)
def test_flash_wgmma_at_latent_attention_widths(B, S, H, block, causal):
    """q and k 192 wide, v 128 wide and strided as ``models/mla.py`` hands
    them in (k a transposed view, v the second half of each head's 256
    up-projected values): the tensor-core design, an output 128 wide, the
    plain version's values at the flash bf16 limit."""
    dev = _card()
    q = _randn(90, (B, S, H, 192), torch.bfloat16, dev)
    k = _randn(91, (B, S, H, 192), torch.bfloat16, dev).transpose(1, 2)
    v = _randn(92, (B, S, H, 256), torch.bfloat16, dev)[..., 128:].transpose(1, 2)
    by_design = dict(tfa.launches_by_design)
    got = ops.flash_attention(q, k, v, causal=causal, block_q=block, block_kv=block)
    assert _ran(tfa.launches_by_design, by_design) == "wgmma"
    assert got.shape == (B, S, H, 128) and got.is_contiguous()
    want = tfa.flash_attention_plain(q.transpose(1, 2), k, v, causal=causal, block_q=block,
                                     block_kv=block).transpose(1, 2)
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(), atol=5e-3, rtol=5e-3)


@pytest.mark.cuda
def test_flash_at_latent_attention_widths_refuses_what_it_cannot_run():
    dev = _card()
    q = _randn(93, (1, 128, 2, 192), torch.float32, dev)
    k = _randn(94, (1, 2, 128, 192), torch.float32, dev)
    v = _randn(95, (1, 2, 128, 128), torch.float32, dev)
    before = tfa.launches
    with pytest.raises(ValueError, match="tensor-core"):
        ops.flash_attention(q, k, v)  # fp32: no design at these widths
    with pytest.raises(ValueError, match="tensor-core"):
        ops.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), block_q=32, block_kv=32)
    assert tfa.launches == before


@pytest.mark.cuda
def test_grouped_experts_on_the_card_match_a_per_token_loop():
    """Drop-free grouped dispatch in bf16 at 9600 assignments (over the
    former capacity path's 8192), uneven loads and an expert with no token:
    every assignment's output against the expert applied to its token in
    fp32 (norm-wise 2e-2, bf16 products), and no host synchronisation."""
    import torch.nn.functional as F

    from repro_torch.models.moe import grouped_experts

    dev = _card()
    T, K, E, D, Fe = 1600, 6, 16, 256, 128
    x = _randn(96, (T, D), torch.bfloat16, dev)
    p = {"wi": _randn(97, (E, D, Fe), torch.bfloat16, dev, D ** -0.5),
         "wg": _randn(98, (E, D, Fe), torch.bfloat16, dev, D ** -0.5),
         "wo": _randn(99, (E, Fe, D), torch.bfloat16, dev, Fe ** -0.5)}
    logits = torch.from_numpy(np.random.RandomState(100).standard_normal((T, E))).to(dev)
    logits[:, 3] = -1e9  # expert 3 gets no token
    logits[:, 0] += 2.0  # expert 0 most of them
    expert = torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :K]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = grouped_experts(p, x, expert, E)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    xf = x.float()
    w = {n: t.float() for n, t in p.items()}
    want = torch.empty(T, K, D, device=dev)
    for t in range(T):
        e = expert[t]
        h = F.silu(xf[t] @ w["wg"][e]) * (xf[t] @ w["wi"][e])  # (K, Fe)
        want[t] = torch.bmm(h[:, None], w["wo"][e])[:, 0]
    rel = float((got.float() - want).norm() / want.norm())
    assert rel < 2e-2, rel


@pytest.mark.cuda
def test_moonlight_decode_graphs_give_the_eager_loops_tokens():
    """Latent attention's absorbed decode and the grouped experts capture as
    CUDA graphs: every depth emits the eager loop's tokens from a prefill
    on the flash kernel at (192, 128) (a 20-token prompt, padded to 64)."""
    from repro_torch.launch.serve import DECODE_KS, DecodeGraphs

    dev = _card()
    P, n = 20, 16
    model, prefill = _tiny_decoder("moonlight_16b_a3b", dev, P=P)
    before = tfa.launches_by_design["wgmma"]
    tok, states = prefill()
    assert tfa.launches_by_design["wgmma"] == before + len(model.cfg.pattern)
    assert states[0]["kv"]["kv"].shape[-1] == model.cfg.kv_lora_rank + model.cfg.qk_rope_dim
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
        token, states, pos = tok, states, P
        got = []
        for _ in range(n // k):
            token, states, pos, toks = run(token, states, pos)
            got.append(toks.clone())
        assert torch.equal(torch.cat(got, dim=1), eager), k
