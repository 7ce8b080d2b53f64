"""The frozen FLOP and byte arithmetic against hand counts at the published
widths: each configuration's model FLOPs (its reference's ``model_flops``)
and the kernels' least times."""
import pytest

from bench.harness import costs
from bench.harness.spec import load_cell

RWKV_CELL = load_cell("rwkv6_7b.train")
SEAMLESS_CELL = load_cell("seamless_m4t_large_v2.train")
RWKV, SEAMLESS = RWKV_CELL.sizes, SEAMLESS_CELL.sizes


def test_rwkv_train_step_flops():
    d, ff = 4096, 14336
    weights = 5 * d * d + d * 160 + 160 * d + 2 * d * 64 + 2 * d * ff + d * d
    assert weights == 219_938_816
    per_tok = 17 * (2 * weights + 4 * 64 * 64 * 64) + 2 * 4096 * 65536
    got = RWKV_CELL.reference().model_flops(RWKV, batch=1, tokens=2048, train=True)
    assert got == 3 * 2048 * per_tok
    assert got == pytest.approx(49.35e12, rel=1e-3)


def test_rwkv_counts_its_low_rank_widths_from_the_configuration():
    count = RWKV_CELL.reference().model_flops
    wider = dict(RWKV, mix_lora_rank=64, decay_lora_rank=128)
    extra = 17 * 2 * (d := 4096) * (2 * 5 * 32 + 2 * 64)
    assert count(wider, batch=1, tokens=1) - count(RWKV, batch=1, tokens=1) == extra == 2 * 17 * d * 448
    with pytest.raises(ValueError):
        count(RWKV, batch=1, tokens=8, frames=4)


def test_seamless_prefill_flops():
    d, ff, F, T = 1024, 8192, 4096, 4
    enc = 24 * F * (2 * (4 * d * d + 2 * d * ff) + 4 * F * d)
    cross_kv = 24 * F * 4 * d * d
    dec = 24 * (T * 2 * (6 * d * d + 2 * d * ff) + 4 * (T * (T + 1) / 2) * d + 4 * T * F * d)
    head = 2 * d * 256256
    got = SEAMLESS_CELL.reference().model_flops(SEAMLESS, batch=8, tokens=T, frames=F,
                                                last_only=True)
    assert got == pytest.approx(8 * (enc + cross_kv + dec + head), rel=1e-12)


def test_a_count_refuses_sizes_its_model_does_not_have():
    grouped = dict(SEAMLESS, n_kv_heads=4)
    with pytest.raises(ValueError):
        SEAMLESS_CELL.reference().model_flops(grouped, batch=1, tokens=8, frames=16)


def test_kernel_bounds_match_the_kernel_table():
    """The least times PERF.md's kernel table gives for these shapes."""
    bwd = costs.rwkv_bwd_work(1, 2048, 64, 64)
    assert bwd[0] == pytest.approx(7.52e9, rel=1e-3)
    n = 2048 * 64 * 64
    assert bwd[2] == 7 * n * 2 + 2 * n * 4 + 2 * 64 * 64 * 4 + 3 * 64 * 64 * 64 * 4
    assert costs.least_seconds(bwd) == pytest.approx(bwd[2] / 3.35e12)  # bytes, not 0.1122 ms
    flops, kind, nbytes = costs.rwkv_fwd_work(8, 2048, 64, 64)
    assert kind == "tf32" and nbytes == pytest.approx(822e6, rel=1e-3)
    assert costs.least_seconds(costs.rwkv_fwd_work(8, 2048, 64, 64)) * 1e3 == pytest.approx(
        0.2454, abs=1e-4)
    enc = costs.flash_fwd_work(8, 16, 16, 4096, 4096, 64, False)
    assert costs.least_seconds(enc) * 1e3 == pytest.approx(0.5559, abs=1e-4)
    bwd = costs.flash_bwd_work(3, 16, 16, 4096, 4096, 64, False)
    assert bwd[0] == pytest.approx(515.4e9, rel=1e-3)
    assert costs.least_seconds(bwd) * 1e3 == pytest.approx(0.5211, abs=1e-4)


def test_flash_bytes_read_key_value_heads():
    """Grouped heads: k and v (and dk, dv) move at ``Kh`` heads, q and o at ``H``."""
    B, H, Kh, S, hd = 1, 28, 4, 2048, 128
    assert costs.flash_fwd_work(B, H, Kh, S, S, hd, True)[2] == (2 * S * H * hd + 2 * S * Kh * hd) * 2
    full = costs.flash_bwd_work(B, H, H, S, S, hd, True)
    grouped = costs.flash_bwd_work(B, H, Kh, S, S, hd, True)
    assert full[0] == grouped[0] and full[2] - grouped[2] == 4 * S * (H - Kh) * hd * 2


def test_causal_pairs():
    assert costs._pairs(4, 4, True) == 10 and costs._pairs(4, 4, False) == 16
