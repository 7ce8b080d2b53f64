"""The trace reading on a synthetic trace."""
import pytest

from bench.harness.trace import parse, union


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    _ev("user_annotation", "bench.prefill", 0, 100),
    _ev("user_annotation", "bench.decode", 100, 100),
    _ev("kernel", "void rwkv_tc_kernel<64>", 10, 30),
    _ev("kernel", "gemm", 20, 40),  # overlaps the first: the union counts it once
    _ev("gpu_memcpy", "Memcpy DtoH", 90, 5),
    _ev("gpu_memset", "Memset", 150, 10),
    _ev("cpu_op", "aten::argmax", 60, 30),
    _ev("cpu_op", "cudaGraphLaunch", 110, 80),
    _ev("user_annotation", "other", 0, 300),
]


def test_union_merges_overlaps():
    assert union([(3, 4), (0, 2), (1, 3)]) == [[0, 4]]


def test_busy_idle_and_window():
    tr = parse(EVENTS)
    assert tr.window == pytest.approx((0.0, 200e-6))
    assert tr.busy_seconds() == pytest.approx(65e-6)  # 50 + 5 + 10
    assert tr.idle_share("prefill") == pytest.approx(45.0)
    assert tr.idle_share("decode") == pytest.approx(90.0)
    assert tr.idle_share("train") is None


def test_kernels_by_name_inside_a_phase():
    tr = parse(EVENTS)
    assert tr.kernel_seconds(("rwkv_tc_kernel",), "prefill") == pytest.approx((30e-6, 1))
    assert tr.kernel_seconds(("rwkv_tc_kernel",), "decode") == (0.0, 0)


def test_breakdown():
    bd = parse(EVENTS).breakdown()
    assert set(bd) == {"device_ops", "idle_gaps"}
    assert bd["device_ops"][0] == ["gemm", pytest.approx(40e-6)]
    gaps = bd["idle_gaps"]
    assert len(gaps) == 4 and gaps[0][1] == pytest.approx(55e-6)  # 95..150
    assert gaps[0][0] == "cudaGraphLaunch in bench.decode"
