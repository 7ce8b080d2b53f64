"""``decode_ops_per_step.decode`` on a synthetic trace: every device
operation (kernel, copy, memset) inside the ``bench.decode`` ranges, over the
decode steps of the traced batches; nothing where there is no trace, no
traced batch or no operation."""
import types

import pytest
import torch

from bench.harness.spec import metric_reader
from bench.harness.trace import parse


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    _ev("user_annotation", "bench.prefill", 0, 100),
    _ev("kernel", "rwkv_tc_kernel", 10, 30),  # prefill: not counted
    _ev("user_annotation", "bench.decode", 100, 100),
    _ev("kernel", "nvjet_tst_256x8_64x6_2x1_v_bz_NNT", 110, 5),
    _ev("kernel", "wkv_step_kernel", 116, 2),
    _ev("gpu_memcpy", "Memcpy DtoD", 120, 1),
    _ev("gpu_memset", "Memset", 130, 1),
    _ev("kernel", "cm_out_kernel", 150, 2),
    _ev("cpu_op", "cudaGraphLaunch", 105, 40),  # host: not counted
    _ev("user_annotation", "bench.decode", 300, 50),
    _ev("kernel", "argmax", 310, 1),
    _ev("kernel", "after", 400, 1),  # outside every phase
]


def _ctx(events, gens):
    served = [{"served": torch.zeros(8, 1 + g, dtype=torch.int64)} for g in gens]
    return types.SimpleNamespace(trace=parse(events) if events is not None else None, traced=served)


def test_counts_every_device_operation_inside_decode_over_the_steps():
    read = metric_reader("decode_ops_per_step.decode")
    assert read(_ctx(EVENTS, [2])) == pytest.approx(6 / 2)
    assert read(_ctx(EVENTS, [2, 4])) == pytest.approx(6 / 6)


@pytest.mark.parametrize("events, gens", [(None, [2]), (EVENTS, []),
                                          ([e for e in EVENTS if "decode" not in e["name"]], [2])])
def test_nothing_to_read(events, gens):
    assert metric_reader("decode_ops_per_step.decode")(_ctx(events, gens)) is None
