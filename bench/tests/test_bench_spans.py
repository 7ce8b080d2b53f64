"""The per-layer metrics that read the program's own spans: on a tiny cell
traced on the CPU the three that read the profiler's trace give a number
and the two that read device marks give None; on synthetic traces their
arithmetic, and None where the program left no span."""
import time
import types

import pytest

from bench.harness import spans
from bench.harness.cell_run import run_cell
from bench.harness.spec import metric_reader
from bench.harness.trace import parse
from bench.tests.tiny import tiny_cell

TRACE_READ = {"rwkv6_7b.train": ["wrapper_host_us.train"],
              "seamless_m4t_large_v2.train": ["wrapper_host_us.train"],
              "rwkv6_7b.serve": ["route_us.decode", "replay_idle_share.decode"],
              "seamless_m4t_large_v2.serve": ["route_us.decode", "replay_idle_share.decode"]}
MARKS_READ = ["optimizer_ms.train", "backward_ms.train"]


@pytest.mark.parametrize("name", sorted(TRACE_READ))
def test_tiny_cell_reads_the_program_spans(name):
    cell = tiny_cell(name)
    listed = {m["name"] for m in cell.per_layer}
    assert set(TRACE_READ[name]) <= listed
    out = run_cell(cell, 2**31 + 5, 0.3, True, "cpu", time.perf_counter())
    for metric in TRACE_READ[name]:
        assert isinstance(out["metrics"][metric]["value"], float)
    if name.endswith(".train"):
        assert set(MARKS_READ) <= listed
        assert not set(MARKS_READ) & set(out["metrics"])  # no device marks on the CPU


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


DECODE = [
    _ev("user_annotation", "bench.decode", 0, 100),
    _ev("user_annotation", "tuner.begin", 0, 4),
    _ev("user_annotation", "graphs.replay", 4, 16),  # idle 4..10, busy 10..20
    _ev("kernel", "decode_step", 10, 40),
    _ev("user_annotation", "tuner.observe", 50, 2),
    _ev("user_annotation", "tuner.begin", 52, 4),
    _ev("user_annotation", "graphs.replay", 56, 14),  # idle 56..60, busy 60..70
    _ev("kernel", "decode_step", 60, 30),
    _ev("user_annotation", "tuner.observe", 90, 6),
    _ev("user_annotation", "ops.rwkv.fwd", 200, 10),  # outside every phase
]


def test_decode_readers_on_a_synthetic_trace():
    ctx = types.SimpleNamespace(trace=parse(DECODE))
    # idle: 0..10, 50..60, 90..100 = 30 us; inside the replays 6 + 4 us
    assert metric_reader("replay_idle_share.decode")(ctx) == pytest.approx(100 * 10 / 30)
    assert metric_reader("route_us.decode")(ctx) == pytest.approx((4 + 2 + 4 + 6) / 2)
    assert spans.idle_seconds(ctx.trace, 0, 100e-6) == pytest.approx(30e-6)


def test_readers_find_nothing_without_program_spans():
    bare = [e for e in DECODE if e["cat"] != "user_annotation" or e["name"].startswith("bench.")]
    bare.append(_ev("user_annotation", "bench.train", 200, 50))
    ctx = types.SimpleNamespace(trace=parse(bare))
    for name in ("replay_idle_share.decode", "route_us.decode", "wrapper_host_us.train"):
        assert metric_reader(name)(ctx) is None
    assert all(metric_reader(n)(types.SimpleNamespace(trace=None)) is None
               for n in MARKS_READ + ["wrapper_host_us.train", "route_us.decode"])


def test_wrapper_host_time_inside_train_ranges():
    ctx = types.SimpleNamespace(trace=parse([
        _ev("user_annotation", "bench.train", 0, 100),
        _ev("user_annotation", "ops.flash.fwd", 10, 20),
        _ev("user_annotation", "ops.flash.bwd", 60, 40),
        _ev("user_annotation", "ops.flash.fwd", 150, 500),  # after the phase: not read
        _ev("kernel", "k", 0, 1),
    ]))
    assert metric_reader("wrapper_host_us.train")(ctx) == pytest.approx(30.0)


class _Span:
    def __init__(self, name, span_id, parent_id, device_ms=None):
        self.name, self.span_id, self.parent_id, self.device_ms = (name, span_id, parent_id,
                                                                   device_ms)


def test_device_ms_per_step_sums_microbatches_over_the_last_steps(monkeypatch):
    from repro_torch.obs import trace as tr

    done = [_Span("train.backward", 2, 1, 9.0), _Span("train.step", 1, None),  # older step
            _Span("train.backward", 4, 3, 1.0), _Span("train.backward", 5, 3, 2.0),
            _Span("train.optimizer", 6, 3, 5.0), _Span("train.step", 3, None),
            _Span("train.backward", 8, 7, 4.0), _Span("train.optimizer", 9, 7, 7.0),
            _Span("train.step", 7, None)]
    monkeypatch.setattr(tr.tracer(), "finished", lambda: list(done))
    assert spans.device_ms_per_step("train.backward", 2) == pytest.approx((3.0 + 4.0) / 2)
    assert spans.device_ms_per_step("train.optimizer", 2) == pytest.approx(6.0)
    assert spans.device_ms_per_step("train.optimizer", 4) is None  # fewer steps than traced
    done[-2].device_ms = None  # a span without marks
    assert spans.device_ms_per_step("train.optimizer", 2) is None
