"""A whole run at tiny sizes on the CPU: the result line has exactly the
contract's keys, the cell's metrics with their units, and the numbers
compared last, each with its limit."""
import time

import pytest

from bench.harness.cell_run import run_cell
from bench.tests.tiny import tiny_cell

CELLS = ["rwkv6_7b.train", "seamless_m4t_large_v2.train", "rwkv6_7b.serve",
         "seamless_m4t_large_v2.serve"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_result_line(name, trace):
    cell = tiny_cell(name)
    out = run_cell(cell, 2**31 + 11, 0.5, bool(trace), "cpu", time.perf_counter())
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device"] + (
        ["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    want = cell.per_layer if trace else cell.end_to_end
    units = {m["name"]: m["unit"] for m in want}
    assert set(out["metrics"]) <= set(units)
    if not trace:
        assert set(out["metrics"]) == set(units)
    for k, v in out["metrics"].items():
        assert v["unit"] == units[k] and isinstance(v["value"], float)
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert out["device"]["window_s"] > 0
    assert out["checks"] and all(c["limit"] is not None for c in out["checks"].values())
