"""One run of one cell: set-up, the measured window, the traced segment
(``--trace 1``), then the comparison with the reference that decides
``correct``.  Device-agnostic: ``bench/run.py`` refuses to start without
the card; the tests drive this on the CPU at tiny sizes."""
from __future__ import annotations

import sys
import time
import types

import torch

from . import serve, train
from .costs import H100
from .spec import metric_reader
from .trace import profile

__all__ = ["run_cell", "checks"]


def checks(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} of every number the cell holds to a limit."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def _peak() -> int:
    return torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0


def _reset_peak() -> None:
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()


def _train(cell, seed, seconds, trace, device, started):
    t = cell.traffic
    run = train.build(cell, seed, device)
    readings = train.first_steps(run, t["ref_steps"])
    setup_s = time.perf_counter() - started
    setup_peak = _peak()
    _reset_peak()
    win = train.run_window(run, seconds)
    ctx = types.SimpleNamespace(cell=cell, sizes=cell.sizes, traffic=t, window=win,
                                peaks=H100, peak_window_bytes=_peak(), trace=None)
    if trace:
        ctx.trace = profile(lambda: [run.step() for _ in range(t["trace_steps"])])
    peak = max(setup_peak, _peak())
    train.free(run)
    numbers = train.compare(readings, train.reference(cell, seed, device))
    e2e = {"train_tokens_per_s": win["positions"] / win["seconds"], "setup_s": setup_s}
    return ctx, e2e, win["steps"], win["failed"], peak, numbers


def _serve(cell, seed, seconds, trace, device, started):
    t = cell.traffic
    run = serve.build(cell, seed, device)
    setup_s = time.perf_counter() - started
    win = serve.run_window(run, seconds)
    ctx = types.SimpleNamespace(cell=cell, sizes=cell.sizes, traffic=t, window=win,
                                batches=list(run.done), peaks=H100, trace=None, traced=[])
    if trace:
        from .inputs import prompt_lengths

        i = len(run.done)
        P = prompt_lengths(t, seed, i + 1)[i]
        ctx.trace = profile(lambda: ctx.traced.append(serve.serve_one(run, i, P,
                                                                      t["trace_gen"])))
    peak = _peak()
    pairs = serve.sample(run, t["sample"])
    serve.free(run)
    numbers = {"logit_gap": serve.gaps(run, pairs)["program"]}
    e2e = {"prefill_tokens_per_s": win["prefill_positions"] / win["prefill_s"],
           "decode_tokens_per_s": win["decode_tokens"] / win["decode_s"], "setup_s": setup_s}
    return ctx, e2e, win["requests"], 0, peak, numbers


def run_cell(cell, seed: int, seconds: float, trace: bool, device, started: float) -> dict:
    """The result line's object (keys ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, with a trace ``breakdown``, and ``checks``
    last).  ``started`` is the host clock at the process's start."""
    run = {"train": _train, "serve": _serve}[cell.traffic["kind"]]
    ctx, e2e, attempted, failed, peak, numbers = run(cell, seed, seconds, trace, device, started)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": peak}
    result = {"correct": False, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": info}
    if ctx.trace is not None:
        w0, w1 = ctx.trace.window
        info["busy_s"] = ctx.trace.busy_seconds()
        info["window_s"] = w1 - w0
        result["breakdown"] = ctx.trace.breakdown()
    if cell.traffic["kind"] == "serve":
        per_batch = [(d["P"], round(d["prefill_s"], 4), round(d["decode_s"], 3)) for d in ctx.batches]
        print(f"window: {ctx.window} batches (prompt, prefill s, decode s): {per_batch}",
              file=sys.stderr)
    compared = checks(numbers, cell.limits)
    result["correct"] = bool(compared) and failed == 0 and all(
        c["value"] <= c["limit"] for c in compared.values())
    result["checks"] = compared
    return result
