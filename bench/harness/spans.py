"""The program's own spans in a traced segment.

The port's ``repro_torch.obs`` spans enter the profiler's trace as
``user_annotation`` ranges beside the harness's ``bench.<phase>`` ranges,
so ``Trace.host`` holds them by name on the device's clock; its phase spans
(``train.*``) also keep CUDA event marks on the port's tracer.  Against a
program without such spans each reader here finds nothing: it returns an
empty list or None and does not raise.
"""
from __future__ import annotations

__all__ = ["ranges", "idle_seconds", "device_ms_per_step"]


def ranges(trace, phase: str, match) -> list:
    """(name, start, end) of the host ranges whose name satisfies ``match``
    and that lie inside a range of ``phase``."""
    spans = trace.phase_spans(phase)
    return [(n, s, e) for n, s, e in trace.host
            if match(n) and any(lo <= s and e <= hi + 1e-6 for lo, hi in spans)]


def idle_seconds(trace, s: float, e: float) -> float:
    """Time in [s, e] with no kernel, copy or memset on the device."""
    return (e - s) - trace.busy_seconds(s, e)


def device_ms_per_step(name: str, steps: int):
    """Device milliseconds of the program's ``name`` spans in each of its
    last ``steps`` ``train.step`` spans (summed within a step, as a step
    with several microbatches has several), averaged over the steps; None
    where the tracer holds fewer steps or a span has no device marks."""
    import torch
    from repro_torch.obs.trace import tracer

    if steps <= 0:
        return None
    done = tracer().finished()
    ids = [s.span_id for s in done if s.name == "train.step"][-steps:]
    if len(ids) < steps:
        return None
    if torch.cuda.is_available():
        torch.cuda.synchronize()  # the marks resolve only once the stream passed them
    per_step = dict.fromkeys(ids, 0.0)
    for s in done:
        if s.name == name and s.parent_id in per_step:
            ms = s.device_ms
            if ms is None:
                return None
            per_step[s.parent_id] += ms
    return sum(per_step.values()) / steps
