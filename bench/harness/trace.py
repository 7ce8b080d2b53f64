"""What a ``torch.profiler`` trace of a short traced segment says: the
device's busy time (the union of kernel, copy and memset intervals, as the
program's smoke check reads it), each phase's idle share, the device time
of kernels by name, and the breakdown the result line carries.

Phases are the harness's own ``record_function`` ranges named
``bench.<phase>`` around each call into the program; a phase's device
work lies inside its range, since every phase ends by waiting for the card.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from collections import defaultdict

__all__ = ["Trace", "profile", "union", "parse"]

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "python_function")


def union(spans) -> list:
    """Sorted, merged (start, end) intervals of ``spans``."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(merged, lo: float, hi: float) -> float:
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged)


@dataclasses.dataclass
class Trace:
    """Times in seconds on the trace's clock."""
    device: list  # (name, start, end)
    host: list  # (name, start, end)
    phases: list  # (phase, start, end)

    def __post_init__(self):
        self._busy = union((s, e) for _, s, e in self.device)

    @property
    def window(self) -> tuple:
        return (min(s for _, s, _ in self.phases), max(e for _, _, e in self.phases))

    def busy_seconds(self, lo=None, hi=None) -> float:
        w0, w1 = self.window
        return _overlap(self._busy, w0 if lo is None else lo, w1 if hi is None else hi)

    def phase_spans(self, phase: str) -> list:
        return [(s, e) for p, s, e in self.phases if p == phase]

    def idle_share(self, phase: str):
        """Time with no device work over the phase's time, in percent, or
        None when the trace holds no such phase."""
        spans = self.phase_spans(phase)
        total = sum(e - s for s, e in spans)
        if not spans or total <= 0:
            return None
        busy = sum(self.busy_seconds(s, e) for s, e in spans)
        return 100.0 * (total - busy) / total

    def kernel_seconds(self, names, phase: str) -> tuple:
        """(device seconds, kernels) of the kernels whose name contains one
        of ``names``, inside the ranges of ``phase``."""
        spans = self.phase_spans(phase)
        total, count = 0.0, 0
        for name, s, e in self.device:
            if any(n in name for n in names) and any(lo <= s and e <= hi + 1e-6
                                                     for lo, hi in spans):
                total += e - s
                count += 1
        return total, count

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the innermost host activity around each gap's middle."""
        by_op = defaultdict(float)
        for name, s, e in self.device:
            by_op[name[:160]] += e - s
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        w0, w1 = self.window
        gaps, prev = [], w0
        for s, e in self._busy:
            if s > prev:
                gaps.append((prev, min(s, w1)))
            prev = max(prev, e)
        if prev < w1:
            gaps.append((prev, w1))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        named = []
        for s, e in gaps:
            mid = 0.5 * (s + e)
            around = [(he - hs, name) for name, hs, he in self.host if hs <= mid <= he]
            phase = [p for p, ps, pe in self.phases if ps <= mid <= pe]
            label = min(around)[1] if around else "host idle"
            if phase:
                label = f"{label} in bench.{phase[0]}"
            named.append([label[:160], e - s])
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}


def parse(events: list) -> Trace:
    device, host, phases = [], [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev["dur"]) * 1e-6
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat in _DEVICE_CATS:
            device.append((name, s, e))
        elif cat == "user_annotation" and name.startswith("bench."):
            phases.append((name[len("bench."):], s, e))
        elif cat in _HOST_CATS:
            host.append((name, s, e))
    return Trace(device, host, phases)


def profile(fn) -> Trace:
    """Run ``fn`` under ``torch.profiler`` (host and device), then read the
    trace; the trace file lives in a temporary directory under ``TMPDIR``
    and is removed."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with _profile(activities=activities) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    return parse(events)
