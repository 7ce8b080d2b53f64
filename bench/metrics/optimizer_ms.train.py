"""Device time of the optimizer's update in a traced training step, in ms:
the program's ``train.optimizer`` span (``train/step.py``), timed by the
CUDA events it records on the stream at its start and end, averaged over
the traced steps (the program's tracer keeps the spans of the traced
segment, the only part of a run under the profiler)."""
from bench.harness.spans import device_ms_per_step


def read(ctx):
    if ctx.trace is None:
        return None
    return device_ms_per_step("train.optimizer", len(ctx.trace.phase_spans("train")))
