"""Device time of the backward pass in a traced training step, in ms: the
program's ``train.backward`` spans (``train/step.py``, one a microbatch),
timed by the CUDA events each records on the stream at its start and end,
summed over a step and averaged over the traced steps."""
from bench.harness.spans import device_ms_per_step


def read(ctx):
    if ctx.trace is None:
        return None
    return device_ms_per_step("train.backward", len(ctx.trace.phase_spans("train")))
