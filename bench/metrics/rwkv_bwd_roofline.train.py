"""The RWKV-6 scan backward's least time over its device time in the traced
training steps, in percent.  Work per call from the call shape (one call a
layer a step: batch, sequence, heads, head width) by ``costs.rwkv_bwd_work``;
device time of the kernels named below inside the ``bench.train`` ranges."""
from bench.harness.costs import least_seconds, rwkv_bwd_work

KERNELS = ("rwkv_bwd_kernel",)


def read(ctx):
    if ctx.trace is None:
        return None
    seconds, n = ctx.trace.kernel_seconds(KERNELS, "train")
    steps = len(ctx.trace.phase_spans("train"))
    if not n or not steps:
        return None
    s, t = ctx.sizes, ctx.traffic
    work = rwkv_bwd_work(t["batch"], t["seq_len"], s["n_heads"], s["d_head"])
    return 100.0 * steps * s["n_layers"] * least_seconds(work, ctx.peaks) / seconds
