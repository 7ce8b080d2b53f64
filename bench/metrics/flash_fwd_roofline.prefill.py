"""Flash attention's forward: least time over device time in the traced
prefill, in percent.  One call an encoder layer over the frames, not
causal; work by ``costs.flash_fwd_work``; device time of the kernels named
below inside the ``bench.prefill`` ranges."""
from bench.harness.costs import flash_fwd_work, least_seconds

KERNELS = ("flash_wgmma_kernel", "flash_kernel")


def read(ctx):
    if ctx.trace is None or not getattr(ctx, "traced", None):
        return None
    seconds, n = ctx.trace.kernel_seconds(KERNELS, "prefill")
    if not n:
        return None
    s, t = ctx.sizes, ctx.traffic
    F = t["frames"]
    work = flash_fwd_work(t["batch"], s["n_heads"], s["n_kv_heads"], F, F, s["d_head"], False)
    return 100.0 * len(ctx.traced) * s["enc_layers"] * least_seconds(work, ctx.peaks) / seconds
