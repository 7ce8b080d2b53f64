"""The RWKV-6 scan forward's least time over its device time in the traced
prefill, in percent.  One call a layer at (batch, prompt, heads, head
width); work by ``costs.rwkv_fwd_work``; device time of the kernels named
below inside the ``bench.prefill`` ranges."""
from bench.harness.costs import least_seconds, rwkv_fwd_work

KERNELS = ("rwkv_tc_kernel", "rwkv_kernel")


def read(ctx):
    if ctx.trace is None or not getattr(ctx, "traced", None):
        return None
    seconds, n = ctx.trace.kernel_seconds(KERNELS, "prefill")
    if not n:
        return None
    s, t = ctx.sizes, ctx.traffic
    least = sum(s["n_layers"] * least_seconds(rwkv_fwd_work(t["batch"], d["P"], s["n_heads"],
                                                            s["d_head"]), ctx.peaks)
                for d in ctx.traced)
    return 100.0 * least / seconds
