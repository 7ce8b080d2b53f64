"""Flash attention's forward at latent attention's widths (query/key heads
d_head + rope, value heads d_head): least time over device time in the
traced prefill, in percent.  One causal call a layer over the prompt; work
by ``moe_mla_work.mla_flash_fwd_work``; device time of the tensor-core
flash kernel (the only design at these widths) inside the
``bench.prefill`` ranges."""
from bench.harness.costs import least_seconds
from bench.harness.moe_mla_work import mla_flash_fwd_work

KERNELS = ("flash_wgmma_kernel",)


def read(ctx):
    if ctx.trace is None or not getattr(ctx, "traced", None):
        return None
    seconds, n = ctx.trace.kernel_seconds(KERNELS, "prefill")
    if not n:
        return None
    s, t = ctx.sizes, ctx.traffic
    hd = s["d_head"]
    least = sum(s["n_layers"] * least_seconds(mla_flash_fwd_work(
        t["batch"], s["n_heads"], d["P"], hd + s["qk_rope_dim"], hd), ctx.peaks)
        for d in ctx.traced)
    return 100.0 * least / seconds
