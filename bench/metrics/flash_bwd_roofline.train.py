"""Flash attention's backward: least time over device time in the traced
training steps, in percent.  Per step one call a layer: the encoder's
(frames × frames, not causal) and the decoder's self-attention (tokens ×
tokens, causal); work by ``costs.flash_bwd_work``; device time of the
kernels named below inside the ``bench.train`` ranges."""
from bench.harness.costs import flash_bwd_work, least_seconds

KERNELS = ("dq_wgmma_kernel", "dkdv_wgmma_kernel", "dkdv_sum_kernel", "dq_simt_kernel",
           "dkdv_simt_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    seconds, n = ctx.trace.kernel_seconds(KERNELS, "train")
    steps = len(ctx.trace.phase_spans("train"))
    if not n or not steps:
        return None
    s, t = ctx.sizes, ctx.traffic
    B, H, Kh, hd = t["batch"], s["n_heads"], s["n_kv_heads"], s["d_head"]
    F, S = t.get("frames", 0), t["seq_len"]
    least = s["enc_layers"] * least_seconds(flash_bwd_work(B, H, Kh, F, F, hd, False), ctx.peaks)
    least += s["n_layers"] * least_seconds(flash_bwd_work(B, H, Kh, S, S, hd, True), ctx.peaks)
    return 100.0 * steps * least / seconds
