"""Device time of the routed experts' grouped products per decode step in
the traced batch, in ms: the kernels of ``torch._grouped_mm`` (named as in
``moe_roofline.prefill.py``) inside the ``bench.decode`` ranges, over the
tokens decoded there.  Read by kernel name: the decode steps replay CUDA
graphs, which carry no program spans."""
KERNELS = ("GroupProblemShape", "prepare_grouped_gemm_data")


def read(ctx):
    if ctx.trace is None or not getattr(ctx, "traced", None):
        return None
    seconds, n = ctx.trace.kernel_seconds(KERNELS, "decode")
    steps = sum(d["served"].shape[1] - 1 for d in ctx.traced)
    if not n or not steps:
        return None
    return 1e3 * seconds / steps
