"""The routed experts' grouped products: least time over device time in the
traced prefill, in percent.  Each MoE layer runs its assignments (batch ×
prompt × top-k) as grouped products (``torch._grouped_mm``: a
``prepare_grouped_gemm_data`` kernel and a CUTLASS grouped GEMM, whose name
holds ``GroupProblemShape``, a product); work by
``moe_mla_work.grouped_experts_work``; device time of those kernels inside
the ``bench.prefill`` ranges."""
from bench.harness.costs import least_seconds
from bench.harness.moe_mla_work import grouped_experts_work

KERNELS = ("GroupProblemShape", "prepare_grouped_gemm_data")


def read(ctx):
    if ctx.trace is None or not getattr(ctx, "traced", None):
        return None
    seconds, n = ctx.trace.kernel_seconds(KERNELS, "prefill")
    if not n:
        return None
    s, t = ctx.sizes, ctx.traffic
    layers = s["n_layers"] - s["first_dense_layers"]
    least = sum(layers * least_seconds(grouped_experts_work(
        t["batch"] * d["P"] * s["top_k"], s["d_model"], s["d_ff_expert"], s["n_experts"]),
        ctx.peaks) for d in ctx.traced)
    return 100.0 * least / seconds
