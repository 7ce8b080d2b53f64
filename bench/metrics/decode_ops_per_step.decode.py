"""Device operations per decode step in the traced batch: the kernels,
copies and memsets inside the harness's ``bench.decode`` ranges, over the
tokens decoded there (the steps, as ``moe_ms.decode.py`` counts them).  Each
is a node of a replayed decode graph, or a launch of the chunk's own work
(routing, state loads); the count shows how many launches a step costs the
card, whatever their names."""


def read(ctx):
    if ctx.trace is None or not getattr(ctx, "traced", None):
        return None
    _, ops = ctx.trace.kernel_seconds(("",), "decode")  # every name contains ""
    steps = sum(d["served"].shape[1] - 1 for d in ctx.traced)
    if not ops or not steps:
        return None
    return ops / steps
