"""Share of the program's MoE ranges in the traced prefill in which the
device ran no kernel, copy or memset, in percent: the ``moe.route``,
``moe.experts`` and ``moe.combine`` spans (``models/moe.py``) inside the
``bench.prefill`` ranges, idle over their summed length.  A host
synchronisation in the dispatch drains the device and shows here."""
from bench.harness.spans import idle_seconds, ranges


def read(ctx):
    if ctx.trace is None:
        return None
    spans = ranges(ctx.trace, "prefill", lambda n: n.startswith("moe."))
    total = sum(e - s for _, s, e in spans)
    if total <= 0:
        return None
    return 100.0 * sum(idle_seconds(ctx.trace, s, e) for _, s, e in spans) / total
