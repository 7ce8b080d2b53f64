"""Host time of routing a decode chunk in the traced batch, in us: the
program's ``tuner.begin`` (the decision) and ``tuner.observe`` (its
feedback) ranges (``runtime/online.py``) inside the harness's
``bench.decode`` ranges of the profiler's trace, summed, over the routed
chunks (one ``tuner.begin`` each)."""
from bench.harness.spans import ranges


def read(ctx):
    if ctx.trace is None:
        return None
    spans = ranges(ctx.trace, "decode", lambda n: n in ("tuner.begin", "tuner.observe"))
    chunks = sum(n == "tuner.begin" for n, _, _ in spans)
    if not chunks:
        return None
    return 1e6 * sum(e - s for _, s, e in spans) / chunks
