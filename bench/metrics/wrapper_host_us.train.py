"""Host time of a kernel wrapper call in the traced training steps, in us:
the mean length of the program's ``ops.<kernel>.fwd`` / ``.bwd`` ranges
(``kernels/ops.py``, each ``autograd.Function``'s forward and backward)
inside the harness's ``bench.train`` ranges of the profiler's trace."""
from bench.harness.spans import ranges


def read(ctx):
    if ctx.trace is None:
        return None
    calls = ranges(ctx.trace, "train", lambda n: n.startswith("ops."))
    if not calls:
        return None
    return 1e6 * sum(e - s for _, s, e in calls) / len(calls)
