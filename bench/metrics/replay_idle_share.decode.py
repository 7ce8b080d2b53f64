"""Share of the device's idle time in the traced decode that falls inside
the program's ``graphs.replay`` ranges (``launch/serve.py::DecodeGraphs``:
a chunk's state loads and its graph's launch), in percent: idle inside
those ranges over all idle inside the harness's ``bench.decode`` ranges,
idle being a range's length less the device's busy time in it.  Read only
where the program's decode spans are in the trace (a ``tuner.begin``
inside ``bench.decode``); a decode that replays no graph reads 0."""
from bench.harness.spans import idle_seconds, ranges


def read(ctx):
    if ctx.trace is None or not ranges(ctx.trace, "decode", lambda n: n == "tuner.begin"):
        return None
    idle = sum(idle_seconds(ctx.trace, s, e) for s, e in ctx.trace.phase_spans("decode"))
    if idle <= 0:
        return None
    replays = ranges(ctx.trace, "decode", lambda n: n == "graphs.replay")
    return 100.0 * sum(idle_seconds(ctx.trace, s, e) for _, s, e in replays) / idle
