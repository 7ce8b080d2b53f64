"""Share of the traced decode phases in which the device ran no kernel, copy or
memset, in percent (the union of device intervals inside the harness's
``bench.decode`` ranges)."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.idle_share("decode")
