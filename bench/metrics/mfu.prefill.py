"""Model FLOPs of the window's prefills (the LM head at the last position
only) over all prefill time and the card's bf16 peak, in percent.  The
FLOPs are the configuration's own count, by its reference
(``bench/reference/<name>.py::model_flops``)."""


def read(ctx):
    t = ctx.traffic
    batches = getattr(ctx, "batches", [])
    if not batches:
        return None
    count = ctx.cell.reference().model_flops
    flops = sum(count(ctx.sizes, batch=t["batch"], tokens=d["P"], frames=t.get("frames", 0),
                      last_only=True) for d in batches)
    return 100.0 * flops / (sum(d["prefill_s"] for d in batches) * ctx.peaks.bf16_flops)
