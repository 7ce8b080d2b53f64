"""Model FLOPs of the window's training steps over the window's time and the
card's bf16 peak, in percent (the model step: ``models/``, ``train/``,
``optim/``).  The FLOPs are the configuration's own count, by its reference
(``bench/reference/<name>.py::model_flops``)."""


def read(ctx):
    win, t = ctx.window, ctx.traffic
    if not win.get("steps"):
        return None
    flops = win["steps"] * ctx.cell.reference().model_flops(
        ctx.sizes, batch=t["batch"], tokens=t["seq_len"], frames=t.get("frames", 0), train=True)
    return 100.0 * flops / (win["seconds"] * ctx.peaks.bf16_flops)
