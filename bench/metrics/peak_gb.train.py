"""The most device memory the program held during the window's training
steps (``torch.cuda.max_memory_allocated`` after a reset at the window's
start), in GB."""


def read(ctx):
    peak = getattr(ctx, "peak_window_bytes", 0)
    return peak / 1e9 if peak else None
