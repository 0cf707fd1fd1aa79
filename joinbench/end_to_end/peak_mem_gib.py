"""``torch.cuda.max_memory_allocated()`` over the window, reset at the
window's start, the largest over the ranks (GiB)."""


def read(ctx):
    peak = max(r["window_peak"] for r in ctx.ranks)
    return peak / 2**30 if peak else None
