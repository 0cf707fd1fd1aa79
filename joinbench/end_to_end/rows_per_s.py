"""Input rows of every operation completed in the window, over the
window's seconds, over the chips: a join counts its build and probe rows
on every rank, a query the rows of its base tables (Mrows/s)."""


def read(ctx):
    r = ctx.rank0
    return r["ops"] * r["rows_per_op"] / r["window_s"] / ctx.chips / 1e6
