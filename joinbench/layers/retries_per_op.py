"""Retry rungs an operation climbed in the traced stretch, from the
program's own records: a join result's ``retry_report``, a query's
attempts (count)."""


def read(ctx):
    r = ctx.rank0["retries"]
    return sum(r) / len(r) if r else None
