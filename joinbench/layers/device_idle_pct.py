"""The share of rank 0's traced stretch with no kernel, copy or set on
its device: 100 * (1 - busy / window), busy the union of the device
events' intervals (%)."""


def read(ctx):
    t = ctx.rank0.get("trace") or {}
    if not t.get("n_ops") or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
