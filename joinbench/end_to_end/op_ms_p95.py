"""The 95th percentile, by nearest rank, of every operation's time in
the window from issue to completion (the entry returned and the device
synchronised), on the host clock of rank 0 (ms)."""

import math


def read(ctx):
    lat = sorted(ctx.rank0["latencies"])
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
