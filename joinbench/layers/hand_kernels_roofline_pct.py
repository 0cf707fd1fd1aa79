"""The port's hand-written kernels (``layers/kernels/*.json``) against
their bounds: the sum of the bound times over the sum of the device
times of their launches, over every rank's traced stretch (%).

A kernel's bound counts its contract's work from each operation's own
rows and results (``work``, from the reference: positions scanned,
survivors kept, rows expanded), never from padding or capacities, times
the file's bytes and operations a unit, at the H100's peaks
(``frozen/bounds.py``). A kernel with no launch in the trace adds
nothing to either sum; with none at all, nothing is read."""

import re

from joinbench.frozen.bounds import bound_ms


def read(ctx):
    bound = device = 0.0
    for spec in ctx.kernels.values():
        rx = re.compile(spec["match"])
        dev_ms = 0.0
        for r in ctx.ranks:
            t = r.get("trace") or {}
            if not t.get("n_ops"):
                continue
            dev_ms += 1e3 * sum(s for n, s in t["kernel_s"].items()
                                if rx.search(n))
        if dev_ms <= 0:
            continue
        ops = ctx.rank0["trace"]["n_ops"]
        work = ctx.rank0["work"]
        nbytes = sum(c * work[k] for k, c in spec["bytes"].items())
        nops = sum(c * work[k] for k, c in spec["ops"].items())
        bound += ops * bound_ms(nbytes, nops)[0]
        device += dev_ms
    return 100.0 * bound / device if device > 0 else None
