"""Device ms an operation of the sort kernels (matched by name) that
were launched inside the local join's spans, the mean over the ranks.
Both are in ``layers/sort_kernels.json``: the spans are ``join`` and
``join_agg``, the fused join and aggregate step, so the partition's
sort of its bucket ids is not counted, and in a query the aggregate's
sorts inside ``join_agg`` are."""

import json
from pathlib import Path

from joinbench.layers._common import kernel_ms, per_op_mean

SPEC = json.loads((Path(__file__).parent / "sort_kernels.json").read_text())


def read(ctx):
    return per_op_mean(ctx, kernel_ms(SPEC["patterns"], SPEC["spans"]))
