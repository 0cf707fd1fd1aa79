"""Device ms an operation of the work launched inside the port's
``join_agg`` spans (the fused join and aggregate), the mean over the
ranks."""

from joinbench.layers._common import per_op_mean, span_ms


def read(ctx):
    return per_op_mean(ctx, span_ms("join_agg"))
