"""Device ms an operation of NCCL's kernels (matched by name) that were
launched inside the port's ``shuffle`` spans, the mean over the ranks:
the wire alone, where ``shuffle_ms_per_op`` also holds the packing,
unpadding and concatenation around it. NCCL's collectives outside a
``shuffle`` span (the ladder's count reductions) are not counted, and a
run without NCCL (one chip, gloo) reads nothing."""

from joinbench.layers._common import kernel_ms, per_op_mean

# ``ncclDevKernel_*`` since NCCL 2.19, ``ncclKernel_*`` before it
PATTERNS = ("^ncclDevKernel_", "^ncclKernel_")
SPANS = ("shuffle",)


def read(ctx):
    return per_op_mean(ctx, kernel_ms(PATTERNS, SPANS))
