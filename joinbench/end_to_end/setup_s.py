"""From the start of the command's process (rank 0, which starts the
others) to the first timed operation: imports, the process group, the
inputs, the kernels' build or load and the warm-up (s)."""


def read(ctx):
    return ctx.rank0["setup_s"]
