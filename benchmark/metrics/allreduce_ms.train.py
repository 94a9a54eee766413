"""Rank 0's device ms a step in NCCL kernels (the gradient all-reduce and
the batch-global losses' collectives), over the profiled steps."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or ctx.chips < 2:
        return None
    return 1e3 * t.seconds_by().get("nccl", 0.0) / ctx.trace_steps
