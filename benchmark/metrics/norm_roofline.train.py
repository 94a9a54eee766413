"""The norm kernels' share of their roofline: the least time of every
norm application of one step (the reference's list, from the
architecture: each input read once and each output written once at the
HBM rate) over the device time a step of the kernels named ``cbinorm``.
Across cards the trace is rank 0's, which normalises its share of the
batch: the step's bound over the cards."""


def read(ctx):
    t = ctx.get("trace")
    if t is None:
        return None
    spent_ms = 1e3 * t.seconds_by().get("norm", 0.0) / ctx.trace_steps
    if spent_ms <= 0:
        return None
    return 100.0 * ctx.work["norm_bound_ms"] / ctx.chips / spent_ms
