"""The whole step's share of the chips' peak: the plain reference's FLOPs
of one step at the cell's shapes, times the steps of the traced run's
unprofiled part, over its seconds, over the peak of all chips used in the
configuration's compute dtype."""

from benchmark.reference.peaks import peak_flops


def read(ctx):
    peak = peak_flops(ctx.card, ctx.config["train"]["compute_dtype"])
    if ctx.get("steps") is None or peak is None:
        return None
    rate = ctx.work["flops"] * ctx.steps / ctx.seconds
    return 100.0 * rate / (peak * ctx.chips)
