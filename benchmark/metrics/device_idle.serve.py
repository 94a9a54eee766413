"""The share of the profiled part of the serving window with no operation
on the device (the union of the device operations' intervals)."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
