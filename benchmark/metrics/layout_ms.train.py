"""Device ms a step in cuDNN's NCHW <-> NHWC layout transposes, over the
profiled steps."""


def read(ctx):
    t = ctx.get("trace")
    if t is None:
        return None
    return 1e3 * t.seconds_by().get("layout_transpose", 0.0) / ctx.trace_steps
