"""Device ms a step in cuDNN's and cuBLAS's convolution and matrix
kernels, over the profiled steps."""


def read(ctx):
    t = ctx.get("trace")
    if t is None:
        return None
    return 1e3 * t.seconds_by().get("conv_matmul", 0.0) / ctx.trace_steps
