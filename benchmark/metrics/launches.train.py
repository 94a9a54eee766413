"""Device operations (kernels, copies, memsets) a step whose runtime call
falls inside a ``train.step`` span, over the steps that
``harness/spans.py`` profiles with the program's recording on."""

from benchmark.harness.spans import joined


def read(ctx):
    j = joined(ctx)
    return None if j is None else j.launches()
