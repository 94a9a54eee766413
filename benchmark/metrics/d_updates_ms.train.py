"""Device ms a step of the operations launched inside the program's
``train.d_update`` spans, each of the k - 1 unrolled D updates (the
no-grad G forward and the D step), over the steps that
``harness/spans.py`` profiles with the program's recording on."""

from benchmark.harness.spans import joined


def read(ctx):
    j = joined(ctx)
    return None if j is None else j.device_ms("train.d_update")
