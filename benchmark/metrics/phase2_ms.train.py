"""Device ms a step of the operations launched inside the program's
``train.phase2`` spans, phase 2 (G's step on the style regression and D's
snapshot restore), over the steps that ``harness/spans.py`` profiles with
the program's recording on."""

from benchmark.harness.spans import joined


def read(ctx):
    j = joined(ctx)
    return None if j is None else j.device_ms("train.phase2")
