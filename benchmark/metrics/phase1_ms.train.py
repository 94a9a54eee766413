"""Device ms a step of the operations launched inside the program's
``train.phase1`` spans, phase 1 (the k-th D update and the joint G/E
gradient of errG + errE), over the steps that ``harness/spans.py``
profiles with the program's recording on."""

from benchmark.harness.spans import joined


def read(ctx):
    j = joined(ctx)
    return None if j is None else j.device_ms("train.phase1")
