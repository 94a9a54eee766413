"""The norm's applications a step, forward and backward: the program's
counters ``norm.fwd`` and ``norm.bwd`` (one a call of ``cbinorm_fwd`` or
``cbinorm_bwd``), over the steps that ``harness/spans.py`` profiles with
the program's recording on."""

from benchmark.harness.spans import joined


def read(ctx):
    j = joined(ctx)
    return None if j is None else j.counted("norm.fwd", "norm.bwd")
