"""The device's idle share from the start of the first operation launched
in the first profiled ``train.step`` span to the end of the last launched
in the last: the window's edges and the profiler's work outside the steps
fall outside it.  Over the steps that ``harness/spans.py`` profiles with
the program's recording on."""

from benchmark.harness.spans import joined


def read(ctx):
    j = joined(ctx)
    return None if j is None else j.step_idle()
