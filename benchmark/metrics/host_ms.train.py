"""Host ms a step inside the program's ``train.step`` spans outside the
CUDA runtime's calls (their union over all threads taken out): the host's
own cost, the floor it sets on the step; over the steps that
``harness/spans.py`` profiles with the program's recording on."""

from benchmark.harness.spans import joined


def read(ctx):
    j = joined(ctx)
    return None if j is None else j.host_ms()
