"""One intra-op thread for the port's CPU tests.

Tier-1 runs the suite in six pytest-xdist workers on one host. With
torch's default intra-op pool (a thread a core) in each worker, and the
loader's decode threads and the prefetch thread calling into it, the
workers oversubscribe the host: an in-process ``train_gan`` of
``tests/test_torch_loop.py`` took 80-200 times as long as alone. Every
``tests/test_torch_*.py`` imports this module before anything else, so
every process that collects them computes on one thread; ``env`` gives
the subprocesses they start the same cap.
"""

import os

import torch

torch.set_num_threads(1)

THREAD_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def env(**extra) -> dict:
    """``os.environ`` with one intra-op thread, plus ``extra``."""
    return {**os.environ, **THREAD_ENV, **extra}
