"""CUDA graphs of the train step's segments (``GANTrainer.step`` on one CUDA
device).

A ``Segment`` is one captured part of the step: its graph, the tensors the
captured code returned (each replay rewrites them in place), and the counts
that code gave ``spans.count`` (``spans.tallied``), which each replay gives
again, since a replay runs none of the code.  The capture adds nothing to
the counts, so the counters of a replayed step, the kernels' launches
(``launch.*``) among them, are an eager step's, in the totals and in a
recording alike.

``CudaGraph`` is the one place the CUDA graph API is called, and the seam
the CPU tests stand in for.
"""

from __future__ import annotations

import torch

from srgan_tpu_torch.utils import spans


class CudaGraph:
    """A ``torch.cuda.CUDAGraph`` in the memory ``pool`` it shares with the
    step's other segments, ``generator`` registered with it: each replay
    draws what the captured code would draw eagerly from the generator's
    state at that point, and moves that state on as the code would."""

    @staticmethod
    def pool():
        """A new memory pool for the segments of one step."""
        return torch.cuda.graph_pool_handle()

    def __init__(self, pool, generator: torch.Generator):
        self.pool = pool
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(generator)

    def capture(self, fn):
        """``fn()``'s launches recorded into the graph, not run; returns
        its outputs.  Only this thread is held to the capture's rules
        (autograd's own thread launches the backward into it)."""
        with torch.cuda.graph(self.graph, pool=self.pool,
                              capture_error_mode="thread_local"):
            return fn()

    def replay(self):
        self.graph.replay()


class Segment:
    """``fn`` captured into a ``CudaGraph``; ``out`` holds its outputs."""

    def __init__(self, fn, pool, generator: torch.Generator):
        self.graph = CudaGraph(pool, generator)
        with spans.tallied() as counts:
            self.out = self.graph.capture(fn)
        self.counts = counts

    def replay(self):
        """Launch the graph and count what ``fn`` would have counted."""
        self.graph.replay()
        for name, n in self.counts.items():
            spans.count(name, n)
