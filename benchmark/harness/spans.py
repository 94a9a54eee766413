"""The program's spans and counters (``srgan_tpu_torch/utils/spans.py``)
joined to a device trace of the same steps.

Kineto stamps the CUDA runtime's calls with ``time.time_ns()``'s clock and
has CUPTI stamp the device operations on it too, so the program's spans lie
on the trace as they are.  Each device operation is mapped to the runtime
call that launched it (the same correlation id), and goes to every span
whose interval holds that call's start, on any thread: autograd launches
the backward's kernels from a thread of its own while the step's thread
waits inside the span.  An idle gap of the device goes to the spans that
launched the operation ending it, the launch the device was waiting for.

The training runner's traced branch profiles its steps with the program's
recording off, so ``joined(ctx)`` profiles steps of its own: on the first
call from a reader it builds the cell's program again, warms it up and
profiles ``trace_steps`` steps under ``torch.profiler`` (device activity
and the runtime's calls, as the runner's trace) with the recording on.  It
returns None (and runs nothing) off a CUDA card, across cards, or where the
program has no recorder.
"""

from __future__ import annotations

import bisect
import gc
import importlib.util
import json
import sys
import time
from typing import NamedTuple, Optional

STEP = "train.step"
# the probe's weights and batches: its numbers are times and counts, which
# the values do not move
PROBE_SEED = 20170
PROBE_WARMUP = 2


class Op(NamedTuple):
    """A device operation, or a host event of the trace (a runtime or
    driver call, or the profiler's own work there), in ns."""
    name: str
    t0: int
    t1: int
    corr: int


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covered(segs, a: int, b: int) -> int:
    """ns of [a, b] that the merged segments cover."""
    return sum(max(0, min(b, y) - max(a, x)) for x, y in segs)


class Joined:
    """Spans (the recording's ``Span`` tuples or anything with ``name``,
    ``t0_ns``, ``t1_ns``), device operations and host events of one traced
    stretch of steps, and the recording's counters."""

    def __init__(self, spans, device_ops, host_ops, counters=None):
        self.spans = sorted(spans, key=lambda s: s.t0_ns)
        self.device_ops = sorted(device_ops, key=lambda o: o.t0)
        self.host_ops = list(host_ops)
        self.counters = dict(counters or {})
        # a call's correlation id also tags the profiler's own work inside
        # it (its buffer requests, lazy module loads): the call starts first
        calls = {}
        for o in self.host_ops:
            if o.corr:
                calls[o.corr] = min(o.t0, calls.get(o.corr, o.t0))
        # each device operation's launch on the host clock (None: no call)
        self.launch = [calls.get(o.corr) for o in self.device_ops]
        self._starts = [s.t0_ns for s in self.spans]

    @property
    def steps(self) -> int:
        return sum(s.name == STEP for s in self.spans)

    def holders(self, t: Optional[int]) -> list:
        """The spans whose interval holds ``t``."""
        if t is None:
            return []
        i = bisect.bisect_right(self._starts, t)
        return [s for s in self.spans[:i] if t <= s.t1_ns]

    def _launched_in(self, name: str) -> list:
        """Indices of the device operations launched inside a ``name``
        span."""
        return [i for i, t in enumerate(self.launch)
                if any(s.name == name for s in self.holders(t))]

    def busy_segments(self, t0: int, t1: int):
        return _merge((max(o.t0, t0), min(o.t1, t1))
                      for o in self.device_ops if o.t1 > t0 and o.t0 < t1)

    def idle_gaps(self, t0: int, t1: int):
        """(start, end, index of the operation ending the gap) for every
        gap between the device's busy segments within [t0, t1]."""
        gaps, end = [], None
        for i, o in enumerate(self.device_ops):
            if o.t1 <= t0 or o.t0 >= t1:
                continue
            if end is not None and o.t0 > end:
                gaps.append((end, o.t0, i))
            end = o.t1 if end is None else max(end, o.t1)
        return gaps

    def window(self):
        """From the start of the first operation launched in the first
        step to the end of the last launched in the last; None without
        one."""
        ops = [self.device_ops[i] for i in self._launched_in(STEP)]
        if not ops:
            return None
        return min(o.t0 for o in ops), max(o.t1 for o in ops)

    def summary(self) -> dict:
        """By span name: how many, host ms, device ms and count of the
        operations launched inside, idle ms charged to them (the gaps of
        the steps' window)."""
        out = {}
        for s in self.spans:
            row = out.setdefault(s.name, {"n": 0, "host_ms": 0.0,
                                          "device_ms": 0.0, "ops": 0,
                                          "idle_ms": 0.0})
            row["n"] += 1
            row["host_ms"] += (s.t1_ns - s.t0_ns) / 1e6
        for o, t in zip(self.device_ops, self.launch):
            for name in {s.name for s in self.holders(t)}:
                out[name]["device_ms"] += (o.t1 - o.t0) / 1e6
                out[name]["ops"] += 1
        win = self.window()
        for a, b, i in (self.idle_gaps(*win) if win else []):
            for name in {s.name for s in self.holders(self.launch[i])}:
                out[name]["idle_ms"] += (b - a) / 1e6
        return out

    # ---- the per-layer metrics, each a step's worth, None without steps
    def device_ms(self, name: str) -> Optional[float]:
        if not self.steps:
            return None
        return sum(self.device_ops[i].t1 - self.device_ops[i].t0
                   for i in self._launched_in(name)) / 1e6 / self.steps

    def launches(self) -> Optional[float]:
        if not self.steps:
            return None
        return len(self._launched_in(STEP)) / self.steps

    def host_ms(self) -> Optional[float]:
        """Host ms a step inside ``train.step`` outside every host event
        of the trace (the runtime's calls, over all threads, counted
        once)."""
        if not self.steps:
            return None
        calls = _merge((o.t0, o.t1) for o in self.host_ops)
        own = sum((s.t1_ns - s.t0_ns) - _covered(calls, s.t0_ns, s.t1_ns)
                  for s in self.spans if s.name == STEP)
        return own / 1e6 / self.steps

    def step_idle(self) -> Optional[float]:
        """% of the steps' window with no device operation."""
        win = self.window()
        if win is None or win[1] <= win[0]:
            return None
        busy = sum(b - a for a, b in self.busy_segments(*win))
        return 100.0 * (1.0 - busy / (win[1] - win[0]))

    def counted(self, *names: str) -> Optional[float]:
        """The counters ``names`` a step, summed over the steps."""
        if not self.steps:
            return None
        return sum(v for (n, step), v in self.counters.items()
                   if n in names and step is not None) / self.steps


def from_kineto(kineto_results, rec) -> Joined:
    """A ``Joined`` of a recording and the kineto events of a profile of
    the same steps."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in kineto_results.events():
        op = Op(e.name(), e.start_ns(), e.end_ns(), e.correlation_id())
        (dev if e.device_type() == DeviceType.CUDA else host).append(op)
    return Joined(rec.spans, dev, host, rec.counters)


def _recorder():
    if importlib.util.find_spec("srgan_tpu_torch.utils.spans") is None:
        return None
    from srgan_tpu_torch.utils import spans

    return spans


def probe(config: dict, device, steps: int) -> Optional[Joined]:
    """The configuration's program built afresh on ``device``,
    ``PROBE_WARMUP`` steps, then ``steps`` launched back to back and
    profiled with the program's recording on; None where the program has
    no recorder."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness import common
    from benchmark.harness.train import Program, make_pool

    spans = _recorder()
    if spans is None:
        return None
    prog = Program(config, PROBE_SEED, device)
    pool = make_pool(config, {"pool_batches": 2}, PROBE_SEED, device)
    try:
        for i in range(PROBE_WARMUP):
            prog.step(pool[i % len(pool)])
        common.sync(device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with spans.recording() as rec:
                for i in range(steps):
                    prog.step(pool[i % len(pool)])
            common.sync(device)
        return from_kineto(prof.profiler.kineto_results, rec)
    finally:
        del prog, pool
        gc.collect()
        torch.cuda.empty_cache()


def joined(ctx) -> Optional[Joined]:
    """The run's ``Joined``, probed on the first call; None off a CUDA
    card, across cards, without the runner's trace or without the
    program's recorder.  The first call also prints the spans' summary
    and the sums the metrics rest on to stderr."""
    if "spans_joined" not in vars(ctx):
        j = None
        if ctx.device.type == "cuda" and ctx.chips == 1 and \
                ctx.get("trace") is not None:
            t = time.perf_counter()
            j = probe(ctx.config, ctx.device, ctx.trace_steps)
            probe_s = time.perf_counter() - t
        ctx.spans_joined = j
        if j is not None:
            print("spans: " + json.dumps(dict(report(j, ctx.trace),
                                              probe_s=probe_s)),
                  file=sys.stderr)
    return ctx.spans_joined


def longest_gaps(j: Joined) -> list:
    """The 5 longest idle gaps of the whole profile, from its first
    event to its last: [ms, the host event running at the gap's start,
    the innermost span that launched the operation ending it ("none" for
    the profile's end), whether the gap lies in the steps' window]."""
    every = j.device_ops + j.host_ops
    if not j.device_ops:
        return []
    t0, t1 = min(o.t0 for o in every), max(o.t1 for o in every)
    win = j.window() or (t1, t0)
    gaps = j.idle_gaps(t0, t1)
    gaps.append((t0, j.device_ops[0].t0, 0))
    gaps.append((max(o.t1 for o in j.device_ops), t1, None))

    def host_at(t):
        held = [o for o in j.host_ops if o.t0 <= t < o.t1]
        return max(held, key=lambda o: o.t0).name[:60] if held else "none"

    def launched_by(i):
        held = j.holders(None if i is None else j.launch[i])
        return max(held, key=lambda s: s.t0_ns).name if held else "none"

    return [[(b - a) / 1e6, host_at(a), launched_by(i),
             win[0] <= a and b <= win[1]]
            for a, b, i in sorted(gaps, key=lambda g: g[0] - g[1])[:5]
            if b > a]


def trace_gaps(trace) -> list:
    """The 5 longest idle gaps of the runner's own trace
    (``harness.trace.Trace``, which holds no spans): [ms, the host event
    running at the gap's start, where it lies: before the first device
    operation, after the last, or between two]."""
    segs = trace.busy_segments()
    if not segs:
        return []
    edges = [trace.t0] + [x for seg in segs for x in seg] + [trace.t1]
    gaps = sorted(((edges[i + 1] - edges[i], i)
                   for i in range(0, len(edges) - 1, 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:5]
    return [[1e3 * dur, trace.host_at(edges[i]),
             "before the first operation" if i == 0 else
             "after the last operation" if i == len(edges) - 2 else
             "between operations"] for dur, i in gaps]


def report(j: Joined, trace) -> dict:
    """The summary by span name, and a step's worth of what the metrics'
    sums are checked against: the device's busy ms in the steps' window,
    its operations there and the kernels named ``cbinorm`` among them; the
    device operations of the whole profile whose launch fell outside every
    step, or was not found; the profile's longest idle gaps, and those of
    the runner's own ``trace``."""
    n = max(j.steps, 1)
    win = j.window() or (0, 0)
    in_win = [o for o in j.device_ops if o.t0 >= win[0] and o.t1 <= win[1]]
    return {"steps": j.steps, "by_name": j.summary(),
            "busy_ms": sum(b - a for a, b in j.busy_segments(*win))
            / 1e6 / n,
            "window_ops": len(in_win) / n,
            "cbinorm_kernels": sum("cbinorm" in o.name for o in in_win) / n,
            "launched_outside_steps": sum(
                not any(s.name == STEP for s in j.holders(t))
                for t in j.launch),
            "longest_gaps": longest_gaps(j),
            "runner_gaps": trace_gaps(trace)}
