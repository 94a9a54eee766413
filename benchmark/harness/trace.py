"""The reduction of a ``torch.profiler`` trace to what the per-layer metrics
read: every device operation with its interval, the union of those
intervals (the device's busy time) within the traced window, device time by
kernel group, and the longest idle gaps with what the host was doing."""

from __future__ import annotations

import re
from contextlib import contextmanager

# kernel names of the layout transposes cuDNN runs around a convolution,
# and of cuDNN's convolutions and cuBLAS's matrix products
TRANSPOSE_RE = re.compile(r"nchwToNhwc|nhwcToNchw", re.I)
CONV_RE = re.compile(r"conv|cudnn|xmma|gemm|implicit|dgrad|wgrad|fprop|"
                     r"cutlass", re.I)
NCCL_RE = re.compile(r"nccl", re.I)


def group(name: str) -> str:
    """The kernel group of a device operation's name, tested in this
    order: the norm kernels, the histogram and diversification kernels,
    NCCL, cuDNN's layout transposes, convolutions and matrix products, the
    rest."""
    if "cbinorm" in name:
        return "norm"
    if "histogram" in name or "diversification" in name:
        return "histogram_diversification"
    if NCCL_RE.search(name):
        return "nccl"
    if TRANSPOSE_RE.search(name):
        return "layout_transpose"
    if CONV_RE.search(name):
        return "conv_matmul"
    return "rest"


class Trace:
    """Device operations [(name, start_s, end_s)] and host operations
    [(name, start_s, end_s)] of one traced window, in seconds on the
    profiler's clock, clipped to the window [t0, t1]."""

    def __init__(self, device_ops, host_ops, t0: float, t1: float):
        self.device_ops = [(n, max(a, t0), min(b, t1))
                           for n, a, b in device_ops if b > t0 and a < t1]
        self.host_ops = host_ops
        self.t0, self.t1 = t0, t1

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_segments(self):
        segs = []
        for _, a, b in sorted(self.device_ops, key=lambda e: e[1]):
            if segs and a <= segs[-1][1]:
                segs[-1][1] = max(segs[-1][1], b)
            else:
                segs.append([a, b])
        return segs

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_segments())

    def seconds_by(self, key=group) -> dict:
        out = {}
        for n, a, b in self.device_ops:
            k = key(n)
            out[k] = out.get(k, 0.0) + (b - a)
        return out

    def breakdown(self, n: int = 10) -> dict:
        by_name = sorted(self.seconds_by(lambda s: s[:160]).items(),
                         key=lambda kv: -kv[1])[:n]
        edges = [self.t0] + [x for seg in self.busy_segments()
                             for x in seg] + [self.t1]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:n]
        return {"device_ops": [[k, v] for k, v in by_name],
                "idle_gaps": [[self.host_at(start), dur]
                              for dur, start in gaps]}

    def host_at(self, t: float) -> str:
        """The innermost host operation running at ``t``."""
        best = None
        for n, a, b in self.host_ops:
            if a <= t < b and (best is None or a > best[1]):
                best = (n, a)
        return best[0][:160] if best else "no host operation"


@contextmanager
def profiled(device):
    """Profile the block on ``device``; yields a holder whose ``trace`` is
    set on exit (None where the device is not CUDA or the profiler recorded
    no device operation)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    holder = type("Holder", (), {"trace": None})()
    if device.type != "cuda":
        yield holder
        return
    torch.cuda.synchronize(device)
    # device activity and the CUDA runtime's calls only: recording every
    # host operator as well slows a launch-heavy step by half
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("bench.window_start"):
            pass
        yield holder
        torch.cuda.synchronize(device)
        with torch.profiler.record_function("bench.window_end"):
            pass
    dev, host, marks = [], [], {}
    for e in prof.events():
        a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == DeviceType.CUDA:
            dev.append((e.name, a, b))
        elif e.name.startswith("bench.window_"):
            marks[e.name] = a
        else:
            host.append((e.name, a, b))
    if dev:
        # the window's marks, where the profiler kept them; else the span of
        # everything it recorded, from the first runtime call to the final
        # synchronisation
        every = dev + host
        t0 = marks.get("bench.window_start", min(a for _, a, _ in every))
        t1 = marks.get("bench.window_end", max(b for _, _, b in every))
        holder.trace = Trace(dev, host, t0, t1)
