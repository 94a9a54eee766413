"""The join of the program's spans to a device trace (``harness/spans.py``)
on fabricated events, its readers without spans, and on the card the
shared clock and the probe at a toy size."""

import time
from typing import NamedTuple

import pytest

from benchmark.harness import common
from benchmark.harness.readers import Context, load_reader
from benchmark.harness.spans import STEP, Joined, Op, probe
from benchmark.tests.tiny import tiny_config

NEW = ("host_ms.train", "launches.train", "d_updates_ms.train",
       "phase1_ms.train", "phase2_ms.train", "step_idle.train",
       "norm_launches.train")


class S(NamedTuple):
    name: str
    t0_ns: int
    t1_ns: int


def two_steps():
    """Two steps of [0, 100) and [100, 200) ns with a D update and a
    phase each; a launch call of 2 ns before every operation."""
    spans = [S(STEP, 0, 100), S("train.d_update", 10, 50),
             S("train.phase1", 50, 90), S(STEP, 100, 200),
             S("train.d_update", 110, 150), S("train.phase1", 150, 190)]
    launches = {1: 20, 2: 60, 3: 120, 4: 160}
    host = [Op("cudaLaunchKernel", t, t + 2, c) for c, t in launches.items()]
    dev = [Op("k1", 30, 70, 1), Op("k2", 75, 110, 2), Op("k3", 130, 170, 3),
           Op("k4", 180, 240, 4)]
    return spans, dev, host


def test_an_operation_goes_to_the_spans_holding_its_launch():
    spans, dev, host = two_steps()
    # k2's launch comes from another thread while phase 1 waits: matched by
    # time alone
    host[1] = Op("cudaLaunchKernelExC", 55, 58, 2)
    j = Joined(spans, dev, host, {})
    assert j.steps == 2
    assert j.device_ms("train.d_update") == pytest.approx((40 + 40) / 2e6)
    assert j.device_ms("train.phase1") == pytest.approx((35 + 60) / 2e6)
    assert j.device_ms(STEP) == pytest.approx(175 / 2e6)
    assert j.launches() == 2
    by = j.summary()
    assert by[STEP]["ops"] == 4 and by["train.phase1"]["ops"] == 2
    assert by[STEP]["n"] == 2 and by[STEP]["host_ms"] == pytest.approx(2e-4)
    # an operation without its call, or launched outside every step
    j = Joined(spans, dev + [Op("lost", 1, 2, 99), Op("late", 250, 260, 5)],
               host + [Op("cudaMemsetAsync", 245, 246, 5)], {})
    assert j.launches() == 2
    assert j.window() == (30, 240)


def test_an_idle_gap_goes_to_the_span_that_launched_its_end():
    spans, dev, host = two_steps()
    j = Joined(spans, dev, host, {})
    # gaps: 70-75 (ended by k2, launched in step 1's phase 1), 110-130
    # (ended by k3, launched in step 2's D update) and 170-180 (ended by
    # k4, launched in step 2's phase 1)
    assert [(a, b) for a, b, _ in j.idle_gaps(*j.window())] == \
        [(70, 75), (110, 130), (170, 180)]
    by = j.summary()
    assert by["train.d_update"]["idle_ms"] == pytest.approx(20e-6)
    assert by["train.phase1"]["idle_ms"] == pytest.approx(15e-6)
    assert by[STEP]["idle_ms"] == pytest.approx(35e-6)


def test_host_ms_takes_out_overlapping_calls_once():
    spans = [S(STEP, 0, 100)]
    host = [Op("cudaLaunchKernel", 10, 30, 1),
            # the same stretch on autograd's thread, and a nested event
            Op("cudaLaunchKernel", 20, 40, 2),
            Op("Activity Buffer Request", 25, 35, 2),
            # half outside the step
            Op("cudaDeviceSynchronize", 90, 120, 0)]
    j = Joined(spans, [], host, {})
    assert j.host_ms() == pytest.approx((100 - 30 - 10) / 1e6)


def test_step_idle_leaves_the_edges_out():
    spans, dev, host = two_steps()
    # the profiler's buffer work before the first step's first operation
    # and a synchronisation after the last: far from the window
    dev = [Op("early", -500, -400, 0)] + dev + [Op("sync", 900, 901, 0)]
    j = Joined(spans, dev, host, {})
    assert j.window() == (30, 240)
    assert j.step_idle() == pytest.approx(100 * 35 / 210)


def test_counters_a_step():
    spans, dev, host = two_steps()
    counters = {("norm.fwd", 1): 143, ("norm.fwd", 4): 143,
                ("norm.bwd", 1): 59, ("norm.bwd", 4): 59,
                ("norm.fwd", None): 17}
    j = Joined(spans, dev, host, counters)
    assert j.counted("norm.fwd", "norm.bwd") == 202


def test_the_runner_gaps_say_where_they_lie():
    from benchmark.harness.spans import trace_gaps
    from benchmark.harness.trace import Trace

    trace = Trace([("a", 1.0, 2.0), ("b", 2.25, 3.0)],
                  [("cudaDeviceSynchronize", 3.0, 4.5)], 0.5, 4.5)
    assert trace_gaps(trace) == [
        [1500.0, "cudaDeviceSynchronize", "after the last operation"],
        [500.0, "no host operation", "before the first operation"],
        [250.0, "no host operation", "between operations"]]


def _ctx(**kw):
    import torch

    base = dict(config=tiny_config("srgan_full"), chips=1,
                device=torch.device("cpu"), trace=None, trace_steps=3)
    return Context(**{**base, **kw})


@pytest.mark.parametrize("name", NEW)
def test_every_new_reader_is_none_without_spans(name):
    read = load_reader(common.BENCH_DIR / "metrics", name)
    # off the card: nothing is probed
    assert read(_ctx()) is None
    # a run whose probe found no recorder, or recorded no step
    assert read(_ctx(spans_joined=None)) is None
    assert read(_ctx(spans_joined=Joined([], [], [], {}))) is None


def test_every_new_reader_reads_the_join():
    spans, dev, host = two_steps()
    j = Joined(spans, dev, host, {("norm.fwd", 1): 3, ("norm.bwd", 4): 1})
    got = {n: load_reader(common.BENCH_DIR / "metrics", n)(
        _ctx(spans_joined=j)) for n in NEW}
    assert got == {"host_ms.train": pytest.approx(96e-6),
                   "launches.train": 2,
                   "d_updates_ms.train": pytest.approx(40e-6),
                   "phase1_ms.train": pytest.approx(47.5e-6),
                   "phase2_ms.train": 0.0,
                   "step_idle.train": pytest.approx(100 * 35 / 210),
                   "norm_launches.train": 2}


@pytest.mark.card
def test_a_span_holds_its_kernel_launch_on_the_card(cuda_device):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from srgan_tpu_torch.utils import spans

    x = torch.ones(1 << 20, device=cuda_device)
    x.add_(1)
    torch.cuda.synchronize(cuda_device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with spans.recording() as rec:
            with spans.span("around"):
                x.add_(1)
        torch.cuda.synchronize(cuda_device)
    (around,) = rec.named("around")
    events = prof.profiler.kineto_results.events()
    calls = [e for e in events if e.name() == "cudaLaunchKernel"]
    assert len(calls) == 1
    assert around.t0_ns <= calls[0].start_ns() <= calls[0].end_ns() \
        <= around.t1_ns
    kernels = [e for e in events if e.device_type() == DeviceType.CUDA
               and e.correlation_id() == calls[0].correlation_id()]
    assert kernels and kernels[0].start_ns() >= calls[0].start_ns()


@pytest.mark.card
def test_the_probe_at_a_toy_size_on_the_card(cuda_device):
    t = time.perf_counter()
    j = probe(tiny_config("srgan_full", "bfloat16", k=3), cuda_device, 2)
    assert time.perf_counter() - t < 300
    assert j.steps == 2
    by = j.summary()
    assert by["train.d_update"]["n"] == 4 and by["train.optimizer"]["n"] == 10
    # every operation of the profile was launched inside a step
    assert all(any(s.name == STEP for s in j.holders(t)) for t in j.launch)
    # the step's own operations outside its phases (the batch's layout
    # and labels, the metrics) are a larger share at a toy size
    phases = sum(j.device_ms(n) for n in ("train.d_update", "train.phase1",
                                          "train.phase2"))
    assert phases == pytest.approx(j.device_ms(STEP), rel=0.05)
    assert j.counted("norm.fwd", "norm.bwd") > 0
    assert 0 <= j.step_idle() < 100 and j.host_ms() > 0
