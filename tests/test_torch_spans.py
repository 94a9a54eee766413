"""The port's span and counter recorder (``srgan_tpu_torch/utils/spans.py``)
and its sites in the train step and the norm, on the CPU at the size of
``tests/test_torch_train.py`` (32 px, g/d/e_nch 8, d_num_cls 3, e_num_cls
2, batch 4) with the presets' own trainers, losses and k."""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)

import contextlib
import dataclasses
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from srgan_tpu_torch.configs import PRESETS
from srgan_tpu_torch.ops import norm
from srgan_tpu_torch.training.gan import GANTrainer
from srgan_tpu_torch.utils import spans

TOY = dict(image_size=32, g_nch=8, g_res_num=1, d_nch=8, d_num_cls=3,
           e_nch=8, e_num_cls=2)
B = 4


def toy(preset: str):
    cfg = PRESETS[preset]()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **TOY),
        train=dataclasses.replace(cfg.train, batch_size=B))


def batch(seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    src = torch.randint(0, 4, (B,), generator=g)
    return {"image": torch.rand((B, 32, 32, 3), generator=g) * 2 - 1,
            "source_label": src,
            "target_label": (src + torch.randint(1, 4, (B,), generator=g))
            % 4}


def trainer_and_state(cfg):
    t = GANTrainer(cfg, "cpu")
    return t, t.init_state(torch.Generator().manual_seed(3),
                           freeze_pretrained=cfg.pretrained_encoder)


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read with the recorder off")

    monkeypatch.setattr(time, "time_ns", no_clock)
    assert spans.span("a") is spans.span("b", i=1)
    with spans.span("train.step", step=0):
        spans.count("norm.fwd")
    with spans.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}
    with pytest.raises(AssertionError, match="clock"):
        with spans.recording():
            with spans.span("a"):
                pass


def test_parents_steps_threads_and_counters():
    tids = []

    def worker():
        tids.append(threading.get_native_id())
        with spans.span("side"):
            spans.count("norm.bwd", 2)

    with spans.recording() as rec:
        with spans.span("outer"):
            spans.count("norm.fwd")
        for s in range(2):
            with spans.span(spans.STEP, step=s, batch=B):
                with spans.span("train.phase1"):
                    spans.count("norm.fwd", 3)
                    th = threading.Thread(target=worker)
                    th.start()
                    th.join(timeout=30)
                    assert not th.is_alive()
    with pytest.raises(RuntimeError, match="already on"):
        with spans.recording():
            with spans.recording():
                pass
    by = {n: rec.named(n) for n in ("outer", spans.STEP, "train.phase1",
                                    "side")}
    assert [len(v) for v in by.values()] == [1, 2, 2, 2]
    (outer,) = by["outer"]
    assert outer.parent == 0 and outer.step is None
    main = threading.get_native_id()
    for step, phase, side, tid in zip(by[spans.STEP], by["train.phase1"],
                                      by["side"], tids):
        assert step.step == step.id and step.parent == 0
        assert step.attrs["batch"] == B
        assert phase.parent == step.id and phase.step == step.id
        assert step.tid == phase.tid == main
        # on its own thread: no parent there, the step's id all the same
        assert side.parent == 0 and side.step == step.id
        assert side.tid == tid != main
        assert step.t0_ns <= phase.t0_ns <= side.t0_ns <= side.t1_ns \
            <= phase.t1_ns <= step.t1_ns
        assert rec.counters[("norm.fwd", step.id)] == 3
        assert rec.counters[("norm.bwd", step.id)] == 2
    assert rec.counters[("norm.fwd", None)] == 1
    assert len({s.id for s in rec.spans}) == len(rec.spans)


def test_spans_share_the_profiler_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.recording() as rec:
            with spans.span("around"):
                with record_function("mark"):
                    torch.ones(3).add_(1)
    (around,) = rec.named("around")
    marks = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "mark"]
    assert len(marks) == 1
    assert around.t0_ns <= marks[0].start_ns() <= marks[0].end_ns() \
        <= around.t1_ns
    # the recorder's spans stay out of the profiler's own events
    assert not [e for e in prof.events() if e.name == "around"]


@pytest.fixture(scope="module", params=["05_srgan_full",
                                        "01_proposed_singlegan_k5"])
def recorded_step(request):
    """One toy step of the preset under a recording, with the calls of
    ``cbinorm_fwd`` / ``cbinorm_bwd`` counted by wrappers."""
    cfg = toy(request.param)
    t, state = trainer_and_state(cfg)
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = norm.cbinorm_fwd, norm.cbinorm_bwd

    def counted(key, fn):
        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapper

    mp = pytest.MonkeyPatch()
    mp.setattr(norm, "cbinorm_fwd", counted("fwd", fwd))
    mp.setattr(norm, "cbinorm_bwd", counted("bwd", bwd))
    try:
        with spans.recording() as rec:
            t.step(state, batch())
    finally:
        mp.undo()
    return cfg, rec, calls


def test_a_step_emits_its_spans(recorded_step):
    cfg, rec, _ = recorded_step
    k = cfg.train.unrolled_k
    assert k == 5
    (step,) = rec.named(spans.STEP)
    assert step.parent == 0 and step.attrs == {"step": 0, "batch": B}
    assert all(s.step == step.id for s in rec.spans)
    d = rec.named("train.d_update")
    (p1,) = rec.named("train.phase1")
    (p2,) = rec.named("train.phase2")
    assert [s.attrs["i"] for s in d] == list(range(k - 1))
    assert {s.parent for s in d + [p1, p2]} == {step.id}
    opt = rec.named("train.optimizer")
    assert len(opt) == k + 2
    parents = [s.parent for s in opt]
    assert parents == [s.id for s in d] + [p1.id, p1.id, p2.id]
    # in order, inside the step
    seq = d + [p1, p2]
    assert all(a.t1_ns <= b.t0_ns for a, b in zip(seq, seq[1:]))
    assert step.t0_ns <= seq[0].t0_ns and seq[-1].t1_ns <= step.t1_ns


def test_norm_counters_equal_the_calls(recorded_step):
    _, rec, calls = recorded_step
    (step,) = rec.named(spans.STEP)
    assert calls["fwd"] > 0 and calls["bwd"] > 0
    assert rec.counters[("norm.fwd", step.id)] == calls["fwd"]
    assert rec.counters[("norm.bwd", step.id)] == calls["bwd"]
    assert {k for k, _ in rec.counters} == {"norm.fwd", "norm.bwd"}


def test_recording_leaves_the_step_bit_identical():
    cfg = toy("05_srgan_full")
    runs = []
    for on in (False, True):
        t, state = trainer_and_state(cfg)
        ctx = spans.recording() if on else contextlib.nullcontext()
        with ctx:
            out = [t.step(state, batch(s)) for s in range(2)]
        runs.append((out, {k: p.detach().clone() for net in
                           (state.G, state.D, state.E)
                           for k, p in net.named_parameters(
                               prefix=type(net).__name__)}))
    (m_off, p_off), (m_on, p_on) = runs
    for a, b in zip(m_off, m_on):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert p_off.keys() == p_on.keys()
    assert all(torch.equal(p_off[k], p_on[k]) for k in p_off)
