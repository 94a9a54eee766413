"""The port's checkpoints, resume and signal stop (``srgan_tpu_torch/
utils/checkpoint.py``, ``training/loop.py``) on the CPU, at the size of
``tests/test_loop.py`` (``tests/torch_loop_common.py``), mirroring its
tests. The loop's other cases, the slice against the JAX ``train_gan`` and
the CLI are in ``tests/test_torch_loop.py``.

Tolerance: a restored checkpoint's step is bit-equal to the unsaved
state's (the same arithmetic on the same bits).
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)

import dataclasses
import json
import os
import signal

import numpy as np
import pytest
import torch

from srgan_tpu_torch.utils import checkpoint
from srgan_tpu_torch.utils import metrics as metrics_mod
from torch_loop_common import (  # noqa: F401
    Injected,
    _records,
    _train,
    data,
    tiny_cfg,
)


# ---------------------------------------------------------------- checkpoint

def _batch(rng, cfg):
    B, hw = cfg.train.batch_size, cfg.model.image_size
    src = rng.integers(0, 4, B)
    return dict(image=rng.uniform(-1, 1, (B, hw, hw, 3)).astype(np.float32),
                source_label=src,
                target_label=(src + rng.integers(1, 4, B)) % 4)


def test_save_restore_step_is_bit_equal(tmp_path):
    cfg = tiny_cfg(pretrained=True, unrolled_k=2)
    rng = np.random.default_rng(3)
    Injected.draws = [rng.standard_normal((8, 8)).astype(np.float32)
                      for _ in range(2)]
    batches = [_batch(rng, cfg) for _ in range(2)]
    t = Injected(cfg, device="cpu")
    t.draw_i = 0
    state = t.init_state(freeze_pretrained=True)
    t.step(state, batches[0])
    ckpt = checkpoint.save_checkpoint(str(tmp_path / "ckpt"), state, step=1)
    assert ckpt.endswith("step_1")
    assert sorted(os.listdir(ckpt)) == [
        "discriminator.pth", "encoder.pth", "generator.pth",
        "train_state.pth"]
    assert checkpoint.latest_step(str(tmp_path / "ckpt")) == 1
    assert checkpoint.latest_step(str(tmp_path / "none")) is None

    # a state from other weights, restored from the checkpoint
    other = t.init_state(torch.Generator().manual_seed(99),
                         freeze_pretrained=True)
    checkpoint.restore_checkpoint(str(tmp_path / "ckpt"), other)
    assert other.step == state.step == 1
    assert torch.equal(other.hist_target, state.hist_target)
    trunk = [n for n, p in other.E.named_parameters()
             if n.split(".")[0] not in ("fcmean", "fcvar")]
    assert trunk and all(not p.requires_grad for n, p in
                         other.E.named_parameters() if n in trunk)
    trunk_before = {n: p.clone() for n, p in other.E.named_parameters()
                    if n in trunk}

    m_a = t.step(state, batches[1], epoch=1)
    m_b = t.step(other, batches[1], epoch=1)
    assert set(m_a) == set(m_b)
    for k in m_a:
        assert torch.equal(m_a[k], m_b[k]), k
    for net in ("G", "D", "E"):
        a, b = getattr(state, net).state_dict(), \
            getattr(other, net).state_dict()
        for k in a:
            assert torch.equal(a[k], b[k]), (net, k)
    for opt in ("opt_g", "opt_d", "opt_e"):
        sa = getattr(state, opt).state_dict()["state"]
        sb = getattr(other, opt).state_dict()["state"]
        for i in sa:
            for k in sa[i]:
                assert torch.equal(sa[i][k], sb[i][k]), (opt, i, k)
    for n, p in other.E.named_parameters():
        if n in trunk:
            assert torch.equal(p, trunk_before[n]), n
    # a checkpoint of an unfrozen encoder does not load into a frozen one
    loose = t.init_state()
    checkpoint.save_checkpoint(str(tmp_path / "loose"), loose, step=1)
    with pytest.raises(ValueError):
        checkpoint.restore_checkpoint(str(tmp_path / "loose"), other)


# ---------------------------------------------------------------- resume

def test_train_gan_resume_keeps_steps_monotonic(tmp_path, data):
    cfg = tiny_cfg()
    out = tmp_path / "run"
    _train(cfg, out, data, epochs=1)
    trainer, state = _train(cfg, out, data, epochs=2, resume=True)
    assert state.step == 8
    assert [r["step"] for r in _records(out)] == list(range(1, 9))
    assert [r["epoch"] for r in _records(out)] == [0] * 4 + [1] * 4
    assert checkpoint.latest_step(str(out / "ckpt")) == 2


def test_resume_with_different_config_refuses(tmp_path, data):
    cfg = tiny_cfg()
    out = tmp_path / "run"
    _train(cfg, out, data, epochs=1)
    other = dataclasses.replace(cfg, name="loop_other")
    with pytest.raises(ValueError, match="resume with a different config"):
        _train(other, out, data, epochs=2, resume=True)
    # a longer run is not another config
    longer = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, epochs=cfg.train.epochs + 5))
    _, state = _train(longer, out, data, epochs=2, resume=True)
    assert state.step == 8
    with open(out / "config.json") as f:
        assert json.load(f)["train"]["epochs"] == cfg.train.epochs


def test_sigterm_checkpoints_and_stops(tmp_path, data, monkeypatch):
    cfg = tiny_cfg()
    out = tmp_path / "run"
    orig_log = metrics_mod.MetricLogger.log
    fired = []

    def log_and_kill(self, *a, **k):
        if not fired:
            fired.append(1)
            os.kill(os.getpid(), signal.SIGTERM)
        return orig_log(self, *a, **k)

    monkeypatch.setattr(metrics_mod.MetricLogger, "log", log_and_kill)
    handler = signal.getsignal(signal.SIGTERM)
    _, state = _train(cfg, out, data, epochs=50)
    assert signal.getsignal(signal.SIGTERM) is handler
    assert state.step == 4
    assert os.listdir(out / "ckpt") == ["step_1"]
    _, state2 = _train(cfg, out, data, epochs=2, resume=True)
    assert state2.step == 8
    assert [r["step"] for r in _records(out)] == list(range(1, 9))
