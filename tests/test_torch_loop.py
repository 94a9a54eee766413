"""The port's epoch loop and CLI (``srgan_tpu_torch/training/loop.py``,
``train.py``) on the CPU, at the size of ``tests/test_loop.py``
(``tests/torch_loop_common.py``: 64 px, g/d/e_nch 8, g_res_num 1, d/e_num_cls
2, batch 8, 10 synthetic images a class), mirroring its tests, and the
port's ``train_gan`` against the JAX ``train_gan`` over one epoch. The
checkpoint, resume and signal cases are in ``tests/test_torch_resume.py``.

Tolerance: the loop against the JAX loop holds every logged loss within
1e-4 relative, the tolerance of ``tests/test_torch_train.py`` (fp32 sums in
another order), with the same ``epoch`` and ``step`` columns.
"""

import torch_one_thread  # first: one intra-op thread

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srgan_tpu.configs import ExperimentConfig as JExperimentConfig
from srgan_tpu.configs import LossWeights as JLossWeights
from srgan_tpu.configs import ModelConfig as JModelConfig
from srgan_tpu.configs import TrainConfig as JTrainConfig
from srgan_tpu.training import loop as jloop
from srgan_tpu.training.gan import GANTrainer as JGANTrainer
from srgan_tpu.utils.checkpoint import (
    export_torch_classifier,
    save_torch_state_dict,
)
from srgan_tpu_torch.training import loop
from srgan_tpu_torch.training.gan import GANTrainer
from srgan_tpu_torch.utils.checkpoint import (
    encoder_state_dict_from_jax,
    generator_state_dict_from_jax,
    solo_discriminator_state_dict_from_jax,
)
from torch_loop_common import (  # noqa: F401
    MODEL,
    PER_CLASS,
    RUN,
    TRAIN,
    Injected,
    _records,
    _train,
    data,
    tiny_cfg,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-4


# ---------------------------------------------------------------- the loop

def test_train_gan_end_to_end(tmp_path, data):
    trainer, state = _train(tiny_cfg(), tmp_path / "run", data, epochs=1,
                            profile_dir=str(tmp_path / "prof"),
                            debug_nans=True)
    recs = _records(tmp_path / "run")
    assert recs and all(np.isfinite(r["errG"]) for r in recs)
    assert [r["step"] for r in recs] == [1, 2, 3, 4]  # 32 images, batch 8
    assert os.path.isdir(tmp_path / "run" / "ckpt" / "step_1")
    assert not os.path.isdir(tmp_path / "run" / "ckpt" / "step_0")
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    assert state.step == 4 and trainer.device.type == "cpu"


def test_train_gan_refusals(tmp_path, data, monkeypatch):
    with pytest.raises(ValueError, match="classifier_ckpt"):
        _train(tiny_cfg(pretrained=True), tmp_path / "a", data, epochs=1)
    # grids without matplotlib: refused before anything is written
    real_find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None
                        if name == "matplotlib" else real_find_spec(name, *a))
    with pytest.raises(RuntimeError, match="matplotlib"):
        _train(tiny_cfg(), tmp_path / "b", data, epochs=1,
               sample_grids=True)
    assert not os.path.exists(tmp_path / "b")
    monkeypatch.undo()
    with pytest.raises(ValueError, match="orbax"):
        _train(tiny_cfg(pretrained=True), tmp_path / "c", data, epochs=1,
               classifier_ckpt=str(tmp_path / "classifier_best"))
    with pytest.raises(ValueError, match="smaller than batch"):
        _train(tiny_cfg(batch_size=64), tmp_path / "d", data, epochs=1)


def test_debug_nans_raises_at_the_first_non_finite_metric(tmp_path, data,
                                                          monkeypatch):
    def nan_step(self, state, batch, epoch=0):
        return {"errD": torch.tensor(float("nan"))}

    monkeypatch.setattr(GANTrainer, "step", nan_step)
    with pytest.raises(FloatingPointError, match="errD"):
        _train(tiny_cfg(), tmp_path / "run", data, epochs=1, debug_nans=True)


def test_nb05_encoder_load_is_the_classifier(tmp_path, data):
    """The nb05 transfer: a classifier exported by the JAX package loads into
    the port's encoder, trunk and fcclass exactly, and stays so through
    training; fcmean trains."""
    jcfg = JExperimentConfig(
        name="nb05", model=JModelConfig(**MODEL),
        train=JTrainConfig(**TRAIN), loss=JLossWeights.proposed_kl(cls=1.0),
        trainer="srgan")
    jstate = JGANTrainer(jcfg).init_state(jax.random.PRNGKey(5))
    clf = export_torch_classifier(jax.device_get(jstate.e_params), num_cls=2)
    path = str(tmp_path / "classifier_best.pth")
    save_torch_state_dict(path, clf)
    cfg = tiny_cfg(pretrained=True)
    fresh = GANTrainer(cfg, "cpu").init_state(
        torch.Generator().manual_seed(cfg.train.seed))
    _, state = _train(cfg, tmp_path / "run", data, epochs=1,
                      classifier_ckpt=path)
    post = state.E.state_dict()
    assert set(post) - set(clf) == {"fcmean.weight", "fcmean.bias",
                                    "fcvar.weight", "fcvar.bias"}
    for k, v in clf.items():
        np.testing.assert_array_equal(post[k].numpy(), v, err_msg=k)
    assert not torch.equal(post["fcmean.weight"],
                           fresh.E.state_dict()["fcmean.weight"])
    # an encoder state dict is not a classifier
    enc = str(tmp_path / "encoder.pth")
    torch.save(post, enc)
    with pytest.raises(ValueError, match="classifier"):
        loop.load_pretrained_encoder(enc, fresh.E)


# ---------------------------------------------------------------- the slice

K = 2


class InjectedJAX(JGANTrainer):
    """The JAX step traces once, so its draws are the same every step."""

    draws = None

    def _draw_latent(self, key, shape):
        i = getattr(self, "_draw_i", 0)
        self._draw_i = i + 1
        arr = self.draws[i % len(self.draws)]
        assert arr.shape == tuple(shape)
        return jnp.asarray(arr)


def test_train_gan_matches_jax_train_gan(tmp_path, data, monkeypatch):
    """One epoch of 2 steps (16 images, batch 8, k = 2, a record every
    step) through each package's train_gan: the same batches (the loaders
    agree bit for bit), the same start (the JAX init carried over by the
    converters), the same latents (injected on both sides)."""
    img_root, attr_file = data
    train = {**TRAIN, "unrolled_k": K, "train_num": 4}
    jcfg = JExperimentConfig(
        name="slice", model=JModelConfig(**MODEL),
        train=JTrainConfig(**train), loss=JLossWeights.proposed_kl(cls=1.0),
        trainer="srgan")
    cfg = tiny_cfg(**train)
    cfg = dataclasses.replace(cfg, name="slice")
    rng = np.random.default_rng(8)
    draws = [rng.standard_normal((8, 8)).astype(np.float32)
             for _ in range(K)]

    jstate = JGANTrainer(jcfg).init_state(
        jax.random.PRNGKey(jcfg.train.seed))
    g, d, e = jax.device_get((jstate.g_params, jstate.d_params,
                              jstate.e_params))
    start = dict(g_state=generator_state_dict_from_jax(g, 2, 1),
                 d_state=solo_discriminator_state_dict_from_jax(d, 2),
                 e_state=encoder_state_dict_from_jax(e, 2),
                 hist_target=np.asarray(jstate.hist_target))

    class Port(Injected):
        def init_state(self, generator=None, freeze_pretrained=False):
            self.draw_i = 0
            return GANTrainer.init_state(
                self, freeze_pretrained=freeze_pretrained, **start)

    Port.draws = InjectedJAX.draws = draws
    monkeypatch.setattr(jloop, "GANTrainer", InjectedJAX)
    monkeypatch.setattr(loop, "GANTrainer", Port)
    jloop.train_gan(jcfg, str(tmp_path / "jax"), data_root=img_root,
                    attr_file=attr_file, epochs=1, sample_grids=False,
                    echo=False)
    _, state = loop.train_gan(cfg, str(tmp_path / "port"),
                              data_root=img_root, attr_file=attr_file,
                              epochs=1, **RUN)
    assert state.step == 2
    ours, theirs = _records(tmp_path / "port"), _records(tmp_path / "jax")
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        assert (a["epoch"], a["step"]) == (b["epoch"], b["step"])
        for k in a:
            if k.startswith(("err", "loss_")):
                np.testing.assert_allclose(a[k], b[k], rtol=RTOL, err_msg=k)
    assert ours[1]["errD"] != ours[0]["errD"]


# ---------------------------------------------------------------- the CLI

def _cli(tmp_path, *extra, preset="03_srgan_nopretraining",
         grids=("--no-sample-grids",), k=("--unrolled-k", "1")):
    args = [sys.executable, "-m", "srgan_tpu_torch.train",
            "--preset", preset, "--synthetic", *grids,
            "--out", str(tmp_path / "run"),
            "--image-size", "64", "--g-nch", "8", "--d-nch", "8",
            "--e-nch", "8", "--g-res-num", "1", "--d-num-cls", "2",
            "--e-num-cls", "2", "--batch-size", "8", *k,
            "--train-num", "8", "--synthetic-per-class", str(PER_CLASS),
            "--epochs", "1", *extra]
    env = torch_one_thread.env(TMPDIR=str(tmp_path))
    return subprocess.run(args, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)


def test_cli_trains_one_epoch_on_the_cpu(tmp_path):
    r = _cli(tmp_path, "--device", "cpu", "--decode", "pil")
    assert r.returncode == 0, r.stderr[-3000:]
    # --synthetic sets test_num 4: 6 training images a class, 3 steps
    recs = _records(tmp_path / "run")
    assert [rec["step"] for rec in recs] == [1, 2, 3]
    assert os.path.isdir(tmp_path / "run" / "ckpt" / "step_1")
    with open(tmp_path / "run" / "config.json") as f:
        stored = json.load(f)
    assert stored["train"]["test_num"] == 4
    assert stored["model"]["g_nch"] == 8


def test_cli_trains_a_singlegan_preset_with_grids(tmp_path):
    """The nb01 preset at its k = 5 with the CLI's default grids: the JAX
    loop's names, one a log (3 steps an epoch, a log at each), and the
    run's config.json the preset's with the overrides; then a resume to a
    second epoch from the checkpoint of the four per-domain Ds."""
    r = _cli(tmp_path, "--device", "cpu", "--decode", "pil",
             preset="01_proposed_singlegan_k5", grids=(), k=())
    assert r.returncode == 0, r.stderr[-3000:]
    run = tmp_path / "run"
    assert sorted(p for p in os.listdir(run) if p.endswith(".png")) == [
        f"progress_e000_i{i:05d}.png" for i in range(3)]
    with open(run / "config.json") as f:
        stored = json.load(f)
    assert stored["trainer"] == "singlegan"
    assert stored["train"]["unrolled_k"] == 5
    assert [rec["step"] for rec in _records(run)] == [1, 2, 3]
    r = _cli(tmp_path, "--device", "cpu", "--decode", "pil", "--resume",
             "--epochs", "2", "--no-sample-grids",
             preset="01_proposed_singlegan_k5",
             grids=(), k=())
    assert r.returncode == 0, r.stderr[-3000:]
    assert "resumed from epoch 1" in r.stdout
    assert [rec["step"] for rec in _records(run)] == [1, 2, 3, 4, 5, 6]
    assert sorted(os.listdir(run / "ckpt")) == ["step_1", "step_2"]


def test_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    r = _cli(tmp_path)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr, r.stderr[-3000:]
