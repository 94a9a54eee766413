"""The port's epoch loop, checkpoints and CLI (``srgan_tpu_torch/training/
loop.py``, ``utils/checkpoint.py``, ``train.py``) on the CPU, at the size of
``tests/test_loop.py`` (64 px, g/d/e_nch 8, g_res_num 1, d/e_num_cls 2,
batch 8, 10 synthetic images a class), mirroring its tests, and the port's
``train_gan`` against the JAX ``train_gan`` over one epoch.

Tolerances: a restored checkpoint's step is bit-equal to the unsaved
state's (the same arithmetic on the same bits); the loop against the JAX
loop holds every logged loss within 1e-4 relative, the tolerance of
``tests/test_torch_train.py`` (fp32 sums in another order), with the same
``epoch`` and ``step`` columns.
"""

import dataclasses
import json
import os
import signal
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
from srgan_tpu_torch.configs import (
    ExperimentConfig,
    LossWeights,
    ModelConfig,
    TrainConfig,
)
from srgan_tpu_torch.data import make_synthetic_celeba
from srgan_tpu_torch.training import loop
from srgan_tpu_torch.training.gan import GANTrainer
from srgan_tpu_torch.utils import checkpoint
from srgan_tpu_torch.utils import metrics as metrics_mod
from srgan_tpu_torch.utils.checkpoint import (
    encoder_state_dict_from_jax,
    generator_state_dict_from_jax,
    solo_discriminator_state_dict_from_jax,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-4
PER_CLASS = 10
MODEL = dict(image_size=64, g_nch=8, g_res_num=1, d_nch=8, d_num_cls=2,
             e_nch=8, e_num_cls=2)
TRAIN = dict(batch_size=8, unrolled_k=1, encoded_feature="mu", train_num=8,
             val_num=0, test_num=2)
RUN = dict(sample_grids=False, echo=False, device="cpu")


def tiny_cfg(pretrained=False, **train) -> ExperimentConfig:
    return ExperimentConfig(
        name="loop_tiny", model=ModelConfig(**MODEL),
        train=TrainConfig(**{**TRAIN, **train}),
        loss=LossWeights.proposed_kl(cls=1.0), trainer="srgan",
        pretrained_encoder=pretrained)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_synthetic_celeba(str(tmp_path_factory.mktemp("celeba")),
                                 n_per_class=PER_CLASS)


def _train(cfg, out, data, **kw):
    img_root, attr_file = data
    return loop.train_gan(cfg, str(out), data_root=img_root,
                          attr_file=attr_file, **{**RUN, **kw})


def _records(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


# ---------------------------------------------------------------- checkpoint

class Injected(GANTrainer):
    """Hands out the same latents at every step."""

    draws = None

    def _draw_latent(self, shape):
        arr = self.draws[self.draw_i % len(self.draws)]
        self.draw_i += 1
        return torch.from_numpy(arr)


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


def test_train_gan_refusals(tmp_path, data):
    with pytest.raises(ValueError, match="classifier_ckpt"):
        _train(tiny_cfg(pretrained=True), tmp_path / "a", data, epochs=1)
    with pytest.raises(NotImplementedError, match="A7"):
        _train(tiny_cfg(), tmp_path / "b", data, epochs=1,
               sample_grids=True)
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

def _cli(tmp_path, *extra):
    args = [sys.executable, "-m", "srgan_tpu_torch.train",
            "--preset", "03_srgan_nopretraining", "--synthetic",
            "--no-sample-grids", "--out", str(tmp_path / "run"),
            "--image-size", "64", "--g-nch", "8", "--d-nch", "8",
            "--e-nch", "8", "--g-res-num", "1", "--d-num-cls", "2",
            "--e-num-cls", "2", "--batch-size", "8", "--unrolled-k", "1",
            "--train-num", "8", "--synthetic-per-class", str(PER_CLASS),
            "--epochs", "1", *extra]
    env = dict(os.environ, TMPDIR=str(tmp_path))
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


def test_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    r = _cli(tmp_path)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr, r.stderr[-3000:]
