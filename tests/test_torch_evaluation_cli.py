"""The port's PRDC evaluation CLIs end to end on the CPU: ``python -m
srgan_tpu_torch.finetune_vgg`` with the flags of
``tests/test_cli.py::test_finetune_vgg_cli``, and ``evaluate_prdc`` (in
process) on a tiny SRGAN run with two extractors and with
``--init-baseline``.  Their parts are held against ``srgan_tpu`` in
``tests/test_torch_evaluation.py``.
"""

import torch_one_thread  # first: one intra-op thread

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from srgan_tpu_torch.configs import (
    ExperimentConfig,
    LossWeights,
    ModelConfig,
    TrainConfig,
)
from srgan_tpu_torch.data import make_synthetic_celeba
from srgan_tpu_torch.evaluate_prdc import main as evaluate_prdc
from srgan_tpu_torch.evaluation.features import load_vgg
from srgan_tpu_torch.training import loop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def finetuned(tmp_path_factory):
    """The finetune_vgg CLI with the flags of
    tests/test_cli.py::test_finetune_vgg_cli but --train-num 2: 2 of the
    fixture's 24 images a class train, one epoch of 2 steps of 4."""
    tmp = tmp_path_factory.mktemp("vgg")
    r = subprocess.run(
        [sys.executable, "-m", "srgan_tpu_torch.finetune_vgg", "--synthetic",
         "--train-num", "2", "--val-num", "2",
         "--batch-size", "4", "--epochs", "1", "--val-every", "1",
         "--device", "cpu", "--decode", "pil", "--out", str(tmp / "vgg")],
        cwd=ROOT, env=torch_one_thread.env(TMPDIR=str(tmp)),
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return tmp / "vgg"


def test_finetune_vgg_cli(finetuned):
    assert [float(line.split('"epoch": ')[1].split(",")[0])
            for line in open(finetuned / "metrics.jsonl")] == [0]
    sd = torch.load(finetuned / "vgg_celeba_best.pth", weights_only=True)
    assert load_vgg(sd).num_classes == 4
    assert int(sd["features.1.num_batches_tracked"]) == 2


def test_evaluate_prdc_cli(tmp_path, finetuned):
    """A tiny SRGAN run (tests/test_torch_loop.py's size), then the
    evaluate_prdc CLI over all 16 pairs with two extractors, and with
    --init-baseline."""
    img_root, attr_file = make_synthetic_celeba(str(tmp_path / "data"),
                                                n_per_class=10)
    cfg = ExperimentConfig(
        name="eval_tiny",
        model=ModelConfig(image_size=64, g_nch=8, g_res_num=1, d_nch=8,
                          d_num_cls=2, e_nch=8, e_num_cls=2),
        train=TrainConfig(batch_size=8, unrolled_k=1, train_num=8,
                          val_num=0, test_num=2),
        loss=LossWeights.proposed_kl(cls=1.0), trainer="srgan")
    run = tmp_path / "run"
    loop.train_gan(cfg, str(run), data_root=img_root, attr_file=attr_file,
                   epochs=1, sample_grids=False, echo=False, device="cpu",
                   decode="pil")
    common = ["--ckpt", str(run / "ckpt"), "--data-root", img_root,
              "--attr-file", attr_file, "--num-samples", "4",
              "--nearest-k", "3", "--test-num", "4", "--device", "cpu"]
    pkl = tmp_path / "prdc.pkl"
    evaluate_prdc(common + [
        "--feature-extractors", "vgg-initialization", "vgg-CelebA",
        "--vgg-celeba-ckpt", str(finetuned / "vgg_celeba_best.pth"),
        "--out", str(pkl)])
    with open(pkl, "rb") as f:
        results = pickle.load(f)
    assert set(results) == {"vgg-initialization", "vgg-CelebA"}
    for fe in results:
        assert set(results[fe]) == {0, 1, 2, 3}
        for s in range(4):
            for t in range(4):
                m = results[fe][s][t]
                assert all(len(v) == 1 and np.isfinite(v[0])
                           for v in m.values())
                for key in ("precision", "recall", "coverage"):
                    assert 0.0 <= m[key][0] <= 1.0
                assert m["density"][0] >= 0.0
    ipkl = tmp_path / "prdc_init.pkl"
    evaluate_prdc(common + ["--init-baseline", "--out", str(ipkl)])
    with open(ipkl, "rb") as f:
        iv = pickle.load(f)["vgg-initialization"][0][1]["coverage"]
    assert len(iv) == 1 and np.isfinite(iv[0])
    with pytest.raises(SystemExit):
        evaluate_prdc(common + ["--feature-extractors", "vgg-ImageNet",
                                "--out", str(ipkl)])
