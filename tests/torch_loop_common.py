"""What ``tests/test_torch_loop.py`` and ``tests/test_torch_resume.py``
share: the size of ``tests/test_loop.py`` (64 px, g/d/e_nch 8, g_res_num
1, d/e_num_cls 2, batch 8, 10 synthetic images a class), the fixture, and
a trainer whose latents are injected."""

import json
import os

import pytest
import torch

from srgan_tpu_torch.configs import (
    ExperimentConfig,
    LossWeights,
    ModelConfig,
    TrainConfig,
)
from srgan_tpu_torch.data import make_synthetic_celeba
from srgan_tpu_torch.training import loop
from srgan_tpu_torch.training.gan import GANTrainer

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


class Injected(GANTrainer):
    """Hands out the same latents at every step."""

    draws = None

    def _draw_latent(self, shape):
        arr = self.draws[self.draw_i % len(self.draws)]
        self.draw_i += 1
        return torch.from_numpy(arr)
