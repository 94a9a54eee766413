"""The PRDC evaluation harness (counterpart of
``srgan_tpu/evaluation/harness.py``; the reference's ``GAN_evaluation`` and
``evaluation_init``, evaluation.py:38-123, and notebook 06).

``GANEvaluation`` picks a VGG19-BN by extractor name, preprocesses image
batches on the host (``preprocess_for_vgg``), embeds them on its device in
batches of 32 and computes PRDC there with nearest_k 5.  Results go into the
reference's nested dict ``[fe][source][target][metric] -> list``, from which
``comparison_table`` makes the notebook-06 tables.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from srgan_tpu_torch.evaluation.features import (
    init_vgg,
    load_vgg,
    preprocess_for_vgg,
    vgg_feature_extractor,
)
from srgan_tpu_torch.evaluation.prdc import compute_prdc
from srgan_tpu_torch.ops.image import nchw_on
from srgan_tpu_torch.training.gan import resolve_device

METRICS = ("precision", "recall", "density", "coverage")


def evaluation_init(fe_list: Sequence[str], classes: Sequence[int],
                    metrics: Sequence[str] = METRICS) -> Dict:
    """Nested result dict (evaluation.py:112-123)."""
    return {fe: {s: {t: {m: [] for m in metrics} for t in classes}
                 for s in classes} for fe in fe_list}


class GANEvaluation:
    """PRDC over the features of one VGG19-BN.

    ``feature_extractor``: "vgg-initialization" (torchvision's default init
    drawn from a generator seeded with ``seed``), "vgg-ImageNet" or
    "vgg-CelebA" (pass ``state_dict``, torchvision layout: a 1000-way or a
    ``len(classes)``-way head).
    """

    def __init__(self, feature_extractor: str = "vgg-initialization",
                 classes: Sequence[int] = (0, 1, 2, 3), state_dict=None,
                 seed: int = 0, device="cuda"):
        self.fe = feature_extractor
        self.device = resolve_device(device)
        num_classes = len(classes) if "CelebA" in feature_extractor else 1000
        if state_dict is None:
            if "initialization" not in feature_extractor:
                raise ValueError(
                    f"{feature_extractor} needs weights: pass state_dict= "
                    "(a torchvision-layout vgg19_bn state dict); only "
                    "vgg-initialization initialises itself")
            model = init_vgg(torch.Generator().manual_seed(seed),
                             num_classes)
        else:
            model = load_vgg(state_dict, num_classes)
        self.model = model.to(self.device)
        self._extract = vgg_feature_extractor(self.model)

    def preprocess(self, images_pm1_nhwc) -> np.ndarray:
        if isinstance(images_pm1_nhwc, torch.Tensor):
            images_pm1_nhwc = images_pm1_nhwc.detach().cpu().numpy()
        return preprocess_for_vgg(np.asarray(images_pm1_nhwc))

    def get_feature(self, images: np.ndarray, batch: int = 32
                    ) -> torch.Tensor:
        """Preprocessed (N, 224, 224, 3) images -> (N, 4096) features on
        the device, ``batch`` images a forward."""
        return torch.cat([
            self._extract(nchw_on(images[start:start + batch], self.device))
            for start in range(0, len(images), batch)])

    def get_prdc(self, true_images, pred_images, nearest_k: int = 5,
                 preprocess: bool = True, batch: int = 32
                 ) -> Dict[str, float]:
        if preprocess:
            true_images = self.preprocess(true_images)
            pred_images = self.preprocess(pred_images)
        f1 = self.get_feature(true_images, batch)
        f2 = self.get_feature(pred_images, batch)
        return compute_prdc(f1, f2, nearest_k=nearest_k, device=self.device)


def comparison_table(gan_eval: Dict, fe: str, metric: str,
                     classes: Sequence[int] = (0, 1, 2, 3)) -> np.ndarray:
    """(source x target) mean-metric matrix: the notebook-06 cell-10
    table."""
    return np.array([[np.mean(gan_eval[fe][s][t][metric])
                      for t in classes] for s in classes])
