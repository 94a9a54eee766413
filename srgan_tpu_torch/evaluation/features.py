"""VGG19-BN, the PRDC feature extractor (counterpart of
``srgan_tpu/evaluation/features.py``), NCHW.

torchvision is not a dependency, so the net is built here in torchvision's
``vgg19_bn`` key layout (``features.N.*``, ``classifier.{0,3,6}.*``): a
torchvision ``.pth`` loads with ``strict=True``.  The feature path is
features -> pool to 7x7 -> ``classifier[:6]``, a 4096-d embedding; the
score path runs the whole classifier.  Three places follow the JAX package,
not torchvision:

  - no dropout, in training too: the classifier's slots 2 and 5 are
    ``nn.Identity`` (``srgan_tpu/evaluation/features.py:82-90``);
  - an input that does not reach 7x7 is average-pooled with window and
    stride ``h // 7``, not ``AdaptiveAvgPool2d`` (``:70-75``);
  - batch norm in training keeps the biased batch variance in
    ``running_var``, as flax's ``BatchNorm`` does (``BatchNorm2d`` below).

``init_vgg`` draws torchvision's default init from a ``torch.Generator``
(not the JAX package's bits); ``preprocess_for_vgg`` is the host-side
min-max -> PIL 128 -> 224 -> ImageNet-normalise pipeline, bit-equal to the
JAX one.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from srgan_tpu_torch.ops.image import to_uint8_images

# torchvision vgg19 config "E"; M = 2x2 max pool
VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose running variance, in training, moves toward
    the biased batch variance (flax ``BatchNorm``; torch keeps the unbiased
    one).  The output is torch's: normalised by the biased batch
    statistics in training, by the running ones in eval."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        # torch moves a running variance by momentum times the unbiased
        # batch variance, n / (n - 1) times the biased one: it moves a copy
        # (the backward keeps the one it was given), and the factor is taken
        # back out of the step
        moved = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, moved, self.weight, self.bias,
                         True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            keep = self.running_var * (1 - self.momentum)
            self.running_var.copy_(keep + (moved - keep) * ((n - 1) / n))
            self.num_batches_tracked += 1
        return y


def pool_to_7(x):
    """The JAX package's stand-in for ``AdaptiveAvgPool2d(7)``: identity at
    7x7 (a 224 px input), else an average pool of window and stride
    ``h // 7``."""
    h = x.shape[2]
    if h == 7:
        return x
    return F.avg_pool2d(x, h // 7, h // 7)


class VGG19BN(nn.Module):
    def __init__(self, num_classes: int = 1000):
        super().__init__()
        layers, nch = [], 3
        for v in VGG19_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(nch, v, 3, padding=1), BatchNorm2d(v),
                           nn.ReLU(inplace=True)]
                nch = v
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(
            nn.Linear(512 * 7 * 7, 4096), nn.ReLU(inplace=True),
            nn.Identity(), nn.Linear(4096, 4096), nn.ReLU(inplace=True),
            nn.Identity(), nn.Linear(4096, num_classes))

    @property
    def num_classes(self) -> int:
        return self.classifier[6].out_features

    def forward(self, x, output: str = "feature"):
        """x: (B, 3, H, W), ImageNet-normalised.  ``output="feature"``:
        the (B, 4096) embedding; ``"score"``: (B, num_classes) logits."""
        h = torch.flatten(pool_to_7(self.features(x)), 1)
        h = self.classifier[:6](h)
        return h if output == "feature" else self.classifier[6](h)


def torchvision_init_(module: nn.Module, generator: torch.Generator
                      ) -> nn.Module:
    """torchvision's VGG init of every conv, batch norm and linear layer of
    ``module``, drawn from ``generator``: kaiming-normal (fan-out, ReLU
    gain) conv weights, zero biases, batch-norm weight 1 and bias 0, linear
    weights N(0, 0.01) (the JAX package's initialisers,
    ``srgan_tpu/evaluation/features.py:39-46``)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                fan_out = m.out_channels * m.kernel_size[0] \
                    * m.kernel_size[1]
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                                 generator=generator)
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, nn.Linear):
                m.weight.normal_(0.0, 0.01, generator=generator)
                m.bias.zero_()
    return module


def init_vgg(generator: torch.Generator, num_classes: int = 1000
             ) -> VGG19BN:
    """A ``VGG19BN`` on the CPU, in eval mode, with torchvision's init drawn
    from ``generator``."""
    with torch.device("meta"):
        model = VGG19BN(num_classes)
    return torchvision_init_(model.to_empty(device="cpu"), generator).eval()


def load_vgg(state_dict, num_classes: Optional[int] = None) -> VGG19BN:
    """A ``VGG19BN`` on the CPU holding ``state_dict`` (torchvision layout,
    ``strict=True``); ``num_classes`` defaults to the head in the dict."""
    if num_classes is None:
        num_classes = state_dict["classifier.6.weight"].shape[0]
    with torch.device("meta"):
        model = VGG19BN(num_classes)
    model.load_state_dict(state_dict, strict=True, assign=True)
    return model.eval()


def vgg_feature_extractor(model: VGG19BN):
    """(B, 3, 224, 224) normalised images on the model's device -> (B, 4096)
    features, no graph."""
    @torch.inference_mode()
    def extract(x):
        return model(x, output="feature")

    return extract


def preprocess_for_vgg(images_pm1_nhwc: np.ndarray) -> np.ndarray:
    """The reference's eval preprocessing (evaluation.py:65-83): per-image
    min-max -> uint8 -> PIL bilinear resize to 128 then 224 -> [0, 1] ->
    ImageNet normalisation.  Host-side numpy and PIL; returns
    (B, 224, 224, 3) float32."""
    from PIL import Image

    out = []
    for img in to_uint8_images(images_pm1_nhwc):
        pil = Image.fromarray(img)
        pil = pil.resize((128, 128), Image.BILINEAR)
        pil = pil.resize((224, 224), Image.BILINEAR)
        arr = np.asarray(pil, np.float32) / 255.0
        out.append((arr - IMAGENET_MEAN) / IMAGENET_STD)
    return np.stack(out)
