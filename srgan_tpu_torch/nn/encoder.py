"""SRGAN style encoder and its classifier twin (counterpart of
``srgan_tpu/nn/encoder.py``), NCHW.

Ported: ``BasicBlockClassification``, ``Encoder`` with ``sample=False``,
which is how the trainer's inference path calls it
(``srgan_tpu/training/gan.py:179-206``), and ``EncoderClassifier``, the nb04
pretraining model.  Module and key names follow the reference's ``Encoder``
and ``Encoder_classifier``, so their state dicts load with ``strict=True``
and a classifier's trunk and ``fcclass`` load into an ``Encoder``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from srgan_tpu_torch.nn.layers import (
    AvgPool2d,
    Conv2d,
    Linear,
    adaptive_avg_pool,
    instance_norm,
)


class BasicBlockClassification(nn.Module):
    """Unconditional pre-activation residual block with 2x2 average-pool
    downsampling (``srgan_tpu/nn/encoder.py:66-97``)."""

    def __init__(self, nch_in: int, nch_out: int):
        super().__init__()
        self.conv1 = Conv2d(nch_in, nch_in, 3, 1, 1, bias=False,
                            padding_mode="reflect")
        self.cmp = nn.Sequential(
            Conv2d(nch_in, nch_out, 3, 1, 1, bias=False,
                   padding_mode="reflect"),
            AvgPool2d(2, 2))
        self.shortcut = nn.Sequential(AvgPool2d(2, 2),
                                      Conv2d(nch_in, nch_out, 1, 1, 0))

    def forward(self, x):
        h = F.leaky_relu(instance_norm(x), 0.2)
        h = F.leaky_relu(instance_norm(self.conv1(h)), 0.2)
        return self.cmp(h) + self.shortcut(x)


class _Trunk(nn.Module):
    """``first_layer`` and ``num_cls`` blocks, each doubling the width, to
    (B, nch * 2**num_cls) fp32 features."""

    def __init__(self, nch_in: int, nch: int, num_cls: int):
        super().__init__()
        self.first_layer = Conv2d(nch_in, nch, 7, 2, 1)
        self.layers = nn.ModuleList(
            BasicBlockClassification(nch * 2 ** i, nch * 2 ** (i + 1))
            for i in range(num_cls))

    def features(self, x):
        h = self.first_layer(x)
        for layer in self.layers:
            h = layer(h)
        return adaptive_avg_pool(F.leaky_relu(h, 0.2)).float()


class Encoder(_Trunk):
    """Unconditional trunk with VAE and class heads
    (``srgan_tpu/nn/encoder.py:137-172``)."""

    def __init__(self, nch_in: int = 3, nch_out: int = 8, nch: int = 64,
                 num_cls: int = 4, num_con: int = 4):
        super().__init__(nch_in, nch, num_cls)
        feat = nch * 2 ** num_cls
        self.fcmean = Linear(feat, nch_out)
        self.fcvar = Linear(feat, nch_out)
        self.fcclass = Linear(feat, num_con)

    def forward(self, x):
        """x: (B, nch_in, H, W).  Returns (mu, logvar, class_output), fp32;
        with ``sample=False`` the style code is ``mu`` itself."""
        feat = self.features(x)
        with torch.autocast(feat.device.type, enabled=False):
            return self.fcmean(feat), self.fcvar(feat), self.fcclass(feat)


class EncoderClassifier(_Trunk):
    """The pretraining twin: the trunk, ``fcclass`` and a softmax
    (``srgan_tpu/nn/encoder.py:175-205``).  Its 8 instance norms (2 per
    block at full depth) run the norm kernels, forward and backward."""

    def __init__(self, nch_in: int = 3, nch: int = 64, num_cls: int = 4,
                 num_con: int = 4):
        super().__init__(nch_in, nch, num_cls)
        self.fcclass = Linear(nch * 2 ** num_cls, num_con)

    def forward(self, x):
        """x: (B, nch_in, H, W).  Returns class probabilities (B, num_con),
        fp32."""
        feat = self.features(x)
        with torch.autocast(feat.device.type, enabled=False):
            return torch.softmax(self.fcclass(feat), dim=-1)
