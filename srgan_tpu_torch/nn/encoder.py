"""SRGAN style encoder (counterpart of ``srgan_tpu/nn/encoder.py``), NCHW.

Ported: ``BasicBlockClassification`` and ``Encoder`` with ``sample=False``,
which is how the trainer's inference path calls it
(``srgan_tpu/training/gan.py:179-206``).  Module and key names follow the
reference's ``Encoder`` so its state dicts load with ``strict=True``.
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


class Encoder(nn.Module):
    """Unconditional trunk with VAE and class heads
    (``srgan_tpu/nn/encoder.py:137-172``)."""

    def __init__(self, nch_in: int = 3, nch_out: int = 8, nch: int = 64,
                 num_cls: int = 4, num_con: int = 4):
        super().__init__()
        self.first_layer = Conv2d(nch_in, nch, 7, 2, 1)
        self.layers = nn.ModuleList(
            BasicBlockClassification(nch * 2 ** i, nch * 2 ** (i + 1))
            for i in range(num_cls))
        feat = nch * 2 ** num_cls
        self.fcmean = Linear(feat, nch_out)
        self.fcvar = Linear(feat, nch_out)
        self.fcclass = Linear(feat, num_con)

    def forward(self, x):
        """x: (B, nch_in, H, W).  Returns (mu, logvar, class_output), fp32;
        with ``sample=False`` the style code is ``mu`` itself."""
        h = self.first_layer(x)
        for layer in self.layers:
            h = layer(h)
        feat = adaptive_avg_pool(F.leaky_relu(h, 0.2)).float()
        with torch.autocast(feat.device.type, enabled=False):
            return self.fcmean(feat), self.fcvar(feat), self.fcclass(feat)
