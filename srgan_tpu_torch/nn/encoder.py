"""Style encoders and the classifier twin (counterpart of
``srgan_tpu/nn/encoder.py``), NCHW.

Ported: ``BasicBlock`` and ``EncoderOriginal``, the SingleGAN conditional
encoder; ``BasicBlockClassification`` and ``Encoder``, the SRGAN encoder;
both encoders with ``sample=False``, which is how the trainer calls them
(``srgan_tpu/training/gan.py:179-206``); and ``EncoderClassifier``, the nb04
pretraining model.  Module and key names follow the reference's
``EncoderOriginal``, ``Encoder`` and ``Encoder_classifier``, so their state
dicts load with ``strict=True`` and a classifier's trunk and ``fcclass``
load into an ``Encoder``.

Every model takes ``norm_type``: "instance" (the norm kernels) or "batch"
(``srgan_tpu/nn/encoder.py:44-48, 76-82``): ``CBBNorm`` in ``BasicBlock``,
``BatchNorm`` (``norm1`` / ``norm2``) in ``BasicBlockClassification``,
batch statistics in ``train()`` mode and running ones in ``eval()``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from srgan_tpu_torch.nn.layers import (
    AvgPool2d,
    BatchNorm,
    Conv2d,
    Linear,
    adaptive_avg_pool,
    instance_norm,
    make_cnorm,
)


class BasicBlock(nn.Module):
    """Conditional pre-activation residual block with 2x2 average-pool
    downsampling (``srgan_tpu/nn/encoder.py:35-63``): CBINorm on the class
    one-hot, LeakyReLU 0.2 and a conv, twice; the shortcut pools, then a
    1x1 conv."""

    def __init__(self, nch_in: int, nch_out: int, num_con: int,
                 norm_type: str = "instance"):
        super().__init__()
        self.cnorm1 = make_cnorm(norm_type, nch_in, num_con)
        self.conv1 = Conv2d(nch_in, nch_in, 3, 1, 1, bias=False,
                            padding_mode="reflect")
        self.cnorm2 = make_cnorm(norm_type, nch_in, num_con)
        self.cmp = nn.Sequential(
            Conv2d(nch_in, nch_out, 3, 1, 1, bias=False,
                   padding_mode="reflect"),
            AvgPool2d(2, 2))
        self.shortcut = nn.Sequential(AvgPool2d(2, 2),
                                      Conv2d(nch_in, nch_out, 1, 1, 0))

    def forward(self, x, d):
        h = F.leaky_relu(self.cnorm1(x, d), 0.2)
        h = F.leaky_relu(self.cnorm2(self.conv1(h), d), 0.2)
        return self.cmp(h) + self.shortcut(x)


class BasicBlockClassification(nn.Module):
    """Unconditional pre-activation residual block with 2x2 average-pool
    downsampling (``srgan_tpu/nn/encoder.py:66-97``); instance norm, or
    ``BatchNorm`` ``norm1`` / ``norm2`` in batch mode."""

    def __init__(self, nch_in: int, nch_out: int,
                 norm_type: str = "instance"):
        super().__init__()
        if norm_type == "batch":
            self.norm1, self.norm2 = BatchNorm(nch_in), BatchNorm(nch_in)
        elif norm_type == "instance":
            self.norm1 = self.norm2 = instance_norm
        else:
            raise NotImplementedError(
                f"normalization layer [{norm_type}] is not found")
        self.conv1 = Conv2d(nch_in, nch_in, 3, 1, 1, bias=False,
                            padding_mode="reflect")
        self.cmp = nn.Sequential(
            Conv2d(nch_in, nch_out, 3, 1, 1, bias=False,
                   padding_mode="reflect"),
            AvgPool2d(2, 2))
        self.shortcut = nn.Sequential(AvgPool2d(2, 2),
                                      Conv2d(nch_in, nch_out, 1, 1, 0))

    def forward(self, x):
        h = F.leaky_relu(self.norm1(x), 0.2)
        h = F.leaky_relu(self.norm2(self.conv1(h)), 0.2)
        return self.cmp(h) + self.shortcut(x)


class _Trunk(nn.Module):
    """``first_layer`` and ``num_cls`` blocks, each doubling the width, to
    (B, nch * 2**num_cls) fp32 features; the blocks are conditional
    (``BasicBlock`` on a ``num_con``-wide one-hot) when ``num_con`` is
    given."""

    def __init__(self, nch_in: int, nch: int, num_cls: int,
                 num_con: Optional[int] = None, norm_type: str = "instance"):
        super().__init__()
        self.first_layer = Conv2d(nch_in, nch, 7, 2, 1)
        widths = [(nch * 2 ** i, nch * 2 ** (i + 1)) for i in range(num_cls)]
        self.layers = nn.ModuleList(
            BasicBlockClassification(a, b, norm_type) if num_con is None
            else BasicBlock(a, b, num_con, norm_type) for a, b in widths)

    def features(self, x, *cond):
        h = self.first_layer(x)
        for layer in self.layers:
            h = layer(h, *cond)
        return adaptive_avg_pool(F.leaky_relu(h, 0.2)).float()


class EncoderOriginal(_Trunk):
    """SingleGAN conditional VAE encoder: (image, class one-hot) ->
    (c_code, mu, logvar), no class head
    (``srgan_tpu/nn/encoder.py:108-134``).  Its 8 CBINorms (2 per block at
    full depth) are conditioned on the one-hot and run the norm kernels."""

    def __init__(self, nch_in: int = 3, nch_out: int = 8, nch: int = 64,
                 num_cls: int = 4, num_con: int = 4,
                 norm_type: str = "instance"):
        super().__init__(nch_in, nch, num_cls, num_con, norm_type)
        self.num_con = num_con
        feat = nch * 2 ** num_cls
        self.fcmean = Linear(feat, nch_out)
        self.fcvar = Linear(feat, nch_out)

    def forward(self, x, c):
        """x: (B, nch_in, H, W); c: (B, num_con) one-hot.  Returns
        (c_code, mu, logvar), fp32; with ``sample=False`` the style code is
        ``mu`` itself."""
        feat = self.features(x, c)
        with torch.autocast(feat.device.type, enabled=False):
            mu = self.fcmean(feat)
            return mu, mu, self.fcvar(feat)


class Encoder(_Trunk):
    """Unconditional trunk with VAE and class heads
    (``srgan_tpu/nn/encoder.py:137-172``)."""

    def __init__(self, nch_in: int = 3, nch_out: int = 8, nch: int = 64,
                 num_cls: int = 4, num_con: int = 4,
                 norm_type: str = "instance"):
        super().__init__(nch_in, nch, num_cls, norm_type=norm_type)
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
                 num_con: int = 4, norm_type: str = "instance"):
        super().__init__(nch_in, nch, num_cls, norm_type=norm_type)
        self.fcclass = Linear(nch * 2 ** num_cls, num_con)

    def forward(self, x):
        """x: (B, nch_in, H, W).  Returns class probabilities (B, num_con),
        fp32."""
        feat = self.features(x)
        with torch.autocast(feat.device.type, enabled=False):
            return torch.softmax(self.fcclass(feat), dim=-1)
