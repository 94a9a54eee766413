"""SingleGAN encoder-decoder generator with conditional-IN style injection
(counterpart of ``srgan_tpu/nn/generator.py``), NCHW, instance-norm mode.

7x7 stem + ``num_cls`` stride-``reduce`` down convs, each followed by CBINorm
+ ReLU -> ``res_num`` residual blocks -> mirrored transposed convs with
unconditional instance norm + ReLU -> 7x7 conv -> tanh.  ``c`` is
[one-hot class || style latent]; module and key names follow the
reference's ``SingleGenerator`` so its state dicts load with ``strict=True``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from srgan_tpu_torch.nn.layers import (
    CBINorm,
    Conv2d,
    ConvTranspose2d,
    instance_norm,
)


class SingleResidualBlock(nn.Module):
    """2x(3x3 conv -> CBINorm) with ReLU and residual add
    (``srgan_tpu/nn/generator.py:32-58``)."""

    def __init__(self, nch: int, num_con: int):
        super().__init__()
        self.c1 = Conv2d(nch, nch, 3, 1, 1, bias=False)
        self.cn1 = CBINorm(nch, num_con)
        self.c2 = Conv2d(nch, nch, 3, 1, 1, bias=False)
        self.cn2 = CBINorm(nch, num_con)

    def forward(self, x, c):
        h = self.cn1(self.c1(x), c, relu=True)
        h = self.cn2(self.c2(h), c)
        return h + x


class SingleGenerator(nn.Module):
    def __init__(self, nch_in: int = 3, nch: int = 64, reduce: int = 2,
                 num_cls: int = 2, res_num: int = 6,
                 norm_type: str = "instance", num_con: int = 12,
                 nch_out: Optional[int] = None):
        super().__init__()
        if norm_type != "instance":
            raise NotImplementedError(
                f"norm_type {norm_type!r}: only instance norm is ported")
        nch_out = nch_in if nch_out is None else nch_out
        k, p = 2 * reduce, reduce // 2
        self.num_con = num_con
        self.down_convs = nn.ModuleList(
            [Conv2d(nch_in, nch, 7, 1, 3, bias=False)]
            + [Conv2d(nch * 2 ** i, nch * 2 ** (i + 1), k, reduce, p,
                      bias=False) for i in range(num_cls)])
        self.down_cnorms = nn.ModuleList(
            CBINorm(nch * 2 ** i, num_con) for i in range(num_cls + 1))
        self.resBlocks = nn.ModuleList(
            SingleResidualBlock(nch * 2 ** num_cls, num_con)
            for _ in range(res_num))
        self.up_convs = nn.ModuleList(
            [ConvTranspose2d(nch * 2 ** i, nch * 2 ** (i - 1), k, reduce, p,
                             bias=False) for i in range(num_cls, 0, -1)]
            + [Conv2d(nch, nch_out, 7, 1, 3, bias=False)])

    def forward(self, x, c):
        """x: (B, nch_in, H, W) in [-1, 1]; c: (B, num_con).  Returns the
        tanh output (B, nch_out, H, W) in fp32."""
        h = x
        for conv, cnorm in zip(self.down_convs, self.down_cnorms):
            h = cnorm(conv(h), c, relu=True)
        for block in self.resBlocks:
            h = block(h, c)
        for conv in self.up_convs[:-1]:
            h = instance_norm(conv(h), relu=True)
        return torch.tanh(self.up_convs[-1](h).float())
