"""SingleGAN encoder-decoder generator with conditional-norm style injection
(counterpart of ``srgan_tpu/nn/generator.py``), NCHW.

7x7 stem + ``num_cls`` stride-``reduce`` down convs, each followed by the
conditional norm + ReLU -> ``res_num`` residual blocks -> mirrored transposed
convs with an unconditional norm + ReLU -> 7x7 conv -> tanh.  ``c`` is
[one-hot class || style latent]; module and key names follow the
reference's ``SingleGenerator`` so its state dicts load with ``strict=True``.

``norm_type="instance"``: CBINorm and plain instance norm (the kernels).
``norm_type="batch"``: CBBNorm on the down path and in the residual blocks,
``BatchNorm`` (``up_norms.{j}``) on the up path, each ReLU after its norm;
``G.train()`` normalises by the batch's statistics and moves the running
ones, ``G.eval()`` normalises by the running ones (``use_running_average=
not train``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from srgan_tpu_torch.nn.layers import (
    BatchNorm,
    Conv2d,
    ConvTranspose2d,
    instance_norm,
    make_cnorm,
)


class SingleResidualBlock(nn.Module):
    """2x(3x3 conv -> conditional norm) with ReLU and residual add
    (``srgan_tpu/nn/generator.py:32-58``)."""

    def __init__(self, nch: int, num_con: int, norm_type: str = "instance"):
        super().__init__()
        self.c1 = Conv2d(nch, nch, 3, 1, 1, bias=False)
        self.cn1 = make_cnorm(norm_type, nch, num_con)
        self.c2 = Conv2d(nch, nch, 3, 1, 1, bias=False)
        self.cn2 = make_cnorm(norm_type, nch, num_con)

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
        nch_out = nch_in if nch_out is None else nch_out
        k, p = 2 * reduce, reduce // 2
        self.num_con = num_con
        self.down_convs = nn.ModuleList(
            [Conv2d(nch_in, nch, 7, 1, 3, bias=False)]
            + [Conv2d(nch * 2 ** i, nch * 2 ** (i + 1), k, reduce, p,
                      bias=False) for i in range(num_cls)])
        self.down_cnorms = nn.ModuleList(
            make_cnorm(norm_type, nch * 2 ** i, num_con)
            for i in range(num_cls + 1))
        self.resBlocks = nn.ModuleList(
            SingleResidualBlock(nch * 2 ** num_cls, num_con, norm_type)
            for _ in range(res_num))
        self.up_convs = nn.ModuleList(
            [ConvTranspose2d(nch * 2 ** i, nch * 2 ** (i - 1), k, reduce, p,
                             bias=False) for i in range(num_cls, 0, -1)]
            + [Conv2d(nch, nch_out, 7, 1, 3, bias=False)])
        if norm_type == "batch":
            self.up_norms = nn.ModuleList(
                BatchNorm(nch * 2 ** (i - 1)) for i in range(num_cls, 0, -1))
        else:
            self.up_norms = None

    def forward(self, x, c):
        """x: (B, nch_in, H, W) in [-1, 1]; c: (B, num_con).  Returns the
        tanh output (B, nch_out, H, W) in fp32."""
        h = x
        for conv, cnorm in zip(self.down_convs, self.down_cnorms):
            h = cnorm(conv(h), c, relu=True)
        for block in self.resBlocks:
            h = block(h, c)
        for j, conv in enumerate(self.up_convs[:-1]):
            if self.up_norms is None:
                h = instance_norm(conv(h), relu=True)
            else:
                h = self.up_norms[j](conv(h), relu=True)
        return torch.tanh(self.up_convs[-1](h).float())
