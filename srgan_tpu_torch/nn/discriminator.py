"""PatchGAN discriminators, NCHW (counterpart of
``srgan_tpu/nn/discriminator.py``): the per-domain family (SingleGAN, nb01)
and the solo one (StarGAN-style, nb02-05).

Both run a strided-conv trunk with LeakyReLU 0.01 and no norm at full
resolution and the same trunk at half width on an ``AvgPool2d(3, 2, 1,
count_include_pad=False)`` copy.  The per-domain D ends each trunk in a
1-channel patch conv (``conv_out``); the trainer keeps one per domain in an
``nn.ModuleList``.  The solo D has per scale a real/fake patch head and a
domain-classification head whose softmax runs in fp32 over the class
dimension.  Module and key names follow the reference's
``SingleDiscriminator_original_multi`` and
``SingleDiscriminator_solo_multi`` (the layouts of
``srgan_tpu/utils/checkpoint.py::export_torch_original_discriminator`` and
``export_torch_solo_discriminator``), so their state dicts load with
``strict=True``.
"""

from __future__ import annotations

from typing import Tuple

import torch.nn.functional as F
from torch import nn

from srgan_tpu_torch.nn.layers import Conv2d, avg_pool2d


class SingleDiscriminatorSolo(nn.Module):
    """The trunk: 4x4 stride-2 conv to ``nch``, then ``num_cls - 1``
    stride-``reduce`` convs doubling the width up to ``8 * nch``, each
    followed by LeakyReLU(0.01), no bias; ``head`` appends the per-domain
    D's ``conv_out``."""

    def __init__(self, nch_in: int = 3, nch: int = 64, reduce: int = 2,
                 num_cls: int = 4, head: bool = False):
        super().__init__()
        k, p = 2 * reduce, reduce // 2
        layers = [Conv2d(nch_in, nch, 4, 2, 1, bias=False), nn.LeakyReLU(0.01)]
        dim_in = nch
        for _ in range(1, num_cls):
            dim_out = min(dim_in * 2, nch * 8)
            layers += [Conv2d(dim_in, dim_out, k, reduce, p, bias=False),
                       nn.LeakyReLU(0.01)]
            dim_in = dim_out
        if head:
            layers.append(Conv2d(dim_in, 1, 4, 1, 1, bias=True))
        self.down_convs = nn.Sequential(*layers)
        self.nch_out = dim_in

    def forward(self, x):
        return self.down_convs(x)


class SingleDiscriminatorOriginal(SingleDiscriminatorSolo):
    """One domain's single-scale D: the trunk, then ``conv_out``, a 4x4
    conv to one channel with bias, at ``down_convs.{2 * num_cls}``
    (``srgan_tpu/nn/discriminator.py:28-52``)."""

    def __init__(self, nch_in: int = 3, nch: int = 64, reduce: int = 2,
                 num_cls: int = 4):
        super().__init__(nch_in, nch, reduce, num_cls, head=True)


class SingleDiscriminatorOriginalMulti(nn.Module):
    """One domain's two-scale D (``srgan_tpu/nn/discriminator.py:55-72``):
    returns [out1, out2], (B, 1, h, w) patch maps in the compute dtype, of
    the full-resolution D and of the half-width one on the pooled copy."""

    def __init__(self, nch_in: int = 3, nch: int = 64, reduce: int = 2,
                 num_cls: int = 4):
        super().__init__()
        self.discriminator1 = SingleDiscriminatorOriginal(nch_in, nch, reduce,
                                                          num_cls)
        self.discriminator2 = SingleDiscriminatorOriginal(nch_in, nch // 2,
                                                          reduce, num_cls)

    def forward(self, x):
        return [self.discriminator1(x),
                self.discriminator2(avg_pool2d(x, 3, 2, 1,
                                               count_include_pad=False))]


class SingleDiscriminatorSoloMulti(nn.Module):
    """Returns ([adv1, adv2], [cls1, cls2]): adv* are (B, 1, h, w) patch
    maps in the compute dtype, cls* (B, n_class) fp32 softmax class
    predictions.  ``cls_kernels`` sizes the class heads to the trunks'
    output maps, (image_size // 2**num_cls, that // 2), as
    ``srgan_tpu/training/gan.py:121-126`` does."""

    def __init__(self, nch_in: int = 3, nch: int = 64, reduce: int = 2,
                 num_cls: int = 4, n_class: int = 4,
                 cls_kernels: Tuple[int, int] = (8, 4)):
        super().__init__()
        self.n_class = n_class
        self.discriminator1 = SingleDiscriminatorSolo(nch_in, nch, reduce,
                                                      num_cls)
        self.discriminator2 = SingleDiscriminatorSolo(nch_in, nch // 2,
                                                      reduce, num_cls)
        d1, d2 = self.discriminator1.nch_out, self.discriminator2.nch_out
        self.last_layer1 = Conv2d(d1, 1, 4, 1, 1, bias=True)
        self.last_layer2 = Conv2d(d2, 1, 4, 1, 1, bias=True)
        self.classification_layer1 = nn.Sequential(
            Conv2d(d1, n_class, cls_kernels[0], 1, 0, bias=True))
        self.classification_layer2 = nn.Sequential(
            Conv2d(d2, n_class, cls_kernels[1], 1, 0, bias=True))

    def _classes(self, c):
        # softmax over the class dim in fp32; the JAX module reshapes its
        # NHWC map to (-1, n_class), so do the same from NHWC
        return F.softmax(c.float(), dim=1).permute(0, 2, 3, 1).reshape(
            -1, self.n_class)

    def forward(self, x):
        h1 = self.discriminator1(x)
        h2 = self.discriminator2(avg_pool2d(x, 3, 2, 1,
                                            count_include_pad=False))
        adv = [self.last_layer1(h1), self.last_layer2(h2)]
        cls = [self._classes(self.classification_layer1(h1)),
               self._classes(self.classification_layer2(h2))]
        return adv, cls
