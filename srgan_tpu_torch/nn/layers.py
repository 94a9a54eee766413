"""Layer primitives of the port, NCHW (counterpart of
``srgan_tpu/nn/layers.py``).

Convolutions and linear layers are torch's own modules: their weight layout
is the reference's state-dict layout, and their default init is the one the
JAX package replicates (``srgan_tpu/nn/layers.py:45-68``).  Two TPU-only
rewrites are not carried over: the output space-to-depth head of narrow
convs (``:222-245``) and the pre-flipped ConvTranspose kernel storage; the
weight bridge in ``utils/checkpoint.py`` undoes the flip.

Every normalisation goes through ``ops/norm.py``: the CUDA kernel on the
card, its plain twin on the CPU.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn import Conv2d, ConvTranspose2d, Linear  # noqa: F401 (re-export)

from srgan_tpu_torch.ops import norm


def init_torch_default_(module: nn.Module, generator: torch.Generator
                        ) -> nn.Module:
    """Draw every conv and linear parameter as torch's ``reset_parameters``
    does, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with fan_in from the weight's
    own shape (so (out * kh * kw) for a transposed conv), from
    ``generator``; CBINorm's affine starts at weight 1, bias 0."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                fan_in = nn.init._calculate_fan_in_and_fan_out(m.weight)[0]
                bound = 1.0 / math.sqrt(fan_in)
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, CBINorm):
                m.weight.fill_(1.0)
                m.bias.fill_(0.0)
    return module


def instance_norm(x, eps: float = 1e-5, relu: bool = False):
    """Per-(sample, channel) normalisation over H, W with fp32 statistics,
    no affine (``srgan_tpu/nn/layers.py:94-118``); ``relu`` fuses the
    caller's following ReLU."""
    return norm.fused_instance_norm(x.contiguous(), eps, relu)


def avg_pool2d(x, window: int, stride: int, padding: int = 0,
               count_include_pad: bool = True):
    """``nn.AvgPool2d`` semantics (``srgan_tpu/nn/layers.py:121-139``)."""
    return F.avg_pool2d(x, window, stride, padding,
                        count_include_pad=count_include_pad)


def adaptive_avg_pool(x):
    """``nn.AdaptiveAvgPool2d(1)`` + flatten: (B, C, H, W) -> (B, C), fp32
    mean (``srgan_tpu/nn/layers.py:142-144``)."""
    return x.float().mean(dim=(2, 3)).to(x.dtype)


class AvgPool2d(nn.Module):
    """``avg_pool2d`` as a module, so it can sit in an ``nn.Sequential``
    where the reference's key layout puts one."""

    def __init__(self, window: int, stride: int, padding: int = 0,
                 count_include_pad: bool = True):
        super().__init__()
        self.window, self.stride, self.padding = window, stride, padding
        self.count_include_pad = count_include_pad

    def forward(self, x):
        return avg_pool2d(x, self.window, self.stride, self.padding,
                          self.count_include_pad)


class CBINorm(nn.Module):
    """Conditional instance norm, the style-injection op
    (``srgan_tpu/nn/layers.py:324-361``):

        out = relu?((IN(x) + tanh(Linear(cond))) * weight + bias)

    Keys follow the reference: ``ConBias.0.{weight,bias}``, ``weight``,
    ``bias``.  The conditional bias is computed in fp32 whatever the
    compute dtype; the rest runs in one kernel launch.
    """

    def __init__(self, num_features: int, num_con: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.ConBias = nn.Sequential(Linear(num_con, num_features), nn.Tanh())
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x, cond, relu: bool = False):
        with torch.autocast(x.device.type, enabled=False):
            t = self.ConBias(cond.float())
        return norm.fused_cbinorm(x.contiguous(), t.contiguous(),
                                  self.weight, self.bias, self.eps, relu)[0]
