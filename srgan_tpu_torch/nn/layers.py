"""Layer primitives of the port, NCHW (counterpart of
``srgan_tpu/nn/layers.py``).

Convolutions and linear layers are torch's own modules: their weight layout
is the reference's state-dict layout, and their default init is the one the
JAX package replicates (``srgan_tpu/nn/layers.py:45-68``).  Two TPU-only
rewrites are not carried over: the output space-to-depth head of narrow
convs (``:222-245``) and the pre-flipped ConvTranspose kernel storage; the
weight bridge in ``utils/checkpoint.py`` undoes the flip.

Instance norms go through ``ops/norm.py``: the CUDA kernel on the card, its
plain twin on the CPU.  The batch-norm mode's ``CBBNorm`` and ``BatchNorm``
are plain torch ops, as their JAX counterparts are jnp: the same batch
statistics on every device, or over the whole global batch when a norm's
``mesh`` is set (``GANTrainer`` sets it under data parallel), and running
statistics in eval mode (``module.eval()``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn import Conv2d, ConvTranspose2d, Linear  # noqa: F401 (re-export)

from srgan_tpu_torch.ops import norm
from srgan_tpu_torch.parallel.collectives import all_reduce_sum


def init_torch_default_(module: nn.Module, generator: torch.Generator
                        ) -> nn.Module:
    """Draw every conv and linear parameter as torch's ``reset_parameters``
    does, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with fan_in from the weight's
    own shape (so (out * kh * kw) for a transposed conv), from
    ``generator``; CBINorm's and BatchNorm's affine starts at weight 1, bias
    0, CBBNorm's weight at U(0, 1) (``srgan_tpu/nn/layers.py:401-403``);
    running means at 0, running variances at 1."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                fan_in = nn.init._calculate_fan_in_and_fan_out(m.weight)[0]
                bound = 1.0 / math.sqrt(fan_in)
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, (CBINorm, BatchNorm)):
                m.weight.fill_(1.0)
                m.bias.fill_(0.0)
            elif isinstance(m, CBBNorm):
                m.weight.uniform_(0.0, 1.0, generator=generator)
                m.bias.fill_(0.0)
            if isinstance(m, (CBBNorm, BatchNorm)):
                m.running_mean.fill_(0.0)
                m.running_var.fill_(1.0)
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


def _moments(x, mesh, two_pass: bool):
    """Per-channel mean and biased variance of fp32 ``x`` (B, C, H, W) over
    B, H, W, and the number of elements they count.  ``two_pass`` takes the
    variance around the mean (``jnp.var``), else E[x^2] - E[x]^2 clipped at
    0 (flax ``BatchNorm``'s fast variance).  With a ``mesh`` the sums are
    all-reduced (with autograd) over its ranks: the global batch's
    statistics, as GSPMD computes them."""
    dims = (0, 2, 3)
    local_n = x.numel() // x.shape[1]
    if mesh is None:
        if two_pass:
            var, mean = torch.var_mean(x, dims, correction=0)
        else:
            mean = x.mean(dims)
            var = torch.clamp_min((x * x).mean(dims) - mean * mean, 0.0)
        return mean, var, local_n
    # every rank holds the same number of rows (``shard_batch``)
    c, n = x.shape[1], local_n * mesh.size
    if two_pass:
        mean = all_reduce_sum(x.sum(dims), mesh) / n
        sq = ((x - mean[None, :, None, None]) ** 2).sum(dims)
        var = all_reduce_sum(sq, mesh) / n
    else:
        s = all_reduce_sum(torch.cat([x.sum(dims), (x * x).sum(dims)]),
                           mesh) / n
        mean = s[:c]
        var = torch.clamp_min(s[c:] - mean * mean, 0.0)
    return mean, var, n


def _per_channel(v):
    return v[None, :, None, None]


class CBBNorm(nn.Module):
    """Conditional batch norm, the batch-norm mode's style injection
    (``srgan_tpu/nn/layers.py:364-410``): batch-normalise, subtract each
    (sample, channel)'s spatial mean of the result, add
    ``tanh(Linear(cond))``, then the affine; fp32 whatever the compute
    dtype.  In training the batch's mean and biased variance normalise and
    the running statistics move by ``momentum`` toward the mean and the
    *unbiased* variance (``:395-398``); in eval the running ones normalise.
    Keys: ``ConBias.0.{weight,bias}``, ``weight``, ``bias``,
    ``running_mean``, ``running_var``.  ``relu`` applies the caller's
    following ReLU (not fused: nothing here is a kernel)."""

    def __init__(self, num_features: int, num_con: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.mesh = None
        self.ConBias = nn.Sequential(Linear(num_con, num_features), nn.Tanh())
        self.weight = nn.Parameter(torch.empty(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x, cond, relu: bool = False):
        x32 = x.float()
        if self.training:
            mean, var, n = _moments(x32, self.mesh, two_pass=True)
            with torch.no_grad():
                m = self.momentum
                unbiased = var * n / max(n - 1, 1)
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        out = (x32 - _per_channel(mean)) * _per_channel(
            torch.rsqrt(var + self.eps))
        out = out - out.mean(dim=(2, 3), keepdim=True)
        with torch.autocast(x.device.type, enabled=False):
            t = self.ConBias(cond.float())
        out = (out + t[:, :, None, None]) * _per_channel(self.weight) \
            + _per_channel(self.bias)
        if relu:
            out = torch.relu(out)
        return out.to(x.dtype)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` on NCHW, as the
    batch-norm mode's unconditional norm (``srgan_tpu/nn/generator.py:
    89-93``, ``encoder.py:79-82``): in training the batch's mean and biased
    variance (E[x^2] - E[x]^2, flax's fast variance) normalise, and the
    running statistics move as flax moves them, ``0.9 * running + 0.1 *
    batch`` with the *biased* variance (torch's ``BatchNorm2d`` moves the
    unbiased one); in eval the running ones normalise.  fp32 statistics;
    the output in the input's dtype.  Keys: ``weight``, ``bias``,
    ``running_mean``, ``running_var``."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.mesh = None
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x, relu: bool = False):
        x32 = x.float()
        if self.training:
            mean, var, _ = _moments(x32, self.mesh, two_pass=False)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean)
                self.running_var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        out = (x32 - _per_channel(mean)) * _per_channel(mul) \
            + _per_channel(self.bias)
        if relu:
            out = torch.relu(out)
        return out.to(x.dtype)


def make_cnorm(norm_type: str, num_features: int, num_con: int):
    """The conditional norm of ``norm_type``: ``CBINorm`` ("instance") or
    ``CBBNorm`` ("batch"); another name raises, as ``get_norm_kind`` does
    (``srgan_tpu/nn/layers.py:413-418``)."""
    if norm_type == "instance":
        return CBINorm(num_features, num_con)
    if norm_type == "batch":
        return CBBNorm(num_features, num_con)
    raise NotImplementedError(
        f"normalization layer [{norm_type}] is not found")
