"""The plain reference of the nets: SRGAN's generator, discriminators and
encoders (Style-Restricted GAN, arXiv:2105.07621; notebooks 01-05 of
shinshoji01/Style-Restricted_GAN) in plain PyTorch, NCHW, with the state-dict
key layout of the original notebooks.

Nothing here comes from the program under test: the norm is written out in
plain operations, there is no kernel and no autocast.  ``precision`` on
every convolution and linear layer is "fp32" (the reference) or "fp8" (the
control: inputs and weights rounded to float8 e4m3 with a per-tensor scale
on the way in, gradients to e5m2 on the way back, the arithmetic in fp32).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def fake_fp8(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` (a float8 type) under a per-tensor scale
    that maps its largest magnitude to the type's largest finite value."""
    scale = t.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX[dtype]
    return ((t.float() / scale).to(dtype).float() * scale).to(t.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return fake_fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return fake_fp8(g, torch.float8_e5m2)


def quant(x, precision: str):
    if precision == "fp32":
        return x
    if precision == "fp8":
        return _Fp8.apply(x)
    raise ValueError(f"precision {precision!r}: fp32 or fp8")


class Conv2d(nn.Conv2d):
    precision = "fp32"

    def forward(self, x):
        q = self.precision
        if self.padding_mode != "zeros":
            x = F.pad(x, self._reversed_padding_repeated_twice,
                      mode=self.padding_mode)
            pad = 0
        else:
            pad = self.padding
        return F.conv2d(quant(x, q), quant(self.weight, q),
                        None if self.bias is None else self.bias,
                        self.stride, pad)


class ConvTranspose2d(nn.ConvTranspose2d):
    precision = "fp32"

    def forward(self, x):
        q = self.precision
        return F.conv_transpose2d(quant(x, q), quant(self.weight, q),
                                  self.bias, self.stride, self.padding)


class Linear(nn.Linear):
    precision = "fp32"

    def forward(self, x):
        q = self.precision
        return F.linear(quant(x, q), quant(self.weight, q), self.bias)


def set_precision(module: nn.Module, precision: str) -> nn.Module:
    quant(torch.zeros(()), precision)   # rejects an unknown name
    for m in module.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d, Linear)):
            m.precision = precision
    return module


# every norm application calls this hook with (x, with_affine): the counts
# of ``reference/counts.py`` record them; None otherwise
NORM_HOOK = None


def instance_norm(x, eps: float = 1e-5):
    """(x - mean) / sqrt(var + eps) per sample and channel over H, W, with
    the biased variance."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def plain_norm(x, relu: bool = False):
    if NORM_HOOK is not None:
        NORM_HOOK(x, False)
    out = instance_norm(x)
    return torch.relu(out) if relu else out


class CBINorm(nn.Module):
    """Conditional instance norm: (IN(x) + tanh(Linear(cond))) * w + b."""

    def __init__(self, num_features: int, num_con: int):
        super().__init__()
        self.ConBias = nn.Sequential(Linear(num_con, num_features), nn.Tanh())
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x, cond, relu: bool = False):
        if NORM_HOOK is not None:
            NORM_HOOK(x, True)
        t = self.ConBias(cond)
        out = (instance_norm(x) + t[:, :, None, None]) \
            * self.weight[None, :, None, None] + self.bias[None, :, None, None]
        return torch.relu(out) if relu else out


# --------------------------------------------------------------------------
# generator
# --------------------------------------------------------------------------

class SingleResidualBlock(nn.Module):
    def __init__(self, nch: int, num_con: int):
        super().__init__()
        self.c1 = Conv2d(nch, nch, 3, 1, 1, bias=False)
        self.cn1 = CBINorm(nch, num_con)
        self.c2 = Conv2d(nch, nch, 3, 1, 1, bias=False)
        self.cn2 = CBINorm(nch, num_con)

    def forward(self, x, c):
        h = self.cn1(self.c1(x), c, relu=True)
        return self.cn2(self.c2(h), c) + x


class SingleGenerator(nn.Module):
    """7x7 stem and ``num_cls`` strided down convs, each with a CBINorm and
    ReLU; ``res_num`` residual blocks; mirrored transposed convs with an
    instance norm and ReLU; a 7x7 conv and tanh."""

    def __init__(self, nch_in: int, nch: int, reduce: int, num_cls: int,
                 res_num: int, num_con: int):
        super().__init__()
        k, p = 2 * reduce, reduce // 2
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
            + [Conv2d(nch, nch_in, 7, 1, 3, bias=False)])

    def forward(self, x, c):
        h = x
        for conv, cnorm in zip(self.down_convs, self.down_cnorms):
            h = cnorm(conv(h), c, relu=True)
        for block in self.resBlocks:
            h = block(h, c)
        for conv in self.up_convs[:-1]:
            h = plain_norm(conv(h), relu=True)
        return torch.tanh(self.up_convs[-1](h))


# --------------------------------------------------------------------------
# discriminators
# --------------------------------------------------------------------------

class DTrunk(nn.Module):
    """4x4 stride-2 convs with LeakyReLU 0.01, doubling the width up to
    8 * nch; ``head`` adds a 4x4 conv to one channel."""

    def __init__(self, nch_in: int, nch: int, reduce: int, num_cls: int,
                 head: bool = False):
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


def half_scale(x):
    return F.avg_pool2d(x, 3, 2, 1, count_include_pad=False)


class DomainD(nn.Module):
    """One domain's two-scale patch discriminator (notebook 01)."""

    def __init__(self, nch_in: int, nch: int, reduce: int, num_cls: int):
        super().__init__()
        self.discriminator1 = DTrunk(nch_in, nch, reduce, num_cls, head=True)
        self.discriminator2 = DTrunk(nch_in, nch // 2, reduce, num_cls,
                                     head=True)

    def forward(self, x):
        return [self.discriminator1(x), self.discriminator2(half_scale(x))]


class SoloD(nn.Module):
    """The two-scale patch discriminator with class heads (notebooks 02-05):
    ([adv1, adv2], [cls1, cls2]), the class maps softmaxed over the class
    dimension and flattened from NHWC to (-1, n_class)."""

    def __init__(self, nch_in: int, nch: int, reduce: int, num_cls: int,
                 n_class: int, cls_kernels):
        super().__init__()
        self.n_class = n_class
        self.discriminator1 = DTrunk(nch_in, nch, reduce, num_cls)
        self.discriminator2 = DTrunk(nch_in, nch // 2, reduce, num_cls)
        d1, d2 = self.discriminator1.nch_out, self.discriminator2.nch_out
        self.last_layer1 = Conv2d(d1, 1, 4, 1, 1, bias=True)
        self.last_layer2 = Conv2d(d2, 1, 4, 1, 1, bias=True)
        self.classification_layer1 = nn.Sequential(
            Conv2d(d1, n_class, cls_kernels[0], 1, 0, bias=True))
        self.classification_layer2 = nn.Sequential(
            Conv2d(d2, n_class, cls_kernels[1], 1, 0, bias=True))

    def _classes(self, c):
        return F.softmax(c, dim=1).permute(0, 2, 3, 1).reshape(
            -1, self.n_class)

    def forward(self, x):
        h1 = self.discriminator1(x)
        h2 = self.discriminator2(half_scale(x))
        return ([self.last_layer1(h1), self.last_layer2(h2)],
                [self._classes(self.classification_layer1(h1)),
                 self._classes(self.classification_layer2(h2))])


# --------------------------------------------------------------------------
# encoders
# --------------------------------------------------------------------------

class BlockC(nn.Module):
    """Conditional pre-activation residual block with 2x2 average pooling
    (the SingleGAN encoder's)."""

    def __init__(self, nch_in: int, nch_out: int, num_con: int):
        super().__init__()
        self.cnorm1 = CBINorm(nch_in, num_con)
        self.conv1 = Conv2d(nch_in, nch_in, 3, 1, 1, bias=False,
                            padding_mode="reflect")
        self.cnorm2 = CBINorm(nch_in, num_con)
        self.cmp = nn.Sequential(
            Conv2d(nch_in, nch_out, 3, 1, 1, bias=False,
                   padding_mode="reflect"), nn.AvgPool2d(2, 2))
        self.shortcut = nn.Sequential(nn.AvgPool2d(2, 2),
                                      Conv2d(nch_in, nch_out, 1, 1, 0))

    def forward(self, x, d):
        h = F.leaky_relu(self.cnorm1(x, d), 0.2)
        h = F.leaky_relu(self.cnorm2(self.conv1(h), d), 0.2)
        return self.cmp(h) + self.shortcut(x)


class BlockU(nn.Module):
    """Unconditional pre-activation residual block (the SRGAN encoder's)."""

    def __init__(self, nch_in: int, nch_out: int):
        super().__init__()
        self.conv1 = Conv2d(nch_in, nch_in, 3, 1, 1, bias=False,
                            padding_mode="reflect")
        self.cmp = nn.Sequential(
            Conv2d(nch_in, nch_out, 3, 1, 1, bias=False,
                   padding_mode="reflect"), nn.AvgPool2d(2, 2))
        self.shortcut = nn.Sequential(nn.AvgPool2d(2, 2),
                                      Conv2d(nch_in, nch_out, 1, 1, 0))

    def forward(self, x):
        h = F.leaky_relu(plain_norm(x), 0.2)
        h = F.leaky_relu(plain_norm(self.conv1(h)), 0.2)
        return self.cmp(h) + self.shortcut(x)


class Encoder(nn.Module):
    """A 7x7 stride-2 conv and ``num_cls`` blocks doubling the width, a
    LeakyReLU 0.2 and a global average pool; ``fcmean`` and ``fcvar`` (and,
    unconditional, ``fcclass``).  ``num_con`` given: the conditional
    (SingleGAN) encoder, whose blocks take the class one-hot."""

    def __init__(self, nch_in: int, nch_out: int, nch: int, num_cls: int,
                 n_classes: int, conditional: bool):
        super().__init__()
        self.conditional = conditional
        self.first_layer = Conv2d(nch_in, nch, 7, 2, 1)
        widths = [(nch * 2 ** i, nch * 2 ** (i + 1)) for i in range(num_cls)]
        self.layers = nn.ModuleList(
            BlockC(a, b, n_classes) if conditional else BlockU(a, b)
            for a, b in widths)
        feat = nch * 2 ** num_cls
        self.fcmean = Linear(feat, nch_out)
        self.fcvar = Linear(feat, nch_out)
        if not conditional:
            self.fcclass = Linear(feat, n_classes)

    def forward(self, x, onehot=None):
        """(mu, logvar)."""
        h = self.first_layer(x)
        for layer in self.layers:
            h = layer(h, onehot) if self.conditional else layer(h)
        feat = F.leaky_relu(h, 0.2).mean(dim=(2, 3))
        return self.fcmean(feat), self.fcvar(feat)


# --------------------------------------------------------------------------
# construction and weights
# --------------------------------------------------------------------------

def build(config: dict, device="cpu"):
    """(G, D, E) of a configuration file's ``model`` and ``trainer``, on
    ``device`` with uninitialised parameters (``init_weights`` fills
    them); "meta" builds shapes only."""
    m = config["model"]
    per_domain = config["trainer"] == "singlegan"
    conditional = config["trainer"] in ("singlegan", "singlegan_solo")
    if m.get("norm_type", "instance") != "instance":
        raise NotImplementedError("the reference has the instance norm only")
    with torch.device(device):
        G = SingleGenerator(m["nch_in"], m["g_nch"], m["g_reduce"],
                            m["g_num_cls"], m["g_res_num"],
                            m["n_classes"] + m["ndim"])
        if per_domain:
            D = nn.ModuleList(
                DomainD(m["nch_in"], m["d_nch"], m["d_reduce"],
                        m["d_num_cls"]) for _ in range(m["n_classes"]))
        else:
            k1 = m["image_size"] // 2 ** m["d_num_cls"]
            D = SoloD(m["nch_in"], m["d_nch"], m["d_reduce"], m["d_num_cls"],
                      m["n_classes"], (k1, k1 // 2))
        E = Encoder(m["nch_in"], m["ndim"], m["e_nch"], m["e_num_cls"],
                    m["n_classes"], conditional)
    return G, D, E


def init_weights(nets, generator: torch.Generator, device):
    """State dicts for ``nets`` (modules, any device, meta included): every
    conv and linear weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan
    in from the weight's own shape; the norms' weight 1 and bias 0.  One
    uniform draw on ``generator`` for all of them, in the order of
    ``nets`` and of their state dicts."""
    plan = []
    for net in nets:
        bounds = {}
        for name, mod in net.named_modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                fan_in = nn.init._calculate_fan_in_and_fan_out(mod.weight)[0]
                for leaf in ("weight", "bias"):
                    if getattr(mod, leaf) is not None:
                        bounds[f"{name}.{leaf}"] = 1.0 / math.sqrt(fan_in)
        plan.append([(k, tuple(v.shape), bounds.get(k))
                     for k, v in net.state_dict().items()])
    total = sum(math.prod(s) for p in plan for _, s, b in p if b is not None)
    flat = torch.rand(total, generator=generator, device=device) * 2 - 1
    out, i = [], 0
    for p in plan:
        sd = {}
        for k, shape, bound in p:
            if bound is None:
                fill = 1.0 if k.endswith("weight") else 0.0
                sd[k] = torch.full(shape, fill, device=device)
            else:
                n = math.prod(shape)
                sd[k] = (flat[i:i + n] * bound).view(shape)
                i += n
        out.append(sd)
    return out
