"""Conditional instance norm: the CUDA kernel's wrapper and its plain twin.

Counterpart of ``srgan_tpu/ops/pallas/norm.py``.  On a CUDA tensor
``fused_cbinorm`` launches the kernel of ``csrc/cbinorm.cu`` or raises; on a
CPU tensor it computes ``cbinorm_plain``, the same function in plain PyTorch,
which is also the kernel's oracle on the card.  Layout is NCHW.

Forward only: serving needs no gradient.  ``mu`` and ``rstd`` are returned
for the backward kernel of the training slice.
"""

from __future__ import annotations

import torch

# kernel launches since the last reset; the smoke run sets it to 0 before it
# drives the serving path and reads it afterwards
LAUNCHES = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def cbinorm_plain(x, t, g, b, eps: float = 1e-5, relu: bool = False):
    """out = relu?((IN(x) + t[b, c]) * g[c] + b[c]) in plain PyTorch.

    x: (B, C, H, W) float32 or bfloat16; t: (B, C), g and b: (C,) float32.
    Statistics in fp32 with the one-pass formula and variance clamp of
    ``srgan_tpu/nn/layers.py:110-118``; the affine and ReLU as at
    ``:356-361``.  Like the kernel, the normalised value is not rounded to
    x's dtype before the conditional bias is added.  Returns
    (out in x's dtype, mu (B, C) fp32, rstd (B, C) fp32).
    """
    x32 = x.float()
    mean = x32.mean(dim=(2, 3), keepdim=True)
    m2 = (x32 * x32).mean(dim=(2, 3), keepdim=True)
    var = torch.clamp_min(m2 - mean * mean, 0.0)
    rstd = torch.rsqrt(var + eps)
    out = (x32 - mean) * rstd
    out = (out + t[:, :, None, None]) * g[None, :, None, None] \
        + b[None, :, None, None]
    if relu:
        out = torch.clamp_min(out, 0.0)
    return out.to(x.dtype), mean[:, :, 0, 0], rstd[:, :, 0, 0]


def _check(x, t, g, b):
    if x.dim() != 4:
        raise ValueError(f"fused_cbinorm takes NCHW x, got shape "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_cbinorm takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    B, C = x.shape[:2]
    for name, v, shape in (("t", t, (B, C)), ("g", g, (C,)), ("b", b, (C,))):
        if tuple(v.shape) != shape:
            raise ValueError(f"fused_cbinorm: {name} must have shape {shape}, "
                             f"got {tuple(v.shape)}")
        if v.dtype != torch.float32:
            raise TypeError(f"fused_cbinorm: {name} must be float32, got "
                            f"{v.dtype}")
    for name, v in (("x", x), ("t", t), ("g", g), ("b", b)):
        if v.device != x.device:
            raise ValueError(f"fused_cbinorm: {name} is on {v.device}, x on "
                             f"{x.device}")
        if not v.is_contiguous():
            raise ValueError(f"fused_cbinorm: {name} must be contiguous")
    if x.numel() == 0:
        raise ValueError("fused_cbinorm: x is empty")
    if B * C >= 2 ** 31 or x.shape[2] * x.shape[3] >= 2 ** 31:
        raise ValueError("fused_cbinorm: B*C and H*W must fit in int32")


def _launch(x, t, g, b, eps: float, relu: bool):
    import ctypes

    from srgan_tpu_torch.ops.build import load

    global LAUNCHES
    B, C, H, W = x.shape
    out = torch.empty_like(x)
    mu = torch.empty((B, C), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mu)
    fn = load("cbinorm").srgan_cbinorm_fwd
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), t.data_ptr(), g.data_ptr(), b.data_ptr(),
                 out.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
                 B * C, C, H * W, ctypes.c_float(eps), int(relu),
                 _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"cbinorm kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return out, mu, rstd


def fused_cbinorm(x, t, g, b, eps: float = 1e-5, relu: bool = False):
    """out = relu?((IN(x) + t[b, c]) * g[c] + b[c]), with (mu, rstd).

    x: (B, C, H, W) float32 or bfloat16, contiguous; t: (B, C) conditional
    bias (already tanh'ed), g, b: (C,) affine, all float32 on x's device.
    A CUDA x launches the kernel; a CPU x takes ``cbinorm_plain``; any
    other device raises.  Returns (out in x's dtype, mu, rstd).
    """
    _check(x, t, g, b)
    if x.device.type == "cuda":
        return _launch(x, t, g, b, eps, relu)
    if x.device.type == "cpu":
        return cbinorm_plain(x, t, g, b, eps, relu)
    raise ValueError(f"fused_cbinorm runs on cuda (kernel) or cpu (plain), "
                     f"not on {x.device}")


def fused_instance_norm(x, eps: float = 1e-5, relu: bool = False):
    """Plain instance norm (optionally + ReLU): the same kernel with t = 0,
    g = 1, b = 0, as ``srgan_tpu/ops/pallas/norm.py:162-168``."""
    B, C = x.shape[:2]
    zeros_t = torch.zeros((B, C), dtype=torch.float32, device=x.device)
    ones = torch.ones((C,), dtype=torch.float32, device=x.device)
    zeros = torch.zeros((C,), dtype=torch.float32, device=x.device)
    return fused_cbinorm(x, zeros_t, ones, zeros, eps, relu)[0]
