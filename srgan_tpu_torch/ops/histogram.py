"""Gaussian soft histogram per column: the CUDA kernels' wrappers and their
plain twins.

Counterpart of ``srgan_tpu/ops/pallas/histogram.py``.
``soft_histogram_cols`` is a ``torch.autograd.Function``: on a CUDA tensor
its forward launches ``srgan_soft_histogram_fwd`` and its backward
``srgan_soft_histogram_bwd`` (``csrc/histogram.cu``), or raises; on a CPU
tensor they compute ``soft_histogram_cols_plain`` (``gaussian_histogram``
per column) and ``soft_histogram_cols_bwd_plain`` (its closed-form
gradient).  The sizes are tiny ((128, 8) -> (8, 50) on the training path):
a launch costs its latency, not its bytes.
"""

from __future__ import annotations

import ctypes
import math

import torch

# kernel launches since the last reset, forward and backward
LAUNCHES = 0
BWD_LAUNCHES = 0


def _consts(bins: int, vmin: float, vmax: float, sigma: float):
    delta = (vmax - vmin) / bins
    return delta, delta / (sigma * math.sqrt(2.0 * math.pi))


def _centers(bins: int, vmin: float, vmax: float, device):
    delta = (vmax - vmin) / bins
    return vmin + delta * (torch.arange(bins, dtype=torch.float32,
                                        device=device) + 0.5)


def gaussian_histogram(x, bins: int = 50, vmin: float = -10.0,
                       vmax: float = 10.0, sigma: float = 0.2):
    """Differentiable histogram via Gaussian KDE at bin centres
    (``srgan_tpu/ops/losses.py:144-157``, reference util.py:532-537):
    ``sum_j exp(-0.5 ((x_j - c_b)/sigma)^2) / (sigma sqrt(2 pi)) * delta``.
    x: (n,) -> (bins,), fp32."""
    x = x.float()
    delta = (vmax - vmin) / bins
    diff = x[None, :] - _centers(bins, vmin, vmax, x.device)[:, None]
    w = torch.exp(-0.5 * (diff / sigma) ** 2) \
        / (sigma * math.sqrt(2 * math.pi)) * delta
    return w.sum(dim=1)


def soft_histogram_cols_plain(mu, bins: int = 50, vmin: float = -10.0,
                              vmax: float = 10.0, sigma: float = 0.2):
    """``gaussian_histogram`` of every column: (B, D) -> (D, bins)."""
    return torch.stack([gaussian_histogram(mu[:, d], bins, vmin, vmax, sigma)
                        for d in range(mu.shape[1])])


def soft_histogram_cols_bwd_plain(mu, gh, bins: int = 50, vmin: float = -10.0,
                                  vmax: float = 10.0, sigma: float = 0.2):
    """Closed-form gradient of ``soft_histogram_cols_plain``:
    dmu[i, d] = sum_b gh[d, b] (-w z / sigma), z = (mu[i, d] - c_b)/sigma,
    w = exp(-z^2/2) delta / (sigma sqrt(2 pi)).  (B, D), fp32."""
    _, norm = _consts(bins, vmin, vmax, sigma)
    c = _centers(bins, vmin, vmax, mu.device)
    z = (mu.T[:, None, :] - c[None, :, None]) / sigma         # (D, bins, B)
    w = torch.exp(-0.5 * z * z) * norm
    return (-w * z / sigma * gh[:, :, None]).sum(dim=1).T.contiguous()


def _check(mu, name="mu"):
    if mu.dim() != 2 or mu.dtype != torch.float32 or not mu.is_contiguous():
        raise ValueError(f"soft_histogram_cols: {name} must be a contiguous "
                         f"2-D float32 tensor, got {tuple(mu.shape)} "
                         f"{mu.dtype}")
    if mu.numel() == 0 or mu.numel() >= 2 ** 31:
        raise ValueError(f"soft_histogram_cols: {name} has {mu.numel()} "
                         "elements")
    if mu.device.type not in ("cuda", "cpu"):
        raise ValueError(f"soft_histogram_cols runs on cuda (kernel) or cpu "
                         f"(plain), not on {mu.device}")


def _lib():
    from srgan_tpu_torch.ops.build import load
    return load("histogram")


def soft_histogram_fwd(mu, bins: int = 50, vmin: float = -10.0,
                       vmax: float = 10.0, sigma: float = 0.2):
    """The forward alone, no graph: the kernel on a CUDA mu, the plain twin
    on a CPU mu.  mu: (B, D) fp32 contiguous -> (D, bins) fp32."""
    global LAUNCHES
    _check(mu)
    if mu.device.type == "cpu":
        return soft_histogram_cols_plain(mu, bins, vmin, vmax, sigma)
    B, D = mu.shape
    delta, norm = _consts(bins, vmin, vmax, sigma)
    h = torch.empty((D, bins), dtype=torch.float32, device=mu.device)
    with torch.cuda.device(mu.device):
        err = _lib().srgan_soft_histogram_fwd(
            mu.data_ptr(), h.data_ptr(), B, D, bins, ctypes.c_float(vmin),
            ctypes.c_float(delta), ctypes.c_float(sigma),
            ctypes.c_float(norm),
            torch.cuda.current_stream(mu.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"soft histogram kernel launch failed: "
                           f"cudaError_t {err}")
    LAUNCHES += 1
    return h


def soft_histogram_bwd(mu, gh, bins: int = 50, vmin: float = -10.0,
                       vmax: float = 10.0, sigma: float = 0.2):
    """The backward alone: the kernel on a CUDA mu, the plain twin on a CPU
    mu.  gh: (D, bins), cast to fp32 contiguous -> dmu (B, D) fp32."""
    global BWD_LAUNCHES
    _check(mu)
    gh = gh.float().contiguous()
    if tuple(gh.shape) != (mu.shape[1], bins) or gh.device != mu.device:
        raise ValueError(f"soft_histogram_cols: gradient {tuple(gh.shape)} "
                         f"on {gh.device} does not match "
                         f"({mu.shape[1]}, {bins}) on {mu.device}")
    if mu.device.type == "cpu":
        return soft_histogram_cols_bwd_plain(mu, gh, bins, vmin, vmax, sigma)
    B, D = mu.shape
    delta, norm = _consts(bins, vmin, vmax, sigma)
    dmu = torch.empty_like(mu)
    with torch.cuda.device(mu.device):
        err = _lib().srgan_soft_histogram_bwd(
            mu.data_ptr(), gh.data_ptr(), dmu.data_ptr(), B, D, bins,
            ctypes.c_float(vmin), ctypes.c_float(delta),
            ctypes.c_float(sigma), ctypes.c_float(norm),
            torch.cuda.current_stream(mu.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"soft histogram backward kernel launch failed: "
                           f"cudaError_t {err}")
    BWD_LAUNCHES += 1
    return dmu


class SoftHistogramFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mu, bins, vmin, vmax, sigma):
        ctx.save_for_backward(mu)
        ctx.args = (bins, vmin, vmax, sigma)
        return soft_histogram_fwd(mu, bins, vmin, vmax, sigma)

    @staticmethod
    def backward(ctx, gh):
        (mu,) = ctx.saved_tensors
        return soft_histogram_bwd(mu, gh, *ctx.args), None, None, None, None


def soft_histogram_cols(mu, bins: int = 50, vmin: float = -10.0,
                        vmax: float = 10.0, sigma: float = 0.2):
    """Per-column Gaussian soft histograms: (B, D) -> (D, bins), fp32, with
    the kernels (CUDA) or the plain twins (CPU) both ways."""
    return SoftHistogramFunction.apply(mu.float().contiguous(), bins, vmin,
                                       vmax, sigma)
