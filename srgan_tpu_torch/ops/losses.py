"""Loss primitives of the port (counterpart of ``srgan_tpu/ops/losses.py``).

Behavioural spec from the reference, as the JAX package carries it:
  - LSGAN adversarial loss            util.py:457-462
  - domain-classification loss        util.py:464-468
  - corrcoef + correlation loss       util.py:470-517
  - Gaussian soft histogram           util.py:521-537
  - histogram-imitation loss          util.py:539-553
  - conventional VAE KL               util_notebook.py:300-304
  - batch KL                          util_notebook.py:314-320

Every loss is computed in fp32 whatever the compute dtype.  The soft
histogram and the fused stack have CUDA kernels (``ops/histogram.py``,
``ops/diversification.py``); the rest is plain PyTorch.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch

from srgan_tpu_torch.ops.histogram import (  # noqa: F401 (re-export)
    gaussian_histogram,
    soft_histogram_cols,
    soft_histogram_cols_plain,
)


def l1_loss(a, b):
    """``torch.mean(torch.abs(a - b))``: cycle / identity / regression."""
    return torch.mean(torch.abs(a.float() - b.float()))


def lsgan_loss(outputs: Sequence[torch.Tensor], target: float):
    """LSGAN MSE against a constant 0/1 target: per-scale mean over all
    patch elements, then the mean over the scales."""
    loss = 0.0
    for out in outputs:
        loss = loss + torch.mean((out.float() - target) ** 2)
    return loss / len(outputs)


def masked_lsgan_loss(outputs: Sequence[torch.Tensor], target: float, mask):
    """LSGAN loss over the samples where ``mask`` (B,) is 1: the mean runs
    over the masked samples' elements only; an empty subset gives 0."""
    loss = 0.0
    for out in outputs:
        out = out.float()
        m = mask.reshape((-1,) + (1,) * (out.dim() - 1)).float()
        count = m.sum() * (out.numel() // out.shape[0])
        loss = loss + ((out - target) ** 2 * m).sum() \
            / torch.clamp_min(count, 1.0)
    return loss / len(outputs)


def domain_classification_loss(outputs_class: Sequence[torch.Tensor], onehot):
    """Softmaxed class maps vs the one-hot label, MSE (not cross-entropy:
    quirk #9), averaged over the scales."""
    loss = 0.0
    for out in outputs_class:
        loss = loss + torch.mean((out.float() - onehot) ** 2)
    return loss / len(outputs_class)


def kl_loss(mu, logvar):
    """Conventional VAE KL, summed over batch and latent dims."""
    mu, logvar = mu.float(), logvar.float()
    return -0.5 * torch.sum(1.0 + logvar - mu ** 2 - torch.exp(logvar))


def batch_kl_loss(mu, n_batch: int):
    """Batch-distribution KL with the reference's double bias correction:
    the unbiased variance over the batch, times n_batch/(n_batch-1) again,
    with the *configured* batch size (quirk #12)."""
    mu = mu.float()
    var = torch.var(mu, dim=0, unbiased=True) * n_batch / (n_batch - 1)
    mean = torch.mean(mu, dim=0)
    return -0.5 * torch.sum(1.0 + torch.log(var) - mean ** 2 - var)


def corrcoef(x):
    """Differentiable ``np.corrcoef`` over rows: (dims, n) -> (dims, dims),
    clamped to [-1, 1]."""
    x = x.float()
    xm = x - x.mean(dim=1, keepdim=True)
    c = xm @ xm.T / (x.shape[1] - 1)
    stddev = torch.sqrt(torch.diagonal(c))
    c = c / stddev[None, :]
    c = c / stddev[:, None]
    return torch.clamp(c, -1.0, 1.0)


def corrcoef_loss(m):
    """``sum(|corrcoef(m) - I|) / (n(n-1))``; called on ``mu.T``."""
    n = m.shape[0]
    eye = torch.eye(n, dtype=torch.float32, device=m.device)
    return torch.sum(torch.abs(corrcoef(m) - eye)) / (n * (n - 1))


def histogram_target(generator: torch.Generator, bins: int = 50,
                     vmin: float = -10.0, vmax: float = 10.0,
                     sigma: float = 0.2, target_num: int = 100_000):
    """Normalised soft histogram of ``target_num`` N(0, 1) samples drawn
    from ``generator`` on its device (not bit-equal to the JAX package's
    draw; pass its target in to compare).  (bins,), sums to about 1."""
    samples = torch.randn((target_num,), generator=generator,
                          device=generator.device)
    h = gaussian_histogram(samples, bins, vmin, vmax, sigma)
    return h / h.sum() + 1e-8


def histogram_imitation_loss(mu, target, bins: int = 50, vmin: float = -10.0,
                             vmax: float = 10.0, sigma: float = 0.2,
                             use_kernel: Optional[bool] = None):
    """Sum over style dims of ``KL(target || softhist(mu[:, d]))``
    (``F.kl_div(input.log(), target, reduction="sum")``).  mu: (B, D);
    target: (bins,).  The per-dim histograms come from
    ``soft_histogram_cols`` (the kernels on CUDA, the plain twins on the
    CPU) unless ``use_kernel`` is False, which takes the plain composition
    with plain autograd on any device."""
    if use_kernel is False:
        hists = soft_histogram_cols_plain(mu, bins, vmin, vmax, sigma)
    else:
        hists = soft_histogram_cols(mu, bins, vmin, vmax, sigma)
    target = target.float()
    p = hists / hists.sum(dim=1, keepdim=True) + 1e-8
    return torch.sum(target[None, :] * (torch.log(target)[None, :]
                                        - torch.log(p)))


def diversification_loss(mu, logvar, *, weights, n_batch: int,
                         hist_target, use_kernel: Optional[bool] = None):
    """The gated encoder-restriction loss stack, with the reference's
    nesting of ``corr_enc`` and ``hist`` inside ``batch_KL > 0`` (quirk #2).

    ``use_kernel=None`` picks as the JAX package does: the fused kernel only
    when ``SRGAN_TPU_FUSED_DIV=1``, the tensors are on CUDA and the full
    proposed stack is on; otherwise the separate losses, whose soft
    histogram takes its kernel on CUDA.  True takes the fused path (and the
    histogram's ``Function``) on any device, False the plain composition.
    Returns (errE, metrics)."""
    if use_kernel is None:
        fused = (os.environ.get("SRGAN_TPU_FUSED_DIV") == "1"
                 and mu.device.type == "cuda")
        hist_kernel = None
    else:
        fused = hist_kernel = use_kernel
    errE = torch.zeros((), dtype=torch.float32, device=mu.device)
    metrics = {}
    if weights.KL > 0:
        v = kl_loss(mu, logvar)
        errE = errE + v * weights.KL
        metrics["loss_KL"] = v
    if (fused and weights.batch_KL > 0 and weights.corr_enc > 0
            and weights.hist > 0):
        from srgan_tpu_torch.ops.diversification import fused_diversification

        bkl, corr, hist = fused_diversification(mu, hist_target, n_batch)
        errE = errE + (bkl * weights.batch_KL + corr * weights.corr_enc
                       + hist * weights.hist)
        metrics.update(loss_batch_KL=bkl, loss_corr=corr, loss_hist=hist)
        return errE, metrics
    if weights.batch_KL > 0:
        v = batch_kl_loss(mu, n_batch)
        errE = errE + v * weights.batch_KL
        metrics["loss_batch_KL"] = v
        if weights.corr_enc > 0:
            v = corrcoef_loss(mu.T.float())
            errE = errE + v * weights.corr_enc
            metrics["loss_corr"] = v
        if weights.hist > 0:
            v = histogram_imitation_loss(mu, hist_target,
                                         use_kernel=hist_kernel)
            errE = errE + v * weights.hist
            metrics["loss_hist"] = v
    return errE, metrics
