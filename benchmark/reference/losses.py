"""The plain reference of SRGAN's losses (the notebooks' util.py and
util_notebook.py), fp32, plain PyTorch."""

from __future__ import annotations

import math

import torch


def l1(a, b):
    return torch.mean(torch.abs(a - b))


def lsgan(outputs, target: float):
    """Mean squared error against a constant, per scale, then the mean over
    the scales."""
    return sum(torch.mean((o - target) ** 2) for o in outputs) / len(outputs)


def masked_lsgan(outputs, target: float, mask):
    """``lsgan`` over the samples where ``mask`` holds; 0 where none does."""
    total = 0.0
    for o in outputs:
        m = mask.reshape((-1,) + (1,) * (o.dim() - 1)).float()
        count = m.sum() * (o.numel() // o.shape[0])
        total = total + ((o - target) ** 2 * m).sum() / count.clamp_min(1.0)
    return total / len(outputs)


def domain_classification(outputs, onehot):
    """Softmaxed class maps against the one-hot label, mean squared error,
    averaged over the scales."""
    return sum(torch.mean((o - onehot) ** 2) for o in outputs) / len(outputs)


def batch_kl(mu, n_batch: int):
    """KL of the batch's per-dimension Gaussian from N(0, 1), with the
    unbiased variance scaled by n / (n - 1) once more (the notebooks')."""
    var = torch.var(mu, dim=0, unbiased=True) * n_batch / (n_batch - 1)
    mean = torch.mean(mu, dim=0)
    return -0.5 * torch.sum(1.0 + torch.log(var) - mean ** 2 - var)


def corrcoef_loss(m):
    """sum |corrcoef(m) - I| / (n (n - 1)) over the rows of m (dims, batch),
    the coefficients clamped to [-1, 1]."""
    n = m.shape[0]
    xm = m - m.mean(dim=1, keepdim=True)
    c = xm @ xm.T / (m.shape[1] - 1)
    sd = torch.sqrt(torch.diagonal(c))
    c = torch.clamp(c / sd[None, :] / sd[:, None], -1.0, 1.0)
    eye = torch.eye(n, dtype=m.dtype, device=m.device)
    return torch.sum(torch.abs(c - eye)) / (n * (n - 1))


def soft_histogram(x, bins: int = 50, vmin: float = -10.0, vmax: float = 10.0,
                   sigma: float = 0.2):
    """Gaussian kernel density at the bin centres times the bin width:
    (n,) -> (bins,)."""
    delta = (vmax - vmin) / bins
    centers = vmin + delta * (torch.arange(bins, dtype=x.dtype,
                                           device=x.device) + 0.5)
    z = (x[None, :] - centers[:, None]) / sigma
    return (torch.exp(-0.5 * z ** 2) / (sigma * math.sqrt(2 * math.pi))
            * delta).sum(dim=1)


def histogram_target(generator: torch.Generator, device, n: int = 100_000):
    """The imitation target: the normalised soft histogram of ``n``
    standard-normal draws, plus 1e-8."""
    h = soft_histogram(torch.randn((n,), generator=generator, device=device))
    return h / h.sum() + 1e-8


def histogram_imitation(mu, target):
    """sum over the style dimensions of KL(target || softhist(mu[:, d]))."""
    total = 0.0
    for d in range(mu.shape[1]):
        h = soft_histogram(mu[:, d])
        p = h / h.sum() + 1e-8
        total = total + torch.sum(target * (torch.log(target) - torch.log(p)))
    return total


def diversification(mu, weights: dict, n_batch: int, hist_target):
    """The proposed restriction: batch KL, and inside it the correlation
    and histogram terms.  Returns (errE, terms)."""
    if weights["KL"] > 0:
        raise NotImplementedError("the reference has the proposed stack only")
    errE = torch.zeros((), device=mu.device)
    terms = {}
    if weights["batch_KL"] > 0:
        terms["loss_batch_KL"] = batch_kl(mu, n_batch)
        errE = errE + weights["batch_KL"] * terms["loss_batch_KL"]
        if weights["corr_enc"] > 0:
            terms["loss_corr"] = corrcoef_loss(mu.T)
            errE = errE + weights["corr_enc"] * terms["loss_corr"]
        if weights["hist"] > 0:
            terms["loss_hist"] = histogram_imitation(mu, hist_target)
            errE = errE + weights["hist"] * terms["loss_hist"]
    return errE, terms
