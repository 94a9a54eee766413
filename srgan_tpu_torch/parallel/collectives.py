"""The batch-global losses over the data-parallel group (counterpart of
``srgan_tpu/parallel/collectives.py``): the same functions, each taking the
rank's rows and the ``Mesh`` where the JAX ones take a ``shard_map`` axis,
with the same values on every rank.

Each sums its moments or counts with ``all_reduce_sum``, an autograd
``Function`` whose backward all-reduces (SUM) the gradient, as the
transpose of JAX's ``psum`` does.  On rank r the gradient of a global loss
so carries a factor of the group's size; the trainer's gradient mean (one
all-reduce divided by the size) cancels it, as ``pmean`` does in the JAX
manual recipe (``srgan_tpu/training/gan.py:246-252``).  Only ``all_reduce``
is used (gloo runs it on CUDA tensors too; it has no ``all_gather`` or
``reduce_scatter`` for them).

Reference semantics made global: batch-KL (util_notebook.py:314-320),
corrcoef over the global batch (util.py:470-517), soft-histogram counts
over the global batch (util.py:521-553), the per-domain masked LSGAN
(util_notebook.py:230-245).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from srgan_tpu_torch.ops import losses as L


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x; dx = sum over ranks of dy."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(dx, op=dist.ReduceOp.SUM)
        return dx


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``mesh`` (the default process
    group), differentiable: the backward all-reduces the gradient
    (``psum``'s transpose)."""
    return _AllReduceSum.apply(x)


def global_batch_kl(mu_local, n_batch_cfg: int, mesh):
    """Batch-KL with moments summed over the ranks
    (``srgan_tpu/parallel/collectives.py:22-36``): the unbiased variance
    over the global batch, times n_cfg / (n_cfg - 1) again (the
    reference's double bias correction)."""
    mu = mu_local.float()
    d = mu.shape[1]
    n = float(mu.shape[0] * mesh.size)
    s = all_reduce_sum(torch.cat([mu.sum(0), (mu * mu).sum(0)]), mesh)
    mean = s[:d] / n
    var_biased = s[d:] / n - mean ** 2
    var = var_biased * n / (n - 1) * n_batch_cfg / (n_batch_cfg - 1)
    return -0.5 * torch.sum(1.0 + torch.log(var) - mean ** 2 - var)


def global_corrcoef_loss(mu_local, mesh):
    """``corrcoef_loss(mu_global.T)`` from summed first and second moments
    (``srgan_tpu/parallel/collectives.py:39-50``)."""
    mu = mu_local.float()
    d = mu.shape[1]
    n = float(mu.shape[0] * mesh.size)
    s = all_reduce_sum(torch.cat([mu.sum(0), (mu.T @ mu).reshape(-1)]),
                       mesh)
    mean = s[:d] / n
    cov = (s[d:].reshape(d, d) - n * torch.outer(mean, mean)) / (n - 1)
    std = torch.sqrt(torch.diagonal(cov))
    corr = torch.clamp(cov / std[None, :] / std[:, None], -1.0, 1.0)
    eye = torch.eye(d, dtype=torch.float32, device=mu.device)
    return torch.sum(torch.abs(corr - eye)) / (d * (d - 1))


def global_kl_loss(mu_local, logvar_local, mesh):
    """The conventional VAE KL summed over the ranks: the reference sums
    over batch and dims, so the global value is the sum of the ranks' sums
    (``srgan_tpu/parallel/collectives.py:53-64``)."""
    return all_reduce_sum(L.kl_loss(mu_local, logvar_local).reshape(1),
                          mesh)[0]


def global_masked_lsgan_loss(outputs, target: float, mask, mesh):
    """``masked_lsgan_loss`` over the global batch: each scale's masked sum
    and mask count summed over the ranks before the divide
    (``srgan_tpu/parallel/collectives.py:67-78``), all scales in one
    all-reduce."""
    parts = []
    for out in outputs:
        out = out.float()
        m = mask.reshape((-1,) + (1,) * (out.dim() - 1)).float()
        parts.append(((out - target) ** 2 * m).sum())
        parts.append(m.sum() * (out.numel() // out.shape[0]))
    s = all_reduce_sum(torch.stack(parts), mesh)
    loss = 0.0
    for i in range(len(outputs)):
        loss = loss + s[2 * i] / torch.clamp_min(s[2 * i + 1], 1.0)
    return loss / len(outputs)


def global_histogram_imitation(mu_local, target, mesh, bins: int = 50,
                               vmin: float = -10.0, vmax: float = 10.0,
                               sigma: float = 0.2):
    """Histogram imitation with the per-bin counts summed over the ranks
    (``srgan_tpu/parallel/collectives.py:106-120``).  Each rank's raw
    (dims, bins) counts come from ``soft_histogram_cols``: the CUDA
    kernels on the card, the plain twins on the CPU."""
    hist = all_reduce_sum(
        L.soft_histogram_cols(mu_local, bins, vmin, vmax, sigma), mesh)
    target = target.float()
    p = hist / hist.sum(dim=1, keepdim=True) + 1e-8
    return torch.sum(target[None, :] * (torch.log(target)[None, :]
                                        - torch.log(p)))


def global_diversification_loss(mu, logvar, *, weights, n_batch: int,
                                hist_target, mesh):
    """``ops.losses.diversification_loss`` with every batch-global statistic
    summed over the ranks: the same gating (corr and hist inside
    batch_KL > 0, quirk #2) and return contract (errE, metrics), the same
    values on every rank (``srgan_tpu/parallel/collectives.py:81-103``).
    The fused kernel is a single-device path and is never taken here."""
    errE = torch.zeros((), dtype=torch.float32, device=mu.device)
    metrics = {}
    if weights.KL > 0:
        v = global_kl_loss(mu, logvar, mesh)
        errE = errE + v * weights.KL
        metrics["loss_KL"] = v
    if weights.batch_KL > 0:
        v = global_batch_kl(mu, n_batch, mesh)
        errE = errE + v * weights.batch_KL
        metrics["loss_batch_KL"] = v
        if weights.corr_enc > 0:
            v = global_corrcoef_loss(mu, mesh)
            errE = errE + v * weights.corr_enc
            metrics["loss_corr"] = v
        if weights.hist > 0:
            v = global_histogram_imitation(mu, hist_target, mesh)
            errE = errE + v * weights.hist
            metrics["loss_hist"] = v
    return errE, metrics
