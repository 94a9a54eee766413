"""The fused diversification loss: the CUDA kernel's wrapper and its plain
twin.

Counterpart of ``srgan_tpu/ops/pallas/diversification.py``.
``fused_diversification`` is a ``torch.autograd.Function``: on a CUDA tensor
its forward launches ``srgan_diversification_fwd``
(``csrc/diversification.cu``), or raises; on a CPU tensor it computes
``diversification_plain``; each launch counts one
``launch.diversification_fwd`` in ``utils/spans``.  Its backward is
autograd of ``diversification_plain`` on either device, as the TPU
version's is (``diversification.py:124-130``): a (B, 8) op that no kernel
would speed up.

The kernel is one launch of one thread-block cluster of ``plan(D)`` blocks,
a warp per work item: block r takes the columns d = r, r + K, ... (their
moments, batch-KL and diagonal terms, soft histograms and, after a block
barrier, histogram KL terms) and the unordered pairs u = r, r + K, ... of
distinct columns (their covariance and corr terms); rank 0 adds the
blocks' sums.  mu is read in place and the histogram rows go to a (D, bins)
workspace, so the kernel takes any B, D >= 2 and bins >= 1 whose B * D,
D * D and D * bins stay below 2^31, as the TPU kernel takes mu whole: no
size depends on shared memory.
"""

from __future__ import annotations

import ctypes

import torch

from srgan_tpu_torch.ops import histogram
from srgan_tpu_torch.ops import losses as L
from srgan_tpu_torch.utils import spans

# the most blocks in the kernel's cluster (csrc/diversification.cu checks
# every plan against the same constant)
MAX_CLUSTER = 8


def diversification_plain(mu, target, n_batch_cfg: int, bins: int = 50,
                          vmin: float = -10.0, vmax: float = 10.0,
                          sigma: float = 0.2):
    """[batch_kl, corr, hist], raw, from the plain losses, as
    ``srgan_tpu/ops/pallas/diversification.py::_reference_jnp`` stacks
    them."""
    return torch.stack([
        L.batch_kl_loss(mu, n_batch_cfg),
        L.corrcoef_loss(mu.T.float()),
        L.histogram_imitation_loss(mu, target, bins, vmin, vmax, sigma,
                                   use_kernel=False)])


def plan(D: int) -> int:
    """The kernel's cluster size K for mu (B, D): a block per column up to
    ``MAX_CLUSTER``.  Block r owns the columns d = r, r + K, ..."""
    return min(MAX_CLUSTER, D)


def diversification_fwd(mu, target, n_batch_cfg: int, bins: int = 50,
                        vmin: float = -10.0, vmax: float = 10.0,
                        sigma: float = 0.2):
    """The forward alone, no graph: the kernel on a CUDA mu, the plain twin
    on a CPU mu.  mu: (B, D), target: (bins,), both fp32 contiguous on one
    device -> (3,) fp32."""
    if mu.dim() != 2 or mu.dtype != torch.float32 or not mu.is_contiguous():
        raise ValueError(f"fused_diversification: mu must be a contiguous "
                         f"2-D float32 tensor, got {tuple(mu.shape)} "
                         f"{mu.dtype}")
    if (tuple(target.shape) != (bins,) or target.dtype != torch.float32
            or not target.is_contiguous() or target.device != mu.device):
        raise ValueError(f"fused_diversification: target must be a "
                         f"contiguous float32 ({bins},) on {mu.device}, got "
                         f"{tuple(target.shape)} on {target.device}")
    B, D = mu.shape
    if B < 2 or D < 2 or bins < 1:
        raise ValueError(f"fused_diversification needs B, D >= 2 and bins "
                         f">= 1, got {(B, D, bins)}")
    if max(B, D, bins) * D >= 2 ** 31:
        raise ValueError(f"fused_diversification: (B, D, bins) = "
                         f"{(B, D, bins)} overflows the kernel's int indexes")
    if mu.device.type == "cpu":
        return diversification_plain(mu, target, n_batch_cfg, bins, vmin,
                                     vmax, sigma)
    if mu.device.type != "cuda":
        raise ValueError(f"fused_diversification runs on cuda (kernel) or "
                         f"cpu (plain), not on {mu.device}")
    from srgan_tpu_torch.ops.build import load

    delta, norm = histogram._consts(bins, vmin, vmax, sigma)
    out = torch.empty((3,), dtype=torch.float32, device=mu.device)
    rows = torch.empty((D, bins), dtype=torch.float32, device=mu.device)
    with torch.cuda.device(mu.device):
        err = load("diversification").srgan_diversification_fwd(
            mu.data_ptr(), target.data_ptr(), out.data_ptr(),
            rows.data_ptr(), B, D, bins, plan(D),
            ctypes.c_float(n_batch_cfg), ctypes.c_float(vmin),
            ctypes.c_float(delta), ctypes.c_float(sigma),
            ctypes.c_float(norm),
            torch.cuda.current_stream(mu.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"diversification kernel launch failed: "
                           f"cudaError_t {err}")
    spans.count("launch.diversification_fwd")
    return out


class FusedDiversificationFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mu, target, n_batch_cfg, bins, vmin, vmax, sigma):
        ctx.save_for_backward(mu, target)
        ctx.args = (n_batch_cfg, bins, vmin, vmax, sigma)
        return diversification_fwd(mu, target, n_batch_cfg, bins, vmin,
                                   vmax, sigma)

    @staticmethod
    def backward(ctx, g):
        mu, target = ctx.saved_tensors
        with torch.enable_grad():
            m = mu.detach().requires_grad_(True)
            out = diversification_plain(m, target, *ctx.args)
            (dmu,) = torch.autograd.grad(out, m, g)
        return dmu, None, None, None, None, None, None


def fused_diversification(mu, target, n_batch_cfg: int, bins: int = 50,
                          vmin: float = -10.0, vmax: float = 10.0,
                          sigma: float = 0.2):
    """(B, D) mu + (bins,) target -> [batch_kl, corr, hist] (raw), fp32."""
    return FusedDiversificationFunction.apply(
        mu.float().contiguous(), target.float().contiguous(), n_batch_cfg,
        bins, vmin, vmax, sigma)
