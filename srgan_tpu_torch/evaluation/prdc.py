"""Precision / recall / density / coverage (counterpart of
``srgan_tpu/evaluation/prdc.py``): the algorithm of the ``prdc==0.2``
package (Naeem et al. 2020) that the reference calls in
``GAN_evaluation.get_prdc`` (evaluation.py:98-110), on the features' device:

  radii_X   = kth-NN distance within X: the (k+1)-th smallest of the row
              of self-distances, the self-distance 0 included
  precision = mean over fakes of  any_r [ d(r, f) < radii_real[r] ]
  recall    = mean over reals of  any_f [ d(r, f) < radii_fake[f] ]
  density   = (1/k) mean over fakes of  sum_r [ d(r, f) < radii_real[r] ]
  coverage  = mean over reals of  [ min_f d(r, f) < radii_real[r] ]

Distances are exact, sqrt(sum((x - y)^2)) in fp32, never the Gram identity:
duplicate points must be exactly 0 apart, since every comparison is a
strict ``<``.  ``torch.cdist`` takes the matrix-product form above 25 rows
unless told not to.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def pairwise_distances(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(N, D), (M, D) -> (N, M) Euclidean distances, fp32, by differences."""
    return torch.cdist(x.float(), y.float(),
                       compute_mode="donot_use_mm_for_euclid_dist")


def kth_nn_radii(feats: torch.Tensor, nearest_k: int) -> torch.Tensor:
    """The (k+1)-th smallest self-distance of each row, self included:
    prdc's ``get_kth_value(d, k=nearest_k + 1)``."""
    return pairwise_distances(feats, feats).kthvalue(nearest_k + 1,
                                                     dim=1).values


def compute_prdc(real_features, fake_features, nearest_k: int = 5,
                 device="cuda") -> Dict[str, float]:
    """The four metrics of (N, D) real against (M, D) fake features
    (numpy arrays or tensors), computed on ``device``."""
    real = torch.as_tensor(real_features, dtype=torch.float32,
                           device=device)
    fake = torch.as_tensor(fake_features, dtype=torch.float32,
                           device=device)
    for name, f in (("real", real), ("fake", fake)):
        if f.dim() != 2 or f.shape[0] <= nearest_k:
            raise ValueError(f"compute_prdc: {name} features of shape "
                             f"{tuple(f.shape)}: need (N, D) with N > "
                             f"nearest_k = {nearest_k}")
    radii_real = kth_nn_radii(real, nearest_k)
    radii_fake = kth_nn_radii(fake, nearest_k)
    d_rf = pairwise_distances(real, fake)
    hit = d_rf < radii_real[:, None]
    # the fractions in float64, as the prdc package computes them
    out = torch.stack([
        hit.any(dim=0).double().mean(),
        (d_rf < radii_fake[None, :]).any(dim=1).double().mean(),
        hit.double().sum(dim=0).mean() / nearest_k,
        (d_rf.min(dim=1).values < radii_real).double().mean()]).tolist()
    return dict(zip(("precision", "recall", "density", "coverage"), out))


def compute_prdc_numpy(real_features, fake_features,
                       nearest_k: int = 5) -> Dict[str, float]:
    """The reference algorithm in float64 numpy (a copy of
    ``srgan_tpu/evaluation/prdc.py:98-122``), for tests."""
    real = np.asarray(real_features, np.float64)
    fake = np.asarray(fake_features, np.float64)

    def dist(a, b):
        return np.sqrt(np.maximum(
            (a * a).sum(1)[:, None] + (b * b).sum(1)[None] - 2 * a @ b.T, 0))

    def radii(x):
        d = dist(x, x)
        part = np.partition(d, nearest_k, axis=1)[:, :nearest_k + 1]
        return part.max(axis=1)

    rr, rf = radii(real), radii(fake)
    d_rf = dist(real, fake)
    return {
        "precision": float((d_rf < rr[:, None]).any(axis=0).mean()),
        "recall": float((d_rf < rf[None, :]).any(axis=1).mean()),
        "density": float((d_rf < rr[:, None]).sum(axis=0).mean() / nearest_k),
        "coverage": float((d_rf.min(axis=1) < rr).mean()),
    }
