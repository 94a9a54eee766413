"""Training state of the three-network GAN (counterpart of
``srgan_tpu/training/state.py``).

Optimizers: torch ``Adam(betas=(b1, b2), eps=1e-8)`` equals the JAX
package's ``optax.scale_by_adam(b1, b2, eps=1e-8, eps_root=0)`` followed by
``p - lr * u`` (``state.py:25-34``); the learning rate is written into the
param groups before every step (``GANTrainer.lr_at``).

Encoder freeze: the JAX package masks the frozen leaves' gradients to zero
(``freeze_mask`` / ``mask_grads``, ``state.py:37-55``), so their Adam
moments stay 0 and they never move.  Here the frozen trunk has
``requires_grad=False`` and the encoder's optimizer holds only
``fcmean`` / ``fcvar``: the same parameters after every step, with no
gradient computed for the trunk.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional

import torch
from torch import nn

TRAINABLE_WHEN_FROZEN = ("fcmean", "fcvar")


def adam(params: Iterable[torch.Tensor], b1: float, b2: float
         ) -> torch.optim.Adam:
    """Adam at lr 0; ``set_lr`` gives it the step's rate."""
    return torch.optim.Adam(params, lr=0.0, betas=(b1, b2), eps=1e-8)


def set_lr(opt: torch.optim.Optimizer, lr: float):
    for group in opt.param_groups:
        group["lr"] = lr


def freeze_encoder_trunk(E: nn.Module) -> List[torch.Tensor]:
    """Turn off ``requires_grad`` on every encoder parameter outside
    ``fcmean`` / ``fcvar``; returns those two heads' parameters, in
    ``E.named_parameters()`` order."""
    keep = []
    for name, p in E.named_parameters():
        on = name.split(".", 1)[0] in TRAINABLE_WHEN_FROZEN
        p.requires_grad_(on)
        if on:
            keep.append(p)
    return keep


@dataclasses.dataclass
class GANTrainState:
    """The three nets, their optimizers and the histogram target.  The nets
    and optimizers are updated in place by ``GANTrainer.step``."""

    G: nn.Module
    D: nn.Module
    E: nn.Module
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam
    opt_e: torch.optim.Adam
    hist_target: Optional[torch.Tensor] = None
    step: int = 0
