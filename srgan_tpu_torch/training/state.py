"""Training state of the three-network GAN (counterpart of
``srgan_tpu/training/state.py``).

Optimizers: torch ``Adam(betas=(b1, b2), eps=1e-8)`` equals the JAX
package's ``optax.scale_by_adam(b1, b2, eps=1e-8, eps_root=0)`` followed by
``p - lr * u`` (``state.py:25-34``); the learning rate is written into the
param groups before every step (``GANTrainer.lr_at``).  On one CUDA device
the optimizers are ``capturable``, for the step's CUDA graphs: the rate is
a tensor on the device that ``set_lr`` writes, the step counts live there
too, and the state dict keeps the plain form (``make_capturable``).

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


def adam(params: Iterable[torch.Tensor], b1: float, b2: float,
         capturable: bool = False) -> torch.optim.Adam:
    """Adam at lr 0; ``set_lr`` gives it the step's rate.  ``capturable``:
    made so by ``make_capturable`` (CUDA parameters)."""
    opt = torch.optim.Adam(params, lr=0.0, betas=(b1, b2), eps=1e-8)
    if capturable:
        make_capturable(opt)
    return opt


def set_lr(opt: torch.optim.Optimizer, lr: float):
    """``lr`` into every param group: into the group's rate tensor where it
    holds one (a capturable Adam, whose captured step reads it there),
    else as a float."""
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def make_capturable(opt: torch.optim.Adam):
    """``opt`` (an Adam on CUDA parameters) in the form a CUDA graph can
    capture, in place: ``capturable`` set, each group's rate a 0-dim
    float32 tensor on its parameters' device, each step count a float32
    tensor beside its parameter.  Its ``state_dict`` keeps the form a plain
    Adam writes (``plain_state_dict``), so a checkpoint loads anywhere; a
    state dict loaded back (which leaves the optimizer plain) needs this
    again.  Idempotent."""
    for group in opt.param_groups:
        dev = group["params"][0].device
        group["capturable"] = True
        lr = group["lr"]
        if isinstance(lr, torch.Tensor):
            group["lr"] = lr.to(dev, torch.float32)
        else:
            group["lr"] = torch.tensor(float(lr), dtype=torch.float32,
                                       device=dev)
        for p in group["params"]:
            st = opt.state.get(p)
            if st and "step" in st:
                st["step"] = st["step"].to(p.device, torch.float32)
    if not getattr(opt, "_plain_state_dict", False):
        opt.register_state_dict_post_hook(plain_state_dict)
        opt._plain_state_dict = True


def plain_state_dict(opt: torch.optim.Optimizer, sd: dict) -> dict:
    """A capturable Adam's state dict as a plain Adam writes it: each
    rate a float, ``capturable`` off, each step count a float32 tensor on
    the CPU; the optimizer's own state is left as it is."""
    for group in sd["param_groups"]:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"] = float(group["lr"])
        group["capturable"] = False
    sd["state"] = {i: {k: v.to("cpu", torch.float32) if k == "step" else v
                       for k, v in st.items()}
                   for i, st in sd["state"].items()}
    return sd


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
