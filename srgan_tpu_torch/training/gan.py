"""Model construction and the inference surface of the SRGAN trainer
(counterpart of ``srgan_tpu/training/gan.py:110-146, 218, 605-628``).

``transform`` and ``encode`` keep the JAX package's NHWC layout at their
boundary; the models inside run NCHW.  The train step comes with the
training slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from srgan_tpu_torch.configs import ExperimentConfig
from srgan_tpu_torch.nn.encoder import Encoder
from srgan_tpu_torch.nn.generator import SingleGenerator
from srgan_tpu_torch.nn.layers import init_torch_default_


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device on a machine without CUDA
    raises instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but CUDA is not "
                           "available here; pass device='cpu' to run on the "
                           "CPU")
    return dev


def _check_srgan(cfg: ExperimentConfig):
    if cfg.trainer != "srgan":
        raise NotImplementedError(
            f"trainer {cfg.trainer!r}: only the srgan trainer's models "
            "(SingleGenerator + unconditional Encoder) are ported")


def _materialise(module, device, generator: Optional[torch.Generator],
                 seed: int, state_dict):
    """The module was created on the meta device, with no draw.  Its params
    become ``state_dict``'s (strict) or, without one, are drawn on the CPU
    from ``generator`` (default: one seeded with ``seed``); then it moves
    to ``device``."""
    dev = resolve_device(device)
    if state_dict is not None:
        module.load_state_dict(state_dict, strict=True, assign=True)
    else:
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        init_torch_default_(module.to_empty(device="cpu"), generator)
    return module.to(dev).eval()


def build_generator(cfg: ExperimentConfig, device="cuda",
                    generator: Optional[torch.Generator] = None,
                    state_dict=None) -> SingleGenerator:
    """The generator of ``cfg`` holding ``state_dict`` (reference key
    layout) or, without one, torch-default init drawn from ``generator``
    (default: seeded with ``cfg.train.seed``)."""
    _check_srgan(cfg)
    m = cfg.model
    with torch.device("meta"):
        G = SingleGenerator(nch_in=m.nch_in, nch=m.g_nch, reduce=m.g_reduce,
                            num_cls=m.g_num_cls, res_num=m.g_res_num,
                            norm_type=m.norm_type, num_con=m.num_con)
    return _materialise(G, device, generator, cfg.train.seed, state_dict)


def build_encoder(cfg: ExperimentConfig, device="cuda",
                  generator: Optional[torch.Generator] = None,
                  state_dict=None) -> Encoder:
    """The unconditional encoder of ``cfg``, initialised as
    ``build_generator`` does."""
    _check_srgan(cfg)
    m = cfg.model
    if m.norm_type != "instance":
        raise NotImplementedError(
            f"norm_type {m.norm_type!r}: only instance norm is ported")
    with torch.device("meta"):
        E = Encoder(nch_in=m.nch_in, nch_out=m.ndim, nch=m.e_nch,
                    num_cls=m.e_num_cls, num_con=m.n_classes)
    return _materialise(E, device, generator, cfg.train.seed, state_dict)


def onehot(labels, n_classes: int) -> torch.Tensor:
    """Rows of ``eye(n_classes)``, fp32; a label out of range raises."""
    return F.one_hot(torch.as_tensor(labels).long(), n_classes).float()


@torch.inference_mode()
def transform(G: SingleGenerator, images: torch.Tensor, target_labels,
              latent: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """G_transformation: images (N, H, W, C) in [-1, 1] on G's device,
    target labels (N,), latent (N, ndim) or (ndim,), one style for the whole
    batch.  Returns (fakes (N, H, W, C) fp32, latent (N, ndim))."""
    n = images.shape[0]
    latent = latent.float()
    if latent.dim() == 1:
        latent = latent.expand(n, latent.shape[0])
    cond = torch.cat([onehot(target_labels, G.num_con - latent.shape[1])
                      .to(images.device), latent], dim=1)
    x = images.permute(0, 3, 1, 2).contiguous()
    fake = G(x, cond)
    return fake.permute(0, 2, 3, 1).contiguous(), latent


@torch.inference_mode()
def encode(E: Encoder, images: torch.Tensor):
    """Encoder forward on (N, H, W, C) images: (mu, logvar, class_out)."""
    return E(images.permute(0, 3, 1, 2).contiguous())
