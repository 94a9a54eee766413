"""VGG19-BN fine-tune on the 4 CelebA classes, the missing notebook B's job
(counterpart of ``srgan_tpu/training/vgg_finetune.py``).

The reference ships its product as
``facial_recognizer_vgg_lr5e-05_epoch126.pth`` (evaluation.py:58): VGG19-BN
with ``classifier[6]`` a 4-way Linear (evaluation.py:56), fine-tuned at lr
5e-5.  Here: Adam(5e-5) (optax's ``adam`` defaults: betas 0.9 / 0.999, eps
1e-8), cross-entropy of the logits, batch norm in training mode with flax's
running statistics (``evaluation/features.py::BatchNorm2d``), no dropout.
The result is the "vgg-CelebA" PRDC feature extractor.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from srgan_tpu_torch.evaluation.features import (
    VGG19BN,
    init_vgg,
    load_vgg,
    preprocess_for_vgg,
)
from srgan_tpu_torch.ops.image import nchw_on
from srgan_tpu_torch.training.gan import resolve_device


@dataclasses.dataclass
class VGGFinetuneState:
    """The net and its optimizer, updated in place by ``step``."""

    model: VGG19BN
    opt: torch.optim.Adam
    step: int = 0


class VGGFinetuneTrainer:
    def __init__(self, n_classes: int = 4, lr: float = 5e-5, device="cuda"):
        self.n_classes = n_classes
        self.lr = lr
        self.device = resolve_device(device)

    def init_state(self, generator: Optional[torch.Generator] = None,
                   state_dict=None) -> VGGFinetuneState:
        """The net holding ``state_dict`` (torchvision layout, an
        ``n_classes``-way head) or torchvision's init drawn from
        ``generator`` (default: seeded with 0)."""
        if state_dict is None:
            model = init_vgg(generator or torch.Generator().manual_seed(0),
                             self.n_classes)
        else:
            model = load_vgg({k: torch.as_tensor(v).clone()
                              for k, v in state_dict.items()},
                             self.n_classes)
        model = model.to(self.device)
        opt = torch.optim.Adam(model.parameters(), lr=self.lr,
                               betas=(0.9, 0.999), eps=1e-8)
        return VGGFinetuneState(model=model, opt=opt)

    def step(self, state: VGGFinetuneState, images, labels,
             preprocessed: bool = False) -> Dict[str, torch.Tensor]:
        """One Adam step.  ``images``: (B, 128, 128, 3) in [-1, 1], or
        (B, 224, 224, 3) normalised with ``preprocessed``.  Returns loss and
        accuracy, 0-dim fp32 tensors on the device."""
        if not preprocessed:
            images = preprocess_for_vgg(np.asarray(images))
        labels = torch.as_tensor(labels, device=self.device).long()
        state.model.train()
        logits = state.model(nchw_on(images, self.device), output="score")
        loss = F.cross_entropy(logits, labels)
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        state.opt.step()
        state.model.eval()
        state.step += 1
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        return {"loss": loss.detach(), "accuracy": acc}

    def evaluate(self, state: VGGFinetuneState, batches) -> float:
        """Accuracy over an iterable of ((B, 128, 128, 3) images, labels),
        batch norm on its running statistics."""
        accs, ns = [], []
        state.model.eval()
        for images, labels in batches:
            x = nchw_on(preprocess_for_vgg(np.asarray(images)), self.device)
            with torch.inference_mode():
                preds = state.model(x, output="score").argmax(-1).cpu()
            accs.append(float((preds.numpy() == np.asarray(labels)).mean()))
            ns.append(len(labels))
        return float(np.average(accs, weights=ns))
