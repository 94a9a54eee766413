"""Encoder-classifier pretraining, the notebook-04 job (counterpart of
``srgan_tpu/training/classifier.py``).

The reference trains ``Encoder_classifier`` (4-way) with CrossEntropyLoss,
Adam(lr 1e-4, betas 0.9 / 0.999), ExponentialLR(0.99) stepped per epoch,
batch 512, validating every 3 epochs and keeping the best-accuracy
parameters (nb04 cells 15/18/20/22).

Replicated quirk: the model outputs softmax probabilities and the loss is
CrossEntropyLoss of them, i.e. log_softmax on top of softmax
(model.py:507-508 + nb04 cell 18); accuracy is the argmax of the
probabilities.  ``F.cross_entropy(probs, labels)`` is that composition.

Images enter NHWC in [-1, 1], as the data feed gives them; the model runs
NCHW on the trainer's device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from srgan_tpu_torch.configs import ClassifierConfig
from srgan_tpu_torch.nn.encoder import EncoderClassifier
from srgan_tpu_torch.nn.layers import init_torch_default_
from srgan_tpu_torch.ops.image import nchw_on
from srgan_tpu_torch.training.gan import resolve_device
from srgan_tpu_torch.training.state import adam, set_lr


@dataclasses.dataclass
class ClassifierState:
    """The model and its optimizer, updated in place by
    ``ClassifierTrainer.step``."""

    model: EncoderClassifier
    opt: torch.optim.Adam
    step: int = 0


class ClassifierTrainer:
    def __init__(self, cfg: ClassifierConfig, device="cuda"):
        if cfg.model.norm_type != "instance":
            raise NotImplementedError(
                f"norm_type {cfg.model.norm_type!r}: only instance norm is "
                "ported")
        self.cfg = cfg
        self.device = resolve_device(device)

    def init_state(self, generator: Optional[torch.Generator] = None,
                   state_dict=None) -> ClassifierState:
        """The classifier holding ``state_dict`` (``Encoder_classifier``
        layout, strict) or, without one, torch-default init drawn on the
        CPU from ``generator`` (default: seeded with ``cfg.seed``); Adam
        with the reference's betas."""
        m = self.cfg.model
        with torch.device("meta"):
            model = EncoderClassifier(nch_in=m.nch_in, nch=m.e_nch,
                                      num_cls=m.e_num_cls,
                                      num_con=m.n_classes)
        if state_dict is not None:
            model.load_state_dict({k: torch.as_tensor(v).clone()
                                   for k, v in state_dict.items()},
                                  strict=True, assign=True)
        else:
            if generator is None:
                generator = torch.Generator().manual_seed(self.cfg.seed)
            init_torch_default_(model.to_empty(device="cpu"), generator)
        model = model.to(self.device)
        return ClassifierState(model=model,
                               opt=adam(model.parameters(), 0.9, 0.999))

    def lr_at(self, epoch: int) -> float:
        return self.cfg.lr * self.cfg.lr_gamma ** epoch

    def step(self, state: ClassifierState, images, labels, epoch: int = 0
             ) -> Dict[str, torch.Tensor]:
        """One Adam step on (B, H, W, C) images and (B,) labels at epoch
        ``epoch``'s rate.  Returns loss and accuracy, 0-dim fp32 tensors on
        the device."""
        labels = torch.as_tensor(labels, device=self.device).long()
        set_lr(state.opt, self.lr_at(epoch))
        probs = state.model(nchw_on(images, self.device))
        loss = F.cross_entropy(probs, labels)
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        state.opt.step()
        state.step += 1
        acc = (probs.detach().argmax(-1) == labels).float().mean()
        return {"loss": loss.detach(), "accuracy": acc}

    @torch.inference_mode()
    def predict(self, state: ClassifierState, images) -> torch.Tensor:
        """Argmax class of each (B, H, W, C) image, on the device."""
        return state.model(nchw_on(images, self.device)).argmax(-1)

    def evaluate(self, state: ClassifierState, batches
                 ) -> Tuple[np.ndarray, np.ndarray, float]:
        """A sweep over an iterable of (images, labels): (labels, preds,
        accuracy), the nb04 ``do_test``."""
        all_preds, all_labels = [], []
        for images, labels in batches:
            all_preds.append(self.predict(state, images).cpu().numpy())
            all_labels.append(np.asarray(labels))
        preds = np.concatenate(all_preds)
        labels = np.concatenate(all_labels)
        return labels, preds, float((preds == labels).mean())

    def fit(self, state: ClassifierState, train_iter_fn, val_iter_fn=None,
            epochs: Optional[int] = None, log_fn=None):
        """The epoch loop (nb04 cell 22): validate every ``test_interval``
        epochs from epoch 0, logging the last step's metrics beside
        ``val_accuracy``, and keep a CPU copy of the parameters with the
        best accuracy (strictly better than the best so far).  Returns
        (state, best state dict or None, best accuracy or -1)."""
        best_acc, best = -1.0, None
        epochs = epochs if epochs is not None else self.cfg.epochs
        for epoch in range(epochs):
            for images, labels in train_iter_fn():
                metrics = self.step(state, images, labels, epoch)
            if val_iter_fn is not None and epoch % self.cfg.test_interval == 0:
                _, _, acc = self.evaluate(state, val_iter_fn())
                if log_fn:
                    log_fn({"epoch": epoch, "val_accuracy": acc,
                            **{k: float(v) for k, v in metrics.items()}})
                if acc > best_acc:
                    # state_dict() holds the live tensors: copy them
                    best_acc, best = acc, {
                        k: v.detach().to("cpu", copy=True)
                        for k, v in state.model.state_dict().items()}
        return state, best, best_acc
