"""The SRGAN trainer of the port: model construction, the train step and
the inference surface (counterpart of ``srgan_tpu/training/gan.py``, the
``srgan`` variant: solo discriminator, unconditional encoder, one device,
instance norm).

``transform`` and ``encode`` and the train step's batch keep the JAX
package's NHWC layout at their boundary; the models inside run NCHW.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from srgan_tpu_torch.configs import ExperimentConfig
from srgan_tpu_torch.nn.discriminator import SingleDiscriminatorSoloMulti
from srgan_tpu_torch.nn.encoder import Encoder
from srgan_tpu_torch.nn.generator import SingleGenerator
from srgan_tpu_torch.nn.layers import init_torch_default_
from srgan_tpu_torch.ops import losses as L
from srgan_tpu_torch.training.state import (
    GANTrainState,
    adam,
    freeze_encoder_trunk,
    set_lr,
)


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


def build_discriminator(cfg: ExperimentConfig, device="cuda",
                        generator: Optional[torch.Generator] = None,
                        state_dict=None) -> SingleDiscriminatorSoloMulti:
    """The solo discriminator of ``cfg``, its class heads sized to the
    trunks' output maps (``srgan_tpu/training/gan.py:121-126``),
    initialised as ``build_generator`` does."""
    _check_srgan(cfg)
    m = cfg.model
    k1 = m.image_size // (2 ** m.d_num_cls)
    with torch.device("meta"):
        D = SingleDiscriminatorSoloMulti(
            nch_in=m.nch_in, nch=m.d_nch, reduce=m.d_reduce,
            num_cls=m.d_num_cls, n_class=m.n_classes,
            cls_kernels=(k1, k1 // 2))
    return _materialise(D, device, generator, cfg.train.seed, state_dict)


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


def _g_pair(G, x1, c1, x2, c2):
    """Two generator applications as one 2B forward (every op is per
    sample, so this is exact; ``srgan_tpu/training/gan.py:221-230``)."""
    b = x1.shape[0]
    out = G(torch.cat([x1, x2], 0), torch.cat([c1, c2], 0))
    return out[:b], out[b:]


def _apply_grads(loss, *opts: torch.optim.Optimizer):
    """One gradient of ``loss`` with respect to every parameter the
    optimizers hold (an unused one gets zeros, as ``jax.grad`` gives), then
    one step of each.  Only those parameters get a gradient."""
    params = [p for opt in opts for group in opt.param_groups
              for p in group["params"]]
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    for opt in opts:
        opt.step()
        opt.zero_grad(set_to_none=True)


class GANTrainer:
    """The ``srgan`` train step of ``srgan_tpu/training/gan.py:235-511`` on
    one device: ``k - 1`` unrolled D updates, then phase 1 (the k-th D
    update and one joint G/E gradient of errG + errE), then phase 2 (a G
    step on the style regression, with fresh forwards at the phase-1
    parameters).

    Every standard-normal draw of the step (the k latents, with
    ``encoded_feature="mu"``) goes through ``_draw_latent``, in the JAX
    step's order, from ``self.rng``; tests override the seam to inject the
    JAX side's draws.  ``compute_dtype="bfloat16"`` runs the
    forwards under ``torch.autocast``, as serving does; the losses are fp32.
    """

    def __init__(self, cfg: ExperimentConfig, device="cuda"):
        _check_srgan(cfg)
        if cfg.model.norm_type != "instance":
            raise NotImplementedError(
                f"norm_type {cfg.model.norm_type!r}: only instance norm is "
                "ported")
        if cfg.train.unrolled_restore:
            raise NotImplementedError("unrolled_restore=True is not ported; "
                                      "D keeps all k updates")
        if cfg.train.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {cfg.train.compute_dtype!r}: "
                             "float32 or bfloat16")
        if cfg.train.encoded_feature != "mu":
            raise NotImplementedError(
                f"encoded_feature {cfg.train.encoded_feature!r}: only 'mu' "
                "(the srgan presets' setting) is ported")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.bf16 = cfg.train.compute_dtype == "bfloat16"
        self.rng = torch.Generator(device=self.device).manual_seed(
            cfg.train.seed + 1)

    # ------------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None,
                   g_state=None, d_state=None, e_state=None,
                   hist_target: Optional[torch.Tensor] = None,
                   freeze_pretrained: bool = False) -> GANTrainState:
        """G, D and E hold the given state dicts (reference key layout, as
        the converters of ``utils/checkpoint.py`` make them from JAX
        parameter trees) or, where one is None, torch-default init drawn in
        the order G, D, E from ``generator`` (default: one seeded with
        ``cfg.train.seed``).  ``hist_target`` (bins,) is the imitation
        target; without one it is drawn from ``generator`` when the
        histogram loss is on.  ``freeze_pretrained`` trains only
        ``fcmean`` / ``fcvar`` of E."""
        cfg = self.cfg
        t = cfg.train
        if generator is None:
            generator = torch.Generator().manual_seed(t.seed)

        def own(sd):
            # the step updates parameters in place: never the caller's
            return None if sd is None else {
                k: torch.as_tensor(v).clone() for k, v in sd.items()}

        G = build_generator(cfg, self.device, generator, own(g_state))
        D = build_discriminator(cfg, self.device, generator, own(d_state))
        E = build_encoder(cfg, self.device, generator, own(e_state))
        if freeze_pretrained:
            e_params = freeze_encoder_trunk(E)
        else:
            e_params = list(E.parameters())
        if cfg.loss.batch_KL > 0 and cfg.loss.hist > 0:
            if hist_target is None:
                hist_target = L.histogram_target(generator)
            hist_target = (hist_target.detach().clone()
                           if isinstance(hist_target, torch.Tensor)
                           else torch.tensor(hist_target)).to(
                self.device, torch.float32)
        else:
            hist_target = None
        return GANTrainState(
            G=G, D=D, E=E,
            opt_g=adam(G.parameters(), t.adam_b1, t.adam_b2),
            opt_d=adam(D.parameters(), t.adam_b1, t.adam_b2),
            opt_e=adam(e_params, t.adam_b1, t.adam_b2),
            hist_target=hist_target)

    def lr_at(self, epoch: int) -> Tuple[float, float, float]:
        """ExponentialLR(gamma) stepped per epoch
        (``srgan_tpu/training/gan.py:590-594``)."""
        t = self.cfg.train
        g = t.lr_gamma ** epoch
        return t.lr_g * g, t.lr_d * g, t.lr_e * g

    def _draw_latent(self, shape) -> torch.Tensor:
        """The seam of every standard-normal draw inside the step."""
        return torch.randn(shape, generator=self.rng, device=self.device)

    def _autocast(self):
        if not self.bf16:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=torch.bfloat16)

    # ------------------------------------------------------------------
    def _d_update(self, st: GANTrainState, images, fake, onehot_src):
        """One D step on real + detached fake as one 2B forward; returns
        errD (``srgan_tpu/training/gan.py:289-303``)."""
        lw = self.cfg.loss
        B = images.shape[0]
        with self._autocast():
            adv, cls = st.D(torch.cat([images, fake.detach()], 0))
        errD = L.lsgan_loss([a[:B] for a in adv], 1.0)
        if lw.cls > 0:
            errD = errD + lw.cls * L.domain_classification_loss(
                [c[:B] for c in cls], onehot_src)
        errD = errD + L.lsgan_loss([a[B:] for a in adv], 0.0)
        _apply_grads(errD, st.opt_d)
        return errD.detach()

    def step(self, state: GANTrainState, batch: Dict[str, Any],
             epoch: int = 0) -> Dict[str, torch.Tensor]:
        """One training iteration on ``batch`` ({"image": (B, H, W, C) in
        [-1, 1], "source_label": (B,), "target_label": (B,)}).  Updates
        ``state`` in place; returns the metrics as 0-dim fp32 tensors on
        the device (errD, errG, errE, errG_ex and the loss_* terms)."""
        cfg, lw = self.cfg, self.cfg.loss
        k, ndim = cfg.train.unrolled_k, cfg.model.ndim
        n_classes = cfg.model.n_classes
        G, D, E = state.G, state.D, state.E
        lr_g, lr_d, lr_e = self.lr_at(epoch)
        set_lr(state.opt_g, lr_g)
        set_lr(state.opt_d, lr_d)
        set_lr(state.opt_e, lr_e)

        images = torch.as_tensor(batch["image"], dtype=torch.float32,
                                 device=self.device).permute(0, 3, 1, 2) \
            .contiguous()
        onehot_src = onehot(batch["source_label"], n_classes).to(self.device)
        onehot_tgt = onehot(batch["target_label"], n_classes).to(self.device)
        B = images.shape[0]

        # ---- k - 1 unrolled D updates, each with a fresh latent
        errD0 = None
        for i in range(k - 1):
            latent = self._draw_latent((B, ndim))
            with torch.no_grad(), self._autocast():
                fake = G(images, torch.cat([onehot_tgt, latent], 1))
            errD = self._d_update(state, images, fake, onehot_src)
            if i == 0:
                errD0 = errD

        # ---- phase 1: the k-th fake, computed once: its detached value
        # drives the k-th D update and its graph serves the G/E gradient
        latent = self._draw_latent((B, ndim))
        cond_fake = torch.cat([onehot_tgt, latent], 1)
        with self._autocast():
            fake = G(images, cond_fake)
        errD_last = self._d_update(state, images, fake, onehot_src)
        if errD0 is None:
            errD0 = errD_last

        metrics: Dict[str, torch.Tensor] = {}
        with self._autocast():
            # encoded_feature "mu": the style code is mu itself, no draw
            mu, logvar, _ = E(images)
            style = torch.cat([onehot_src, mu], 1)
            if lw.idt > 0:
                recon, idt_img = _g_pair(G, fake, style, images, style)
            else:
                recon = G(fake, style)
            # D at its post-k-update parameters; only the G/E parameters
            # get a gradient (``_apply_grads``)
            adv, cls_out = D(fake)
        errG = L.lsgan_loss(adv, 1.0)
        if lw.cls > 0:
            errG = errG + lw.cls * L.domain_classification_loss(cls_out,
                                                                onehot_tgt)
        err_cycle = L.l1_loss(images, recon)
        errG = errG + lw.cycle * err_cycle
        metrics["loss_cycle"] = err_cycle
        errE_out = lw.cycle * err_cycle
        if lw.idt > 0:
            err_idt = L.l1_loss(images, idt_img)
            errG = errG + lw.idt * err_idt
            errE_out = errE_out + lw.idt * err_idt
            metrics["loss_idt"] = err_idt
        errE, div_metrics = L.diversification_loss(
            mu, logvar, weights=lw, n_batch=cfg.train.batch_size,
            hist_target=state.hist_target)
        metrics.update(div_metrics)
        errE_out = errE_out + errE
        _apply_grads(errG + errE, state.opt_g, state.opt_e)

        # ---- phase 2: G alone on the style regression, fresh forwards at
        # the phase-1-updated parameters
        with self._autocast():
            if lw.idt_reg * lw.idt > 0:
                with torch.no_grad():
                    mu_s = E(images)[0]
                fake2, idt2 = _g_pair(G, images, cond_fake, images,
                                      torch.cat([onehot_src, mu_s], 1))
                mu_both = E(torch.cat([fake2, idt2], 0))[0]
                errG_ex = lw.reg * L.l1_loss(latent, mu_both[:B]) \
                    + L.l1_loss(mu_s, mu_both[B:]) * lw.idt_reg \
                    * (lw.idt / lw.cycle)
            else:
                mu_t = E(G(images, cond_fake))[0]
                errG_ex = lw.reg * L.l1_loss(latent, mu_t)
        _apply_grads(errG_ex, state.opt_g)
        state.step += 1

        metrics = {key: v.detach() for key, v in metrics.items()}
        metrics["errD"] = errD0
        metrics["errE"] = errE_out.detach()
        metrics["errG"] = (errG + errG_ex).detach()
        metrics["errG_ex"] = errG_ex.detach()
        return metrics
