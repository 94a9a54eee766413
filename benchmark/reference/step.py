"""The plain reference of SRGAN's training step (the notebooks' train loop,
one iteration): ``k - 1`` unrolled D updates, then phase 1 (the k-th D
update and one joint G/E gradient of the adversarial, cycle, identity and
restriction losses), then phase 2 (G alone on the style regression, with
fresh forwards).  Adam on every net; with a pretrained encoder only its
``fcmean`` and ``fcvar`` train.

The standard-normal draws of a step are taken from one generator in the
order the step needs them: k latents of (B, ndim), and for the SingleGAN
flavour one more, phase 2's identity target.  On the meta device the step
computes shapes only (``reference/counts.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import losses as L
from benchmark.reference.nets import build, set_precision

TRAINABLE_WHEN_FROZEN = ("fcmean", "fcvar")


class Reference:
    """The three nets of a configuration file (its dict) holding the given
    state dicts, their optimizers and the step.  ``precision`` "fp32"
    turns TF32 off on CUDA; "fp8" is the control (``nets.quant``)."""

    def __init__(self, config: dict, state_dicts, hist_target, device,
                 draw_seed: int | None, precision: str = "fp32"):
        if torch.device(device).type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg, self.device = config, torch.device(device)
        t, m = config["train"], config["model"]
        self.lw = config["loss"]
        self.k, self.ndim, self.nc = t["unrolled_k"], m["ndim"], m["n_classes"]
        self.n_batch = t["batch_size"]
        if t.get("encoded_feature", "mu") != "mu" or t.get("unrolled_restore"):
            raise NotImplementedError("the reference steps with mu and "
                                      "without unrolled_restore")
        self.per_domain = config["trainer"] == "singlegan"
        self.conditional = config["trainer"] in ("singlegan", "singlegan_solo")
        self.G, self.D, self.E = (set_precision(n, precision)
                                  for n in build(config, "meta"))
        if state_dicts is None:
            if self.device.type != "meta":
                raise ValueError("weights are needed off the meta device")
        else:
            for n, sd in zip((self.G, self.D, self.E), state_dicts):
                n.load_state_dict({k: v.clone() for k, v in sd.items()},
                                  strict=True, assign=True)
        if config.get("pretrained_encoder"):
            for name, p in self.E.named_parameters():
                p.requires_grad_(name.split(".", 1)[0]
                                 in TRAINABLE_WHEN_FROZEN)
        adam = dict(lr=t["lr_g"], betas=(t["adam_b1"], t["adam_b2"]),
                    eps=1e-8)
        self.opt_g = torch.optim.Adam(self.G.parameters(), **adam)
        self.opt_d = torch.optim.Adam(self.D.parameters(),
                                      **{**adam, "lr": t["lr_d"]})
        self.opt_e = torch.optim.Adam(
            [p for p in self.E.parameters() if p.requires_grad],
            **{**adam, "lr": t["lr_e"]})
        self.hist_target = hist_target
        self.gen = None if self.device.type == "meta" else \
            torch.Generator(self.device).manual_seed(draw_seed)

    def draw(self, b: int):
        if self.device.type == "meta":
            return torch.randn((b, self.ndim), device="meta")
        return torch.randn((b, self.ndim), generator=self.gen,
                           device=self.device)

    @staticmethod
    def apply(loss, *opts):
        """One gradient of ``loss`` for every parameter the optimizers hold
        (zeros for one it does not reach), then a step of each."""
        params = [p for o in opts for g in o.param_groups for p in g["params"]]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        for o in opts:
            o.step()
            o.zero_grad(set_to_none=True)

    def E_(self, x, onehot):
        return self.E(x, onehot) if self.conditional else self.E(x)

    def d_update(self, images, fake, oh_src, src, tgt):
        B = images.shape[0]
        both = torch.cat([images, fake.detach()], 0)
        if self.per_domain:
            total = 0.0
            for i, Di in enumerate(self.D):
                adv = Di(both)
                total = total + L.masked_lsgan([a[:B] for a in adv], 1.0,
                                               src == i) \
                    + L.masked_lsgan([a[B:] for a in adv], 0.0, tgt == i)
            self.apply(total, self.opt_d)
            return total.detach() / len(self.D)
        adv, cls = self.D(both)
        err = L.lsgan([a[:B] for a in adv], 1.0)
        if self.lw["cls"] > 0:
            err = err + self.lw["cls"] * L.domain_classification(
                [c[:B] for c in cls], oh_src)
        err = err + L.lsgan([a[B:] for a in adv], 0.0)
        self.apply(err, self.opt_d)
        return err.detach()

    def g_adversarial(self, fake, oh_tgt, tgt):
        if self.per_domain:
            return sum(L.masked_lsgan(Di(fake), 1.0, tgt == i)
                       for i, Di in enumerate(self.D)) / len(self.D)
        adv, cls = self.D(fake)
        err = L.lsgan(adv, 1.0)
        if self.lw["cls"] > 0:
            err = err + self.lw["cls"] * L.domain_classification(cls, oh_tgt)
        return err

    def step(self, images_nhwc, src, tgt) -> dict:
        """One iteration on a batch (images (B, H, W, C) in [-1, 1], source
        and target labels (B,)).  Returns the losses as 0-dim tensors."""
        lw = self.lw
        images = images_nhwc.permute(0, 3, 1, 2).float().contiguous()
        oh_src = F.one_hot(src.long(), self.nc).float()
        oh_tgt = F.one_hot(tgt.long(), self.nc).float()
        B = images.shape[0]
        errD0 = None
        for i in range(self.k - 1):
            latent = self.draw(B)
            with torch.no_grad():
                fake = self.G(images, torch.cat([oh_tgt, latent], 1))
            errD = self.d_update(images, fake, oh_src, src, tgt)
            if i == 0:
                errD0 = errD
        # phase 1
        latent = self.draw(B)
        cond_fake = torch.cat([oh_tgt, latent], 1)
        fake = self.G(images, cond_fake)
        errD = self.d_update(images, fake, oh_src, src, tgt)
        errD0 = errD if errD0 is None else errD0
        out = {}
        mu, logvar = self.E_(images, oh_src)
        recon = self.G(fake, torch.cat([oh_src, mu], 1))
        errG = self.g_adversarial(fake, oh_tgt, tgt)
        out["loss_cycle"] = L.l1(images, recon)
        errG = errG + lw["cycle"] * out["loss_cycle"]
        errE_out = lw["cycle"] * out["loss_cycle"]
        if lw["idt"] > 0:
            idt_img = self.G(images, torch.cat([oh_src, mu], 1))
            out["loss_idt"] = L.l1(images, idt_img)
            errG = errG + lw["idt"] * out["loss_idt"]
            errE_out = errE_out + lw["idt"] * out["loss_idt"]
        errE, terms = L.diversification(mu, lw, self.n_batch,
                                        self.hist_target)
        out.update(terms)
        errE_out = errE_out + errE
        self.apply(errG + errE, self.opt_g, self.opt_e)
        # phase 2
        if lw["idt_reg"] * lw["idt"] > 0:
            if self.conditional:
                reg_target = self.draw(B)
            else:
                with torch.no_grad():
                    reg_target = self.E_(images, None)[0]
            fake2 = self.G(images, cond_fake)
            idt2 = self.G(images, torch.cat([oh_src, reg_target], 1))
            mu_fake = self.E_(fake2, oh_tgt)[0]
            mu_idt = self.E_(idt2, oh_src)[0]
            errG_ex = lw["reg"] * L.l1(latent, mu_fake) \
                + L.l1(reg_target, mu_idt) * lw["idt_reg"] \
                * (lw["idt"] / lw["cycle"])
        else:
            mu_t = self.E_(self.G(images, cond_fake), oh_tgt)[0]
            errG_ex = lw["reg"] * L.l1(latent, mu_t)
        self.apply(errG_ex, self.opt_g)
        out = {k: v.detach() for k, v in out.items()}
        out["errD"] = errD0
        out["errE"] = errE_out.detach()
        out["errG"] = (errG + errG_ex).detach()
        out["errG_ex"] = errG_ex.detach()
        return out

    def optimizers(self):
        return {"G": self.opt_g, "D": self.opt_d, "E": self.opt_e}
