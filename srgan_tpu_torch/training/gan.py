"""The GAN trainer of the port: model construction, the train step and the
inference surface (counterpart of ``srgan_tpu/training/gan.py``), instance
or batch norm, on one device or data parallel over ``torch.distributed``,
for its three variants:

  ``singlegan``       nb01: one two-scale D per domain, the conditional
                      encoder (``EncoderOriginal``), no class loss;
  ``singlegan_solo``  nb02: the solo D with class heads, the conditional
                      encoder;
  ``srgan``           nb03/05: the solo D, the unconditional ``Encoder``.

``transform`` and ``encode`` and the train step's batch keep the JAX
package's NHWC layout at their boundary; the models inside take NCHW
shapes, stored channels-last on CUDA under bf16 compute
(``memory_format``).

Batch-norm mode (``norm_type="batch"``): G and E run in ``train()`` mode
inside the step, so their norms take the batch's statistics and move the
running ones in the JAX step's call order; ``transform`` and ``encode`` run
them in ``eval()`` mode, on the running statistics.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from srgan_tpu_torch.configs import ExperimentConfig
from srgan_tpu_torch.nn.discriminator import (
    SingleDiscriminatorOriginalMulti,
    SingleDiscriminatorSoloMulti,
)
from srgan_tpu_torch.nn.encoder import Encoder, EncoderOriginal
from srgan_tpu_torch.nn.generator import SingleGenerator
from srgan_tpu_torch.nn.layers import BatchNorm, CBBNorm, init_torch_default_
from srgan_tpu_torch.ops import losses as L
from srgan_tpu_torch.ops import norm
from srgan_tpu_torch.training import graphs
from srgan_tpu_torch.training.state import (
    GANTrainState,
    adam,
    freeze_encoder_trunk,
    make_capturable,
    set_lr,
)
from srgan_tpu_torch.utils import spans

TRAINERS = ("singlegan", "singlegan_solo", "srgan")
NORM_TYPES = ("instance", "batch")
GRAD_SYNCS = ("auto", "manual")


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device on a machine without CUDA
    raises instead of carrying on on the CPU.  On CUDA it also turns TF32
    off for cuDNN's convolutions and cuBLAS's matmuls (PyTorch lets
    convolutions use it by default), so that fp32 is computed in fp32, as
    the reference computes it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} asked for, but CUDA is "
                               "not available here; pass device='cpu' to "
                               "run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def memory_format(device, compute_dtype: str) -> torch.memory_format:
    """How the nets store 4-D weights and activations: channels-last (NHWC
    in memory) on CUDA under bf16 compute, where cuDNN's convolutions run
    NHWC and the norm takes its NHWC kernels, so no layout transpose runs
    between them; NCHW elsewhere (the CPU, and fp32 on CUDA, whose cuDNN
    convolutions with TF32 off are NCHW kernels).  ``build_generator``,
    ``build_discriminator``, ``build_encoder`` and the step read it from
    the device and the configuration's compute dtype."""
    if torch.device(device).type == "cuda" and compute_dtype == "bfloat16":
        return torch.channels_last
    return torch.contiguous_format


def net_format(net: nn.Module) -> torch.memory_format:
    """The layout ``net`` was built in: its first 4-D weight's."""
    return norm.layout(next(p for p in net.parameters() if p.dim() == 4))


def _nchw(images, fmt: torch.memory_format):
    """(N, H, W, C) images as (N, C, H, W) in ``fmt``: a view where ``fmt``
    is channels-last and the images are contiguous, else one copy."""
    return images.permute(0, 3, 1, 2).contiguous(memory_format=fmt)


def _check_config(cfg: ExperimentConfig):
    if cfg.trainer not in TRAINERS:
        raise ValueError(f"trainer {cfg.trainer!r}: one of {TRAINERS}")
    if cfg.model.norm_type not in NORM_TYPES:
        raise NotImplementedError(
            f"normalization layer [{cfg.model.norm_type}] is not found")


def conditional_encoder(cfg: ExperimentConfig) -> bool:
    """The SingleGAN trainers' encoder takes the class one-hot."""
    return cfg.trainer in ("singlegan", "singlegan_solo")


def _materialise(module, cfg: ExperimentConfig, device,
                 generator: Optional[torch.Generator], state_dict):
    """The module was created on the meta device, with no draw.  Its params
    become ``state_dict``'s (strict) or, without one, are drawn on the CPU
    from ``generator`` (default: one seeded with ``cfg.train.seed``); then
    it moves to ``device``, its 4-D tensors in ``memory_format``."""
    dev = resolve_device(device)
    if state_dict is not None:
        module.load_state_dict(state_dict, strict=True, assign=True)
    else:
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.train.seed)
        init_torch_default_(module.to_empty(device="cpu"), generator)
    fmt = memory_format(dev, cfg.train.compute_dtype)
    return module.to(dev, memory_format=fmt).eval()


def build_generator(cfg: ExperimentConfig, device="cuda",
                    generator: Optional[torch.Generator] = None,
                    state_dict=None) -> SingleGenerator:
    """The generator of ``cfg`` holding ``state_dict`` (reference key
    layout) or, without one, torch-default init drawn from ``generator``
    (default: seeded with ``cfg.train.seed``)."""
    _check_config(cfg)
    m = cfg.model
    with torch.device("meta"):
        G = SingleGenerator(nch_in=m.nch_in, nch=m.g_nch, reduce=m.g_reduce,
                            num_cls=m.g_num_cls, res_num=m.g_res_num,
                            norm_type=m.norm_type, num_con=m.num_con)
    return _materialise(G, cfg, device, generator, state_dict)


def build_encoder(cfg: ExperimentConfig, device="cuda",
                  generator: Optional[torch.Generator] = None,
                  state_dict=None) -> nn.Module:
    """The encoder of ``cfg``: ``EncoderOriginal`` for the SingleGAN
    trainers, else ``Encoder``; initialised as ``build_generator`` does."""
    _check_config(cfg)
    m = cfg.model
    with torch.device("meta"):
        if conditional_encoder(cfg):
            E = EncoderOriginal(nch_in=m.nch_in, nch_out=m.ndim, nch=m.e_nch,
                                num_cls=m.e_num_cls, num_con=m.n_classes,
                                norm_type=m.norm_type)
        else:
            E = Encoder(nch_in=m.nch_in, nch_out=m.ndim, nch=m.e_nch,
                        num_cls=m.e_num_cls, num_con=m.n_classes,
                        norm_type=m.norm_type)
    return _materialise(E, cfg, device, generator, state_dict)


def build_discriminator(cfg: ExperimentConfig, device="cuda",
                        generator: Optional[torch.Generator] = None,
                        state_dict=None) -> nn.Module:
    """The discriminator of ``cfg``, initialised as ``build_generator``
    does.  ``singlegan``: an ``nn.ModuleList`` of ``n_classes``
    ``SingleDiscriminatorOriginalMulti``, drawn in domain order, whose
    ``state_dict`` may also be a list of one state dict per domain.  Else
    the solo D, its class heads sized to the trunks' output maps
    (``srgan_tpu/training/gan.py:116-130``)."""
    _check_config(cfg)
    m = cfg.model
    with torch.device("meta"):
        if cfg.trainer == "singlegan":
            D = nn.ModuleList(
                SingleDiscriminatorOriginalMulti(
                    nch_in=m.nch_in, nch=m.d_nch, reduce=m.d_reduce,
                    num_cls=m.d_num_cls) for _ in range(m.n_classes))
            if isinstance(state_dict, (list, tuple)):
                state_dict = {f"{i}.{k}": v
                              for i, sd in enumerate(state_dict)
                              for k, v in sd.items()}
        else:
            k1 = m.image_size // (2 ** m.d_num_cls)
            D = SingleDiscriminatorSoloMulti(
                nch_in=m.nch_in, nch=m.d_nch, reduce=m.d_reduce,
                num_cls=m.d_num_cls, n_class=m.n_classes,
                cls_kernels=(k1, k1 // 2))
    return _materialise(D, cfg, device, generator, state_dict)


@contextlib.contextmanager
def _mode(training: bool, *modules):
    """``train()`` (batch-norm mode: the batch's statistics, moving the
    running ones) or ``eval()`` (the running statistics) for the block,
    then each module's mode as it was."""
    was = [m.training for m in modules]
    try:
        for m in modules:
            m.train(training)
        yield
    finally:
        for m, w in zip(modules, was):
            m.train(w)


def onehot(labels, n_classes: int) -> torch.Tensor:
    """Rows of ``eye(n_classes)``, fp32; a label out of range raises."""
    return F.one_hot(torch.as_tensor(labels).long(), n_classes).float()


@torch.inference_mode()
def transform(G: SingleGenerator, images: torch.Tensor, target_labels,
              latent: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """G_transformation: images (N, H, W, C) in [-1, 1] on G's device,
    target labels (N,), latent (N, ndim) or (ndim,), one style for the whole
    batch.  Returns (fakes (N, H, W, C) fp32, latent (N, ndim)).  G runs in
    eval mode (batch-norm mode: the running statistics)."""
    n = images.shape[0]
    latent = latent.float()
    if latent.dim() == 1:
        latent = latent.expand(n, latent.shape[0])
    cond = torch.cat([onehot(target_labels, G.num_con - latent.shape[1])
                      .to(images.device), latent], dim=1)
    x = _nchw(images, net_format(G))
    with _mode(False, G):
        fake = G(x, cond)
    return fake.permute(0, 2, 3, 1).contiguous(), latent


@torch.inference_mode()
def encode(E: nn.Module, images: torch.Tensor, labels=None):
    """Encoder forward on (N, H, W, C) images: (mu, logvar, class_out);
    class_out is None for the conditional encoder, which needs the images'
    ``labels`` (N,) (``srgan_tpu/training/gan.py:624-628``); the
    unconditional one ignores them.  E runs in eval mode."""
    x = _nchw(images, net_format(E))
    with _mode(False, E):
        if isinstance(E, EncoderOriginal):
            if labels is None:
                raise ValueError("the conditional encoder (SingleGAN "
                                 "trainers) needs the images' labels")
            _, mu, logvar = E(x, onehot(labels, E.num_con).to(x.device))
            return mu, logvar, None
        return E(x)


def _g_pair(G, x1, c1, x2, c2):
    """Two generator applications as one 2B forward (every op is per
    sample in instance mode, so this is exact; in batch mode it is one
    running-statistics update from the 2B batch, the JAX package's
    documented approximation, ``srgan_tpu/training/gan.py:221-230``)."""
    b = x1.shape[0]
    out = G(torch.cat([x1, x2], 0), torch.cat([c1, c2], 0))
    return out[:b], out[b:]


def _mean_over_ranks(tensors, mesh):
    """Every rank's tensors replaced by their mean over the ranks: one
    all-reduce of one flat fp32 buffer.  Each mean keeps its tensor's
    layout (a channels-last gradient goes in and comes out in memory
    order, through views), so Adam meets gradients laid out as its
    parameters are."""
    flat = torch.cat([(t.permute(0, 2, 3, 1) if norm.channels_last(t)
                       else t).reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat /= mesh.size
    out, i = [], 0
    for t in tensors:
        v = flat[i:i + t.numel()]
        if norm.channels_last(t):
            n, c, h, w = t.shape
            v = v.view(n, h, w, c).permute(0, 3, 1, 2)
        else:
            v = v.view_as(t)
        out.append(v.to(t.dtype))
        i += t.numel()
    return out


def _apply_grads(loss, *opts: torch.optim.Optimizer, mesh=None):
    """One gradient of ``loss`` with respect to every parameter the
    optimizers hold (an unused one gets zeros, as ``jax.grad`` gives), then
    one step of each.  Only those parameters get a gradient.  With a
    ``mesh`` the gradients are first averaged over the ranks, one
    all-reduce for the whole tree (``pmean``, ``srgan_tpu/training/gan.py:
    255-259``)."""
    params = [p for opt in opts for group in opt.param_groups
              for p in group["params"]]
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    if mesh is not None:
        grads = _mean_over_ranks(grads, mesh)
    for p, g in zip(params, grads):
        p.grad = g
    with spans.span("train.optimizer"):
        for opt in opts:
            opt.step()
            opt.zero_grad(set_to_none=True)


class _Inputs(NamedTuple):
    """A batch as the step takes it: images (B, C, H, W) in the nets'
    layout, the labels and their one-hots."""
    images: torch.Tensor
    src: torch.Tensor
    tgt: torch.Tensor
    onehot_src: torch.Tensor
    onehot_tgt: torch.Tensor


class _StepGraphs(NamedTuple):
    """The captured segments of a step at one batch size, and the tensors
    around them: the static inputs, the first errD and D's snapshot (the
    unrolled D update's copies, or phase 1's outputs where k = 1), and
    D's parameters the snapshot is copied from."""
    inputs: _Inputs
    d_update: Optional[graphs.Segment]
    phase1: graphs.Segment
    phase2: graphs.Segment
    errD0: torch.Tensor
    snapshot: Optional[List[torch.Tensor]]
    d_params: List[torch.Tensor]


class GANTrainer:
    """The train step of ``srgan_tpu/training/gan.py:235-511`` on one
    device: ``k - 1`` unrolled D updates, then phase 1 (the k-th D update
    and one joint G/E gradient of errG + errE), then phase 2 (a G step on
    the style regression, with fresh forwards at the phase-1 parameters).

    ``singlegan`` runs every domain's D on the whole batch with the LSGAN
    loss masked by source (real half) and target (fake half); D's gradient
    is that of the sum over the domains and ``errD`` their mean (quirk
    #14); a domain absent from the batch adds 0 (quirk #15) and its D still
    takes its Adam step on zero gradients.  ``encoded_feature="latent"``
    feeds G a reparametrised style, ``unrolled_restore=True`` rolls D's
    parameters (not Adam's moments) back to their values after the first
    of the k updates.

    Every standard-normal draw of the step (the k latents, the
    reparametrisation's noise, phase 2's SingleGAN identity target) goes
    through ``_draw_latent``, in the JAX step's order, from ``self.rng``;
    tests override the seam to inject the JAX side's draws (such a
    trainer steps eagerly).
    ``compute_dtype="bfloat16"`` runs the forwards under ``torch.autocast``,
    as serving does; the losses are fp32.

    Data parallel (``mesh``, a ``parallel.Mesh``): each rank steps on its
    rows of the global batch (``shard_batch``) with the same parameters,
    and both ``grad_sync`` values run the JAX package's manual recipe
    (``srgan_tpu/training/gan.py:246-288, 494-497``): one all-reduce (mean)
    of each update's gradients, the batch-global losses and the per-domain
    masked LSGAN through ``parallel.collectives``, every draw the global
    (n * b, d) one of the single-device step with this rank's rows taken,
    and the metrics averaged over the ranks.  Under ``"auto"`` batch-norm
    moments are also summed over the ranks, so the statistics are the
    global batch's, as GSPMD makes them; ``"manual"`` refuses batch mode,
    as the JAX package does (``:93-101``).  The fused diversification
    kernel is a single-device path: with a mesh and
    ``SRGAN_TPU_FUSED_DIV=1`` the trainer raises.

    On one CUDA device the step runs as CUDA graphs (``_graphed_step``):
    the unrolled D update, phase 1 and phase 2 are captured once a batch
    size and replayed, so the host launches a few graphs a step instead
    of thousands of kernels; the kernels, their inputs and the draws are
    the eager step's.  The CPU, the mesh and the fused path step eagerly.
    """

    def __init__(self, cfg: ExperimentConfig, device=None, mesh=None,
                 grad_sync: str = "auto"):
        _check_config(cfg)
        if grad_sync not in GRAD_SYNCS:
            raise ValueError(f"grad_sync must be auto|manual, got "
                             f"{grad_sync}")
        if grad_sync == "manual" and mesh is None:
            raise ValueError("grad_sync='manual' requires a mesh")
        if grad_sync == "manual" and cfg.model.norm_type == "batch":
            raise ValueError("grad_sync='manual' does not support "
                             "norm_type='batch'; use grad_sync='auto'")
        if device is None:
            device = "cuda" if mesh is None else mesh.device
        elif mesh is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        self.mesh = mesh
        self._check_fused()
        if cfg.train.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {cfg.train.compute_dtype!r}: "
                             "float32 or bfloat16")
        if cfg.train.encoded_feature not in ("mu", "latent"):
            raise ValueError(f"encoded_feature {cfg.train.encoded_feature!r}"
                             ": 'mu' or 'latent'")
        self.cfg = cfg
        self.per_domain = cfg.trainer == "singlegan"
        self.conditional_e = conditional_encoder(cfg)
        self.device = resolve_device(device)
        self.bf16 = cfg.train.compute_dtype == "bfloat16"
        self.rng = torch.Generator(device=self.device).manual_seed(
            cfg.train.seed + 1)
        # the step's CUDA graphs by (batch size, compute dtype): None after
        # the eager call that comes before the capture; ``_graphs_of``
        # holds the state they were captured from (``_graphed_step``)
        self._graphs: Dict[Tuple[int, str], Optional[_StepGraphs]] = {}
        self._graphs_of: Optional[tuple] = None

    def _check_fused(self):
        if self.mesh is not None and \
                os.environ.get("SRGAN_TPU_FUSED_DIV") == "1":
            raise ValueError("SRGAN_TPU_FUSED_DIV=1 with a mesh: the fused "
                             "diversification kernel is a single-device "
                             "path; unset it for data parallel")

    # ------------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None,
                   g_state=None, d_state=None, e_state=None,
                   hist_target: Optional[torch.Tensor] = None,
                   freeze_pretrained: bool = False) -> GANTrainState:
        """G, D and E hold the given state dicts (reference key layout, as
        the converters of ``utils/checkpoint.py`` make them from JAX
        parameter trees; for ``singlegan``'s D a list of one per domain
        too) or, where one is None, torch-default init drawn in the order
        G, D, E from ``generator`` (default: one seeded with
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
            if sd is None:
                return None
            if isinstance(sd, (list, tuple)):
                return [own(d) for d in sd]
            return {k: torch.as_tensor(v).clone() for k, v in sd.items()}

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
        if self.mesh is not None:
            from srgan_tpu_torch.parallel import replicate

            # every rank starts from rank 0's weights and target
            replicate([G, D, E, hist_target], self.mesh)
            for m in list(G.modules()) + list(E.modules()):
                if isinstance(m, (CBBNorm, BatchNorm)):
                    m.mesh = self.mesh
        # capturable for the graphed step, and from its first (eager) call
        cap = self.mesh is None and self.device.type == "cuda"
        return GANTrainState(
            G=G, D=D, E=E,
            opt_g=adam(G.parameters(), t.adam_b1, t.adam_b2, cap),
            opt_d=adam(D.parameters(), t.adam_b1, t.adam_b2, cap),
            opt_e=adam(e_params, t.adam_b1, t.adam_b2, cap),
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

    def _draw_batch(self, b: int, d: int) -> torch.Tensor:
        """(b, d) standard normals; with a mesh, this rank's rows of the
        global (n * b, d) draw, so the ranks take the single-device step's
        draws (``srgan_tpu/training/gan.py:261-269``)."""
        if self.mesh is None:
            return self._draw_latent((b, d))
        from srgan_tpu_torch.parallel.mesh import local_rows

        return local_rows(self._draw_latent((self.mesh.size * b, d)),
                          self.mesh)

    def _sample_latent(self, mu, logvar):
        """eps * exp(logvar / 2) + mu (``srgan_tpu/training/gan.py:
        271-273``)."""
        eps = self._draw_batch(*mu.shape)
        return eps * torch.exp(0.5 * logvar) + mu

    def _masked_lsgan(self, outputs, target, mask):
        if self.mesh is None:
            return L.masked_lsgan_loss(outputs, target, mask)
        from srgan_tpu_torch.parallel import collectives as C

        return C.global_masked_lsgan_loss(outputs, target, mask, self.mesh)

    def _diversification(self, mu, logvar, hist_target):
        lw, n_batch = self.cfg.loss, self.cfg.train.batch_size
        if self.mesh is None:
            return L.diversification_loss(mu, logvar, weights=lw,
                                          n_batch=n_batch,
                                          hist_target=hist_target)
        from srgan_tpu_torch.parallel import collectives as C

        return C.global_diversification_loss(
            mu, logvar, weights=lw, n_batch=n_batch,
            hist_target=hist_target, mesh=self.mesh)

    def _autocast(self):
        if not self.bf16:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=torch.bfloat16)

    def _E(self, E, x, oh):
        """(mu, logvar) of E on x; ``oh`` is the conditional E's one-hot."""
        if self.conditional_e:
            return E(x, oh)[1:]
        return E(x)[:2]

    # ------------------------------------------------------------------
    def _d_update(self, st: GANTrainState, images, fake, onehot_src,
                  src, tgt):
        """One D step on real + detached fake as one 2B forward; returns
        errD, for ``singlegan`` the mean over the domains
        (``srgan_tpu/training/gan.py:289-317``)."""
        lw = self.cfg.loss
        B = images.shape[0]
        both = torch.cat([images, fake.detach()], 0)
        if self.per_domain:
            total = 0.0
            for i, Di in enumerate(st.D):
                with self._autocast():
                    adv = Di(both)
                total = total + (
                    self._masked_lsgan([a[:B] for a in adv], 1.0, src == i)
                    + self._masked_lsgan([a[B:] for a in adv], 0.0,
                                         tgt == i))
            _apply_grads(total, st.opt_d, mesh=self.mesh)
            return total.detach() / len(st.D)
        with self._autocast():
            adv, cls = st.D(both)
        errD = L.lsgan_loss([a[:B] for a in adv], 1.0)
        if lw.cls > 0:
            errD = errD + lw.cls * L.domain_classification_loss(
                [c[:B] for c in cls], onehot_src)
        errD = errD + L.lsgan_loss([a[B:] for a in adv], 0.0)
        _apply_grads(errD, st.opt_d, mesh=self.mesh)
        return errD.detach()

    def _g_adversarial(self, D, fake, onehot_tgt, tgt):
        """G's adversarial (+ class) loss on the fakes against D at its
        post-k-update parameters; per domain, each D's masked LSGAN over
        the domain's targets, divided by the number of domains
        (``srgan_tpu/training/gan.py:356-367``)."""
        lw = self.cfg.loss
        if self.per_domain:
            errG = 0.0
            for i, Di in enumerate(D):
                with self._autocast():
                    adv = Di(fake)
                errG = errG + self._masked_lsgan(adv, 1.0, tgt == i) \
                    / len(D)
            return errG
        with self._autocast():
            adv, cls_out = D(fake)
        errG = L.lsgan_loss(adv, 1.0)
        if lw.cls > 0:
            errG = errG + lw.cls * L.domain_classification_loss(cls_out,
                                                                onehot_tgt)
        return errG

    def step(self, state: GANTrainState, batch: Dict[str, Any],
             epoch: int = 0) -> Dict[str, torch.Tensor]:
        """One training iteration on ``batch`` ({"image": (B, H, W, C) in
        [-1, 1], "source_label": (B,), "target_label": (B,)}; with a mesh,
        this rank's rows of the global batch).  Updates ``state`` in place;
        returns the metrics as 0-dim fp32 tensors on the device (errD, errG,
        errE, errG_ex and the loss_* terms), with a mesh the global
        batch's (the mean over the ranks).  The call is the span
        ``train.step``; inside it ``train.d_update`` (each of the k - 1
        unrolled D updates), ``train.phase1``, ``train.phase2`` and, in
        each of their gradient applications, ``train.optimizer``.

        On one CUDA device (``_graphable``) the step replays CUDA graphs
        (``_graphed_step``), which launch what the eager step launches and
        count what it counts, in the same spans; ``train.optimizer`` then
        closes only on the eager and capturing calls, since a replay runs
        the optimizer inside its segment's graph."""
        self._check_fused()
        with spans.span(spans.STEP, step=state.step,
                        batch=len(batch["image"])):
            with _mode(True, state.G, state.E):
                if self._graphable():
                    metrics = self._graphed_step(state, batch, epoch)
                else:
                    metrics = self._step(state, batch, epoch)
            if self.mesh is not None:
                keys = sorted(metrics)
                metrics = dict(zip(keys, _mean_over_ranks(
                    [metrics[key] for key in keys], self.mesh)))
        return metrics

    def _set_lrs(self, state: GANTrainState, epoch: int):
        for opt, lr in zip((state.opt_g, state.opt_d, state.opt_e),
                           self.lr_at(epoch)):
            set_lr(opt, lr)

    def _inputs(self, batch) -> _Inputs:
        images = _nchw(torch.as_tensor(batch["image"], dtype=torch.float32,
                                       device=self.device),
                       memory_format(self.device,
                                     self.cfg.train.compute_dtype))
        src = torch.as_tensor(batch["source_label"]).to(self.device)
        tgt = torch.as_tensor(batch["target_label"]).to(self.device)
        n_classes = self.cfg.model.n_classes
        return _Inputs(images, src, tgt, onehot(src, n_classes),
                       onehot(tgt, n_classes))

    def _snapshot(self, D):
        # a copy: the reference's state_dict() snapshot aliased the
        # parameters Adam updates in place (module docstring of
        # srgan_tpu/training/gan.py)
        return [p.detach().clone() for p in D.parameters()] \
            if self.cfg.train.unrolled_restore else None

    def _step(self, state: GANTrainState, batch, epoch):
        self._set_lrs(state, epoch)
        x = self._inputs(batch)
        errD0 = snapshot = None
        for i in range(self.cfg.train.unrolled_k - 1):
            with spans.span("train.d_update", i=i):
                errD = self._unrolled_d(state, x)
                if i == 0:
                    errD0, snapshot = errD, self._snapshot(state.D)
        with spans.span("train.phase1"):
            p1 = self._phase1(state, x, first=errD0 is None)
        if errD0 is None:
            errD0, snapshot = p1["errD"], p1["snapshot"]
        with spans.span("train.phase2"):
            metrics = self._phase2(state, x, p1, errD0, snapshot)
        state.step += 1
        return metrics

    # ---- the step's segments: each a function of the state and the
    # inputs alone, which the graphed step captures
    def _unrolled_d(self, st: GANTrainState, x: _Inputs):
        """One of the k - 1 unrolled D updates, with a fresh latent:
        errD."""
        latent = self._draw_batch(x.images.shape[0], self.cfg.model.ndim)
        with torch.no_grad(), self._autocast():
            fake = st.G(x.images, torch.cat([x.onehot_tgt, latent], 1))
        return self._d_update(st, x.images, fake, x.onehot_src, x.src,
                              x.tgt)

    def _phase1(self, st: GANTrainState, x: _Inputs, first: bool):
        """The k-th fake, computed once: its detached value drives the k-th
        D update and its graph serves the G/E gradient.  ``first``: no
        unrolled update came before (k = 1), so this update's errD is the
        step's and the restore snapshot is taken after it."""
        cfg, lw = self.cfg, self.cfg.loss
        G, D, E = st.G, st.D, st.E
        images, onehot_src = x.images, x.onehot_src
        use_latent = cfg.train.encoded_feature == "latent"
        latent = self._draw_batch(images.shape[0], cfg.model.ndim)
        cond_fake = torch.cat([x.onehot_tgt, latent], 1)
        with self._autocast():
            fake = G(images, cond_fake)
        errD = self._d_update(st, images, fake, onehot_src, x.src, x.tgt)
        snapshot = self._snapshot(D) if first else None

        metrics: Dict[str, torch.Tensor] = {}
        with self._autocast():
            mu, logvar = self._E(E, images, onehot_src)
        # "latent": a fresh reparametrised style for each G call; "mu": mu
        style_recon = self._sample_latent(mu, logvar) if use_latent else mu
        with self._autocast():
            if lw.idt > 0:
                style_idt = (self._sample_latent(mu, logvar) if use_latent
                             else mu)
                recon, idt_img = _g_pair(
                    G, fake, torch.cat([onehot_src, style_recon], 1),
                    images, torch.cat([onehot_src, style_idt], 1))
            else:
                recon = G(fake, torch.cat([onehot_src, style_recon], 1))
        # only the G/E parameters get a gradient (``_apply_grads``)
        errG = self._g_adversarial(D, fake, x.onehot_tgt, x.tgt)
        err_cycle = L.l1_loss(images, recon)
        errG = errG + lw.cycle * err_cycle
        metrics["loss_cycle"] = err_cycle
        errE_out = lw.cycle * err_cycle
        if lw.idt > 0:
            err_idt = L.l1_loss(images, idt_img)
            errG = errG + lw.idt * err_idt
            errE_out = errE_out + lw.idt * err_idt
            metrics["loss_idt"] = err_idt
        errE, div_metrics = self._diversification(mu, logvar, st.hist_target)
        metrics.update(div_metrics)
        errE_out = errE_out + errE
        _apply_grads(errG + errE, st.opt_g, st.opt_e, mesh=self.mesh)
        return {"latent": latent, "cond_fake": cond_fake, "errD": errD,
                "snapshot": snapshot,
                "metrics": {key: v.detach() for key, v in metrics.items()},
                "errG": errG.detach(), "errE": errE_out.detach()}

    def _phase2(self, st: GANTrainState, x: _Inputs, p1, errD0, snapshot):
        """G alone on the style regression, fresh forwards at the
        phase-1-updated parameters; then D back to ``snapshot`` (if any)
        and the step's metrics."""
        cfg, lw = self.cfg, self.cfg.loss
        G, E = st.G, st.E
        images, onehot_src, onehot_tgt = x.images, x.onehot_src, x.onehot_tgt
        latent, cond_fake = p1["latent"], p1["cond_fake"]
        B = images.shape[0]
        if lw.idt_reg * lw.idt > 0:
            if self.conditional_e:
                # SingleGAN flavour: a random source-style identity image
                reg_target = self._draw_batch(B, cfg.model.ndim)
                style = reg_target
            else:
                # SRGAN flavour: an encoder-driven identity image
                with torch.no_grad(), self._autocast():
                    reg_target, logvar_s = self._E(E, images, None)
                style = (self._sample_latent(reg_target, logvar_s)
                         if cfg.train.encoded_feature == "latent"
                         else reg_target)
            with self._autocast():
                fake2, idt2 = _g_pair(G, images, cond_fake, images,
                                      torch.cat([onehot_src, style], 1))
                mu_both = self._E(E, torch.cat([fake2, idt2], 0),
                                  torch.cat([onehot_tgt, onehot_src], 0))[0]
            errG_ex = lw.reg * L.l1_loss(latent, mu_both[:B]) \
                + L.l1_loss(reg_target, mu_both[B:]) * lw.idt_reg \
                * (lw.idt / lw.cycle)
        else:
            with self._autocast():
                mu_t = self._E(E, G(images, cond_fake), onehot_tgt)[0]
            errG_ex = lw.reg * L.l1_loss(latent, mu_t)
        _apply_grads(errG_ex, st.opt_g, mesh=self.mesh)
        if snapshot is not None:
            # D's parameters back to the post-first-update values; Adam's
            # moments keep all k updates (srgan_tpu/training/gan.py:506)
            with torch.no_grad():
                for p, v in zip(st.D.parameters(), snapshot):
                    p.copy_(v)
        errG_ex = errG_ex.detach()
        metrics = dict(p1["metrics"])
        metrics["errD"] = errD0
        metrics["errE"] = p1["errE"]
        metrics["errG"] = p1["errG"] + errG_ex
        metrics["errG_ex"] = errG_ex
        return metrics

    # ---- CUDA graphs
    def _graphable(self) -> bool:
        """Whether ``step`` replays CUDA graphs: on one CUDA device, with
        neither a mesh (NCCL under capture is not taken on) nor
        ``SRGAN_TPU_FUSED_DIV=1`` (a path of its own), and with the
        trainer's own ``_draw_latent`` (an override's draws are its
        caller's, which a capture would fix once for every replay)."""
        return (self.mesh is None and self.device.type == "cuda"
                and os.environ.get("SRGAN_TPU_FUSED_DIV") != "1"
                and type(self)._draw_latent is GANTrainer._draw_latent)

    def _graphed_step(self, state: GANTrainState, batch, epoch):
        """The step as CUDA graphs: per batch size (and compute dtype), the
        first call runs eagerly (Adam's state, cuDNN's plans and autograd's
        threads made outside any capture), the second captures the
        segments (``_capture``) and every call from then on replays them
        (``_replay``).  A state the graphs were not captured from, or whose
        optimizers or histogram target were replaced since (a checkpoint
        loaded into it), starts over."""
        held = (state.G, state.D, state.E, state.hist_target) + tuple(
            part for opt in (state.opt_g, state.opt_d, state.opt_e)
            for part in (opt.state, opt.param_groups))
        if self._graphs_of is None or any(
                a is not b for a, b in zip(held, self._graphs_of)):
            self._graphs, self._graphs_of = {}, held
            for opt in (state.opt_g, state.opt_d, state.opt_e):
                make_capturable(opt)
        key = (len(batch["image"]), self.cfg.train.compute_dtype)
        if key not in self._graphs:
            self._graphs[key] = None
            return self._step(state, batch, epoch)
        if self._graphs[key] is None:
            self._graphs[key] = self._capture(state, self._inputs(batch))
        return self._replay(state, self._graphs[key], batch, epoch)

    def _capture(self, state: GANTrainState, x: _Inputs) -> "_StepGraphs":
        """The segments captured on static copies of the inputs ``x``, in
        the order they replay and in one memory pool: the unrolled D update
        (k > 1), phase 1 and phase 2.  Every tensor that crosses a segment
        (phase 1's outputs, the first errD and D's snapshot) is held here,
        so no segment's memory is handed to another.  No autocast region is
        open across a segment, so autocast's cache of weight casts, which
        it drops on leaving its outermost region, never serves a replay a
        cast from before Adam's step: each captured cast kernel runs again
        on every replay."""
        k = self.cfg.train.unrolled_k
        x = _Inputs(*(t.clone() for t in x))
        pool = graphs.CudaGraph.pool()

        def segment(fn):
            return graphs.Segment(fn, pool, self.rng)

        d = errD0 = snapshot = None
        if k > 1:
            d = segment(lambda: self._unrolled_d(state, x))
            errD0 = torch.empty_like(d.out)
            snapshot = self._snapshot(state.D)
        p1 = segment(lambda: self._phase1(state, x, first=k == 1))
        if k == 1:
            errD0, snapshot = p1.out["errD"], p1.out["snapshot"]
        p2 = segment(lambda: self._phase2(state, x, p1.out, errD0, snapshot))
        return _StepGraphs(x, d, p1, p2, errD0, snapshot,
                           list(state.D.parameters()))

    def _replay(self, state: GANTrainState, g: "_StepGraphs", batch, epoch):
        """One step from the graphs: the batch into their inputs, the
        segments in their spans, and the host's part of the step (the
        learning rates, ``state.step``); the metrics are copies, since
        the next replay rewrites the graphs' outputs."""
        self._set_lrs(state, epoch)
        for static, t in zip(g.inputs, self._inputs(batch)):
            static.copy_(t)
        for i in range(self.cfg.train.unrolled_k - 1):
            with spans.span("train.d_update", i=i):
                g.d_update.replay()
                if i == 0:
                    # outside autograd: a copy it recorded would keep D's
                    # gradient accumulators alive past the step, on this
                    # stream, which a later capture then cannot wait on
                    with torch.no_grad():
                        g.errD0.copy_(g.d_update.out)
                        if g.snapshot is not None:
                            torch._foreach_copy_(g.snapshot, g.d_params)
        with spans.span("train.phase1"):
            g.phase1.replay()
        with spans.span("train.phase2"):
            g.phase2.replay()
        state.step += 1
        out = g.phase2.out
        return dict(zip(out, torch.stack(list(out.values())).unbind()))
