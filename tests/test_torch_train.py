"""The port's SRGAN train step (``srgan_tpu_torch/training/gan.py``,
``GANTrainer``) against the JAX ``GANTrainer`` on the CPU, at a small size
(32 px, g/d/e_nch 8, g_res_num 2, d_num_cls 3, e_num_cls 2, batch 4, k 2),
and in cases that take the step's other branches: no identity loss, no
classification loss, k = 1, and a later epoch's learning rates.

Both sides start from the same weights (the JAX init, carried over by the
port's converters), take the same in-step normal draws (injected through
each side's ``_draw_latent`` seam) and the same histogram target (the JAX
state's).  After the step:

  - errD, errG, errE, errG_ex and every loss_* metric agree within 1e-4
    relative (fp32 sums in another order through ten layers);
  - the G, D and E parameters agree by the Adam-sign-tolerant criterion of
    ``tests/test_trainer_parity.py`` (copied below): at Adam's first steps
    an update is about lr * sign(grad), so elements whose gradient sits at
    the fp32 noise floor may step the other way on the two sides.  Where
    phase 2 has a gradient, G's second Adam step of the iteration is no
    longer sign-like and carries those flips of phase 1 into most elements
    (a perturbation of the start weights at the fp32 rounding level moves
    the port's own one-step G update as much), so there G is held to the
    criterion's bound on outliers only, as
    ``test_srgan_full_stack_phase1_parity_and_bounded_phase2`` holds it.
    Phase 2's values stay held by errG_ex and errG at 1e-4.

The JAX step bakes its draws in at trace time, so a second step reuses
them; the port's injected seam hands out the same draws again.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srgan_tpu.configs import ExperimentConfig as JExperimentConfig
from srgan_tpu.configs import LossWeights as JLossWeights
from srgan_tpu.configs import ModelConfig as JModelConfig
from srgan_tpu.configs import TrainConfig as JTrainConfig
from srgan_tpu.training import GANTrainer as JGANTrainer
from srgan_tpu_torch.configs import (
    ExperimentConfig,
    LossWeights,
    ModelConfig,
    TrainConfig,
)
from srgan_tpu_torch.training.gan import GANTrainer
from srgan_tpu_torch.utils.checkpoint import (
    encoder_state_dict_from_jax,
    generator_state_dict_from_jax,
    solo_discriminator_state_dict_from_jax,
)

HW, B, K, NDIM = 32, 4, 2, 8
LR = 1e-4
RTOL = 1e-4
MODEL = dict(image_size=HW, g_nch=8, g_res_num=2, d_nch=8, d_num_cls=3,
             e_nch=8, e_num_cls=2)
FULL = dict(cycle=5, idt=5, reg=0.5, idt_reg=0.5, KL=0, batch_KL=10,
            corr_enc=100, hist=100, cls=1)
# case -> (loss weights, frozen encoder trunk, steps, unrolled_k, epoch)
CASES = {
    # the proposed stack with the frozen encoder trunk, two steps
    "full_frozen": (FULL, True, 2, K, 0),
    # no phase-2 regression (its gradients are exactly zero), trunk trains
    "no_phase2": (dict(FULL, reg=0.0, idt_reg=0.0), False, 1, K, 0),
    # no identity loss, which also turns off phase 2's idt_reg * idt term
    # (srgan_tpu/training/gan.py:341, :374, :397)
    "idt0": (dict(FULL, idt=0.0), True, 1, K, 0),
    # no domain classification in D or G (srgan_tpu/training/gan.py:299,
    # :359)
    "cls0": (dict(FULL, cls=0.0), True, 1, K, 0),
    # one D update per step, the one inside phase 1 (srgan_tpu/training/
    # gan.py:470-472)
    "k1": (FULL, True, 1, 1, 0),
    # a later epoch: ExponentialLR's rates through lr_at (srgan_tpu/
    # training/gan.py:590-598)
    "epoch2": (FULL, True, 1, K, 2),
    # the presets' k = 5 (srgan_tpu/configs.py:79-115)
    "k5": (FULL, True, 1, 5, 0),
}
MAX_K = max(case[3] for case in CASES.values())


def _configs(weights, k=K):
    def make(E, M, T, W):
        return E(name="parity", model=M(**MODEL),
                 train=T(batch_size=B, unrolled_k=k, encoded_feature="mu",
                         lr_g=LR, lr_d=LR, lr_e=LR),
                 loss=W(**weights), trainer="srgan")
    return (make(JExperimentConfig, JModelConfig, JTrainConfig, JLossWeights),
            make(ExperimentConfig, ModelConfig, TrainConfig, LossWeights))


class InjectedJAX(JGANTrainer):
    def _draw_latent(self, key, shape):
        arr = self.draws[self.draw_i]
        self.draw_i += 1
        assert arr.shape == tuple(shape), (arr.shape, tuple(shape))
        return jnp.asarray(arr)


class InjectedPort(GANTrainer):
    def _draw_latent(self, shape):
        arr = self.draws[self.draw_i]
        self.draw_i += 1
        assert arr.shape == tuple(shape), (arr.shape, tuple(shape))
        return torch.from_numpy(arr)


def _state_dicts(g, d, e):
    return dict(g=generator_state_dict_from_jax(g, num_cls=2, res_num=2),
                d=solo_discriminator_state_dict_from_jax(d, num_cls=3),
                e=encoder_state_dict_from_jax(e, num_cls=2))


def _assert_param_parity(ours, theirs, n_steps, name, bound_only=False):
    """Copied from tests/test_trainer_parity.py: (a) the bulk of elements
    match tightly, (b) outliers are bounded by n_steps opposite full Adam
    steps, (c) the mean difference is a tiny fraction of one step.
    ``bound_only`` checks (b) alone."""
    assert set(ours) == set(theirs), name
    d = np.concatenate([
        np.abs(ours[k].detach().cpu().numpy().astype(np.float32)
               - theirs[k].numpy().astype(np.float32)).ravel()
        for k in sorted(ours)])
    assert d.max() <= 2.2 * n_steps * LR, (name, float(d.max()))
    if bound_only:
        return
    assert d.mean() < 0.02 * LR, (name, float(d.mean()))
    frac = float((d > 1e-6).mean())
    assert frac < 0.01, (name, frac)


@pytest.fixture(scope="module")
def jax_init():
    """One JAX init (its jitted inits are the slow part on the CPU), with
    the frozen-encoder mask; the other case drops the mask."""
    jcfg, _ = _configs(FULL)
    state = JGANTrainer(jcfg, donate=False).init_state(
        jax.random.PRNGKey(0), freeze_pretrained=True)
    rng = np.random.default_rng(42)
    src = rng.integers(0, 4, B)
    batch = dict(image=rng.uniform(-1, 1, (B, HW, HW, 3)).astype(np.float32),
                 source_label=src.astype(np.int64),
                 target_label=((src + rng.integers(1, 4, B)) % 4)
                 .astype(np.int64))
    draws = [rng.standard_normal((B, NDIM)).astype(np.float32)
             for _ in range(MAX_K)]
    return types.SimpleNamespace(state=state, batch=batch, draws=draws)


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_matches_jax(jax_init, case):
    weights, frozen, n_steps, unrolled_k, epoch = CASES[case]
    jcfg, cfg = _configs(weights, unrolled_k)
    draws = jax_init.draws[:unrolled_k]
    jstate = jax_init.state if frozen else \
        jax_init.state.replace(e_mask=None)
    start = _state_dicts(*jax.device_get(
        (jstate.g_params, jstate.d_params, jstate.e_params)))

    jt = InjectedJAX(jcfg, donate=False)
    jt.draws = draws
    pt = InjectedPort(cfg, device="cpu")
    pt.draws = draws
    pstate = pt.init_state(g_state=start["g"], d_state=start["d"],
                           e_state=start["e"],
                           hist_target=np.asarray(jstate.hist_target),
                           freeze_pretrained=frozen)
    jbatch = {k: jnp.asarray(v) for k, v in jax_init.batch.items()}
    for _ in range(n_steps):
        jt.draw_i = 0
        jstate, jm = jt.step(jstate, jbatch, jax.random.PRNGKey(1),
                             epoch=epoch)
        pt.draw_i = 0
        pm = pt.step(pstate, jax_init.batch, epoch=epoch)
        assert pt.draw_i == unrolled_k
        assert set(pm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       rtol=RTOL, err_msg=k)
    assert pstate.step == n_steps

    post = _state_dicts(*jax.device_get(
        (jstate.g_params, jstate.d_params, jstate.e_params)))
    _assert_param_parity(pstate.G.state_dict(), post["g"], 2 * n_steps, "G",
                         bound_only=weights["reg"] + weights["idt_reg"] > 0)
    _assert_param_parity(pstate.D.state_dict(), post["d"],
                         unrolled_k * n_steps, "D")
    e_now = pstate.E.state_dict()
    _assert_param_parity(e_now, post["e"], n_steps, "E")
    for k, v in e_now.items():
        head = k.split(".")[0]
        moved = not torch.equal(v, start["e"][k])
        if frozen and head not in ("fcmean", "fcvar"):
            assert not moved, k      # bit-equal to its start
        elif head not in ("fcvar", "fcclass"):
            # fcvar and fcclass reach no loss in mu mode with KL = 0
            assert moved, k


def test_lr_schedule_and_step_semantics_guards():
    _, cfg = _configs(FULL)
    t = GANTrainer(cfg, device="cpu")
    assert t.lr_at(0) == (LR, LR, LR)
    assert t.lr_at(2) == pytest.approx(tuple([LR * 0.95 ** 2] * 3))
    # the JAX step's options are all ported (tests/test_torch_singlegan.py)
    for change in (dict(unrolled_restore=True),
                   dict(encoded_feature="latent")):
        GANTrainer(dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, **change)),
            device="cpu")
    with pytest.raises(ValueError, match="encoded_feature"):
        GANTrainer(dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, encoded_feature="z")), device="cpu")
    # batch norm is ported (tests/test_torch_batchnorm.py); a norm the
    # JAX package does not know is refused, as its get_norm_kind does
    GANTrainer(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, norm_type="batch")), device="cpu")
    with pytest.raises(NotImplementedError, match="group"):
        GANTrainer(dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, norm_type="group")), device="cpu")
    with pytest.raises(ValueError, match="trainer"):
        GANTrainer(dataclasses.replace(cfg, trainer="stargan"), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA present: nothing to check")
        GANTrainer(cfg)            # device defaults to cuda
