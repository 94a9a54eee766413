"""A 20-step trajectory of the port's SRGAN step (``srgan_tpu_torch/
training/gan.py``) against the JAX ``GANTrainer`` on the CPU, in the regime
where phase 2's gradients are exactly zero (``reg = 0``, ``idt_reg = 0``),
the regime where ``tests/test_trainer_dynamics.py`` shows the JAX step
tracking the reference for 20 steps.

32 px, g/d/e_nch 8, g_res_num 1, d_num_cls 2, e_num_cls 2, batch 4, k 1,
fp32, the proposed loss stack otherwise, the encoder trunk training.  Both
sides start from the JAX init (carried over by the port's converters),
take the same histogram target, a new batch every step and a new injected
latent every step: the port through its ``_draw_latent`` seam, the JAX
step through a host schedule read by ``jax.pure_callback`` (the step
compiles once and replays the draws, as in
``tests/test_trainer_dynamics.py``).

Tolerances, those of ``tests/test_trainer_dynamics.py``'s strict regime:

  - at step n, errD, errG and errE agree within (2e-4 + 3e-4 n) relative
    (to at least 1): fp32 rounding on two sides, fed back through the GAN;
  - after the 20 steps the G, D and E parameters differ by at most
    2.2 x 2 x 20 Adam steps of lr anywhere (outliers at the noise floor
    that stepped the other way) and by at most 0.25 x lr x 20 on average.

Measured (CPU, 20 steps): the largest relative gap of the three losses
is 1.9e-7 at step 1, 2.4e-5 at step 7, 8.8e-5 at step 14 and 1.8e-4 at step
20 (the bound there is 6.2e-3): it grows by about three orders of magnitude
over the run, not steadily, and stays 30x inside the bound.  The
parameters end 8.8e-4 (G), 1.2e-5 (D) and 6.0e-8 (E) apart at most (the
bound is 8.8e-3) and 1.2e-4, 1.4e-7 and 5.9e-9 on average (the bound is
5e-4).
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)

import jax
import jax.numpy as jnp
import numpy as np
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

HW, B, K, NDIM, N_STEPS = 32, 4, 1, 8, 20
LR = 1e-4
MODEL = dict(image_size=HW, g_nch=8, g_res_num=1, d_nch=8, d_num_cls=2,
             e_nch=8, e_num_cls=2)
WEIGHTS = dict(cycle=5, idt=5, reg=0.0, idt_reg=0.0, KL=0, batch_KL=10,
               corr_enc=100, hist=100, cls=1)


def _configs():
    def make(E, M, T, W):
        return E(name="trajectory", model=M(**MODEL),
                 train=T(batch_size=B, unrolled_k=K, encoded_feature="mu",
                         lr_g=LR, lr_d=LR, lr_e=LR),
                 loss=W(**WEIGHTS), trainer="srgan")
    return (make(JExperimentConfig, JModelConfig, JTrainConfig, JLossWeights),
            make(ExperimentConfig, ModelConfig, TrainConfig, LossWeights))


class ScheduledJAX(JGANTrainer):
    """The JAX step's draws read at run time from a host schedule:
    ``schedule[step][site]``, the sites numbered in trace order."""

    def set_schedule(self, schedule):
        self.schedule = schedule
        self.site_seq = 0
        self.site_calls = {}

    def _draw_latent(self, key, shape):
        site = self.site_seq
        self.site_seq += 1

        def pop():
            i = self.site_calls.get(site, 0)
            self.site_calls[site] = i + 1
            arr = self.schedule[i][site]
            assert arr.shape == tuple(shape), (arr.shape, tuple(shape))
            return arr

        return jax.pure_callback(
            pop, jax.ShapeDtypeStruct(tuple(shape), jnp.float32))


class InjectedPort(GANTrainer):
    draws = None

    def _draw_latent(self, shape):
        arr = self.draws[self.draw_i]
        self.draw_i += 1
        assert arr.shape == tuple(shape), (arr.shape, tuple(shape))
        return torch.from_numpy(arr)


def _state_dicts(g, d, e):
    return dict(g=generator_state_dict_from_jax(g, num_cls=2, res_num=1),
                d=solo_discriminator_state_dict_from_jax(d, num_cls=2),
                e=encoder_state_dict_from_jax(e, num_cls=2))


def _abs_diff(ours, theirs):
    d = np.concatenate([
        np.abs(ours[k].detach().numpy() - theirs[k].numpy()).ravel()
        for k in sorted(theirs)])
    return float(d.max()), float(d.mean())


def test_twenty_steps_track_the_jax_step():
    jcfg, cfg = _configs()
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(N_STEPS):
        src = rng.integers(0, 4, B)
        batches.append(dict(
            image=rng.uniform(-1, 1, (B, HW, HW, 3)).astype(np.float32),
            source_label=src.astype(np.int64),
            target_label=((src + rng.integers(1, 4, B)) % 4)
            .astype(np.int64)))
    schedule = [[rng.standard_normal((B, NDIM)).astype(np.float32)
                 for _ in range(K)] for _ in range(N_STEPS)]

    jt = ScheduledJAX(jcfg, donate=False)
    jt.set_schedule(schedule)
    jstate = jt.init_state(jax.random.PRNGKey(0))
    start = _state_dicts(*jax.device_get(
        (jstate.g_params, jstate.d_params, jstate.e_params)))
    pt = InjectedPort(cfg, device="cpu")
    pstate = pt.init_state(g_state=start["g"], d_state=start["d"],
                           e_state=start["e"],
                           hist_target=np.asarray(jstate.hist_target))

    errd = []
    for n, (batch, draws) in enumerate(zip(batches, schedule), start=1):
        jstate, jm = jt.step(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                             jax.random.PRNGKey(n))
        pt.draws, pt.draw_i = draws, 0
        pm = pt.step(pstate, batch)
        assert pt.draw_i == K
        tol = 2e-4 + 3e-4 * n
        for k in ("errD", "errG", "errE"):
            a, b = float(pm[k]), float(jm[k])
            assert np.isfinite(a) and abs(a - b) <= tol * max(1.0, abs(b)), \
                (n, k, a, b)
        errd.append(float(jm["errD"]))
    # every scheduled draw was read exactly once on the JAX side
    assert jt.site_calls == {site: N_STEPS for site in range(K)}
    assert pstate.step == N_STEPS

    post = _state_dicts(*jax.device_get(
        (jstate.g_params, jstate.d_params, jstate.e_params)))
    for net, ours in (("g", pstate.G), ("d", pstate.D), ("e", pstate.E)):
        d_max, d_mean = _abs_diff(ours.state_dict(), post[net])
        assert d_max <= 2.2 * 2 * N_STEPS * LR, (net, d_max)
        assert d_mean <= 0.25 * LR * N_STEPS, (net, d_mean)
    # the losses moved: a trajectory, not one step repeated
    assert len(set(errd)) == N_STEPS
