"""The port's SingleGAN trainers and step options against the JAX package
on the CPU, at a small size (32 px, g/d/e_nch 8, g_res_num 1, d_num_cls 3,
e_num_cls 2, batch 4):

  - ``EncoderOriginal`` (the conditional encoder) and
    ``SingleDiscriminatorOriginalMulti`` (one domain's D) against the JAX
    modules at 1e-5 absolute, their weights carried over by the port's
    converters (which must equal the JAX package's own torch export) and
    loaded with strict=True;
  - the train step of ``singlegan`` (per-domain Ds, masked LSGAN),
    ``singlegan_solo``, ``encoded_feature="latent"`` and
    ``unrolled_restore=True`` against the JAX ``GANTrainer`` with the same
    weights and draws: every metric within 1e-4 relative and the G, D and
    E parameters by the criterion of ``tests/test_torch_train.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srgan_tpu.configs import ExperimentConfig as JExperimentConfig
from srgan_tpu.configs import LossWeights as JLossWeights
from srgan_tpu.configs import ModelConfig as JModelConfig
from srgan_tpu.configs import TrainConfig as JTrainConfig
from srgan_tpu.nn import EncoderOriginal as JEncoderOriginal
from srgan_tpu.nn import SingleDiscriminatorOriginalMulti as JDOriginal
from srgan_tpu.training import GANTrainer as JGANTrainer
from srgan_tpu.utils.checkpoint import (
    export_torch_encoder,
    export_torch_original_discriminator,
)
from srgan_tpu_torch.configs import (
    PRESETS,
    ExperimentConfig,
    LossWeights,
    ModelConfig,
    TrainConfig,
)
from srgan_tpu_torch.training import gan
from srgan_tpu_torch.training.gan import GANTrainer
from srgan_tpu_torch.utils.checkpoint import (
    encoder_original_state_dict_from_jax,
    encoder_state_dict_from_jax,
    generator_state_dict_from_jax,
    original_discriminator_state_dict_from_jax,
    per_domain_discriminator_state_dicts_from_jax,
    solo_discriminator_state_dict_from_jax,
)

from test_torch_train import InjectedJAX, InjectedPort, _assert_param_parity

ATOL = 1e-5
RTOL = 1e-4
HW, B, NDIM, LR = 32, 4, 8, 1e-4
NCH, D_CLS, E_CLS = 8, 3, 2
MODEL = dict(image_size=HW, g_nch=NCH, g_res_num=1, d_nch=NCH,
             d_num_cls=D_CLS, e_nch=NCH, e_num_cls=E_CLS)
PROPOSED = dict(KL=0.0, batch_KL=10.0, corr_enc=100.0, hist=100.0)
CONVENTIONAL = dict(KL=0.1, batch_KL=0.0, corr_enc=0.0, hist=0.0)
# case -> (trainer, loss weights, k, encoded_feature, unrolled_restore,
#          labels (source, target) or None for the fixture's)
CASES = {
    # nb01's conventionalKL arm: the reparametrised style, k = 1
    "singlegan_conventional_k1_latent": (
        "singlegan", dict(CONVENTIONAL, idt_reg=0.0, cls=0.0), 1, "latent",
        False, None),
    # nb01's proposedKL arm with the identity regression (phase 2's
    # SingleGAN flavour)
    "singlegan_proposed_k2_idt_reg": (
        "singlegan", dict(PROPOSED, idt_reg=0.5, cls=0.0), 2, "mu", False,
        None),
    # domain 3 is neither a source nor a target: its D adds 0 to the loss
    # and takes its Adam step on zero gradients (quirk #15)
    "singlegan_absent_domain": (
        "singlegan", dict(PROPOSED, idt_reg=0.0, cls=0.0), 2, "mu", False,
        ([0, 1, 2, 0], [1, 2, 0, 2])),
    # nb02: the solo D and its class heads with the conditional encoder
    "singlegan_solo": (
        "singlegan_solo", dict(PROPOSED, idt_reg=0.5, cls=1.0), 2, "mu",
        False, None),
    # D's parameters back to their post-first-update values; the SRGAN
    # flavour of phase 2 with a reparametrised identity style
    "srgan_unrolled_restore_k3": (
        "srgan", dict(PROPOSED, idt_reg=0.5, cls=1.0), 3, "latent", True,
        None),
}


def _configs(trainer, weights, k, feature, restore):
    def make(E, M, T, W):
        return E(name="singlegan_parity", model=M(**MODEL),
                 train=T(batch_size=B, unrolled_k=k, encoded_feature=feature,
                         unrolled_restore=restore, lr_g=LR, lr_d=LR,
                         lr_e=LR),
                 loss=W(**weights), trainer=trainer)
    return (make(JExperimentConfig, JModelConfig, JTrainConfig, JLossWeights),
            make(ExperimentConfig, ModelConfig, TrainConfig, LossWeights))


def _perturbed(params, seed):
    """Every leaf moved off its init (CBINorm's affine starts at 1 and 0,
    which would hide a swapped carry-over)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + np.float32(0.05) * rng.standard_normal(
            a.shape).astype(np.float32), jax.device_get(params))


# ---------------------------------------------------------------- models

@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (3, HW, HW, 3)).astype(np.float32)
    c = np.eye(4, dtype=np.float32)[[0, 2, 3]]
    return x, c


def test_encoder_original_matches_jax(inputs):
    x, c = inputs
    je = JEncoderOriginal(nch=NCH, num_cls=E_CLS)
    rngs = {"params": jax.random.PRNGKey(1),
            "reparam": jax.random.PRNGKey(2)}
    params = _perturbed(je.init(rngs, jnp.asarray(x), jnp.asarray(c))
                        ["params"], 3)
    got = encoder_original_state_dict_from_jax(params, num_cls=E_CLS)
    want = export_torch_encoder(params, num_cls=E_CLS, conditional=True)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), k)
    cfg = dataclasses.replace(PRESETS["02_singlegan_solod"](),
                              model=ModelConfig(**MODEL))
    E = gan.build_encoder(cfg, "cpu", state_dict=got)        # strict=True
    assert set(E.state_dict()) == set(want)
    jc, jmu, jlogvar = je.apply({"params": params}, jnp.asarray(x),
                                jnp.asarray(c), sample=False)
    with torch.no_grad():
        code, mu, logvar = E(torch.from_numpy(x.transpose(0, 3, 1, 2)
                                              .copy()), torch.from_numpy(c))
    for a, b in ((code, jc), (mu, jmu), (logvar, jlogvar)):
        assert a.dtype == torch.float32 and a.shape == (3, NDIM)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0)
    # the serving surface takes the labels the one-hot comes from
    m2, lv2, cls = gan.encode(E, torch.from_numpy(x),
                              torch.tensor([0, 2, 3]))
    assert cls is None
    np.testing.assert_array_equal(m2.numpy(), mu.numpy())
    with pytest.raises(ValueError, match="labels"):
        gan.encode(E, torch.from_numpy(x))


def test_original_discriminator_matches_jax(inputs):
    x, _ = inputs
    jd = JDOriginal(nch=NCH, num_cls=D_CLS)
    params = _perturbed(jd.init(jax.random.PRNGKey(4), jnp.asarray(x))
                        ["params"], 5)
    got = original_discriminator_state_dict_from_jax(params, num_cls=D_CLS)
    want = export_torch_original_discriminator(params, num_cls=D_CLS)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), k)
    cfg = dataclasses.replace(PRESETS["01_proposed_singlegan_k1"](),
                              model=ModelConfig(**MODEL))
    D = gan.build_discriminator(cfg, "cpu", state_dict=[got] * 4)
    assert isinstance(D, torch.nn.ModuleList) and len(D) == 4
    D0 = D[0]
    D0.load_state_dict(got, strict=True)
    j1, j2 = jd.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        out = D0(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    for a, b in zip(out, (j1, j2)):
        np.testing.assert_allclose(a.numpy().transpose(0, 2, 3, 1),
                                   np.asarray(b), atol=ATOL, rtol=0)

    # the trainer's stacked tree -> one state dict per domain
    stacked = jax.tree.map(lambda a: np.stack([a, a + 1.0]), params)
    per = per_domain_discriminator_state_dicts_from_jax(stacked, D_CLS)
    assert len(per) == 2
    for k, v in got.items():
        np.testing.assert_array_equal(per[0][k].numpy(), v.numpy())
        np.testing.assert_array_equal(per[1][k].numpy(), v.numpy() + 1.0)


# ---------------------------------------------------------------- the step

@pytest.fixture(scope="module")
def jax_inits():
    """One JAX init per trainer (the jitted inits are the slow part)."""
    cache = {}

    def get(trainer):
        if trainer not in cache:
            jcfg, _ = _configs(trainer, dict(PROPOSED, cls=1.0), 1, "mu",
                               False)
            cache[trainer] = JGANTrainer(jcfg, donate=False).init_state(
                jax.random.PRNGKey(0))
        return cache[trainer]
    return get


def _port_state_dicts(trainer, g, d, e):
    return dict(
        g=generator_state_dict_from_jax(g, num_cls=2, res_num=1),
        d=(per_domain_discriminator_state_dicts_from_jax(d, D_CLS)
           if trainer == "singlegan"
           else solo_discriminator_state_dict_from_jax(d, D_CLS)),
        e=(encoder_state_dict_from_jax(e, E_CLS) if trainer == "srgan"
           else encoder_original_state_dict_from_jax(e, E_CLS)))


def _flat(sd):
    """A list of per-domain state dicts as the ModuleList's keys."""
    if isinstance(sd, list):
        return {f"{i}.{k}": v for i, d in enumerate(sd) for k, v in d.items()}
    return sd


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_matches_jax(jax_inits, case):
    trainer, weights, k, feature, restore, labels = CASES[case]
    jcfg, cfg = _configs(trainer, weights, k, feature, restore)
    jstate = jax_inits(trainer)
    rng = np.random.default_rng(7)
    if labels is None:
        src = rng.integers(0, 4, B)
        tgt = (src + rng.integers(1, 4, B)) % 4
    else:
        src, tgt = (np.asarray(v) for v in labels)
    batch = dict(image=rng.uniform(-1, 1, (B, HW, HW, 3)).astype(np.float32),
                 source_label=src.astype(np.int64),
                 target_label=tgt.astype(np.int64))
    draws = [rng.standard_normal((B, NDIM)).astype(np.float32)
             for _ in range(k + 3)]
    start = _port_state_dicts(trainer, *jax.device_get(
        (jstate.g_params, jstate.d_params, jstate.e_params)))
    # the proposed stack's imitation target, the JAX init's
    hist = np.asarray(jstate.hist_target) if cfg.loss.batch_KL > 0 else None

    jt = InjectedJAX(jcfg, donate=False)
    jt.draws, jt.draw_i = draws, 0
    jstate2, jm = jt.step(jstate, {kk: jnp.asarray(v)
                                   for kk, v in batch.items()},
                          jax.random.PRNGKey(1))

    pt = InjectedPort(cfg, device="cpu")
    pt.draws, pt.draw_i = draws, 0
    pstate = pt.init_state(g_state=start["g"], d_state=start["d"],
                           e_state=start["e"], hist_target=hist)
    snaps = []
    d_step = pstate.opt_d.step

    def recording_step(*a, **kw):
        out = d_step(*a, **kw)
        snaps.append([p.detach().clone() for p in pstate.D.parameters()])
        return out

    pstate.opt_d.step = recording_step
    pm = pt.step(pstate, batch)
    assert pt.draw_i == jt.draw_i
    assert set(pm) == set(jm)
    for key in jm:
        np.testing.assert_allclose(float(pm[key]), float(jm[key]),
                                   rtol=RTOL, err_msg=key)

    post = _port_state_dicts(trainer, *jax.device_get(
        (jstate2.g_params, jstate2.d_params, jstate2.e_params)))
    _assert_param_parity(pstate.G.state_dict(), post["g"], 2, "G",
                         bound_only=cfg.loss.reg + cfg.loss.idt_reg > 0)
    _assert_param_parity(pstate.D.state_dict(), _flat(post["d"]),
                         1 if restore else k, "D")
    _assert_param_parity(pstate.E.state_dict(), post["e"], 1, "E")

    # Adam took all k D updates, on every parameter
    assert len(snaps) == k
    for p in pstate.D.parameters():
        assert int(pstate.opt_d.state[p]["step"]) == k
    d_now = [p.detach() for p in pstate.D.parameters()]
    if restore:
        # bit for bit the parameters after the first update
        for a, b in zip(d_now, snaps[0]):
            assert torch.equal(a, b)
        assert not all(torch.equal(a, b) for a, b in zip(d_now, snaps[-1]))
    else:
        for a, b in zip(d_now, snaps[-1]):
            assert torch.equal(a, b)
    if labels is not None:
        # the absent domain's D: zero gradients, zero Adam moments, no move
        absent = sorted(set(range(4)) - set(labels[0]) - set(labels[1]))
        assert absent == [3]
        for name, v in pstate.D[3].state_dict().items():
            assert torch.equal(v, start["d"][3][name]), name
        for p in pstate.D[3].parameters():
            assert not pstate.opt_d.state[p]["exp_avg"].any()


def test_presets_build_their_models():
    """Each SingleGAN preset builds the JAX trainer's model family."""
    from srgan_tpu_torch.nn.discriminator import (
        SingleDiscriminatorOriginalMulti,
        SingleDiscriminatorSoloMulti,
    )
    from srgan_tpu_torch.nn.encoder import Encoder, EncoderOriginal

    want = {"01_conventional_singlegan": (SingleDiscriminatorOriginalMulti,
                                          EncoderOriginal),
            "01_proposed_singlegan_k5": (SingleDiscriminatorOriginalMulti,
                                         EncoderOriginal),
            "02_singlegan_solod": (SingleDiscriminatorSoloMulti,
                                   EncoderOriginal),
            "05_srgan_full": (SingleDiscriminatorSoloMulti, Encoder)}
    for name, (d_kind, e_kind) in want.items():
        cfg = dataclasses.replace(PRESETS[name](), model=ModelConfig(**MODEL))
        state = GANTrainer(cfg, device="cpu").init_state()
        d = state.D[0] if isinstance(state.D, torch.nn.ModuleList) \
            else state.D
        assert isinstance(d, d_kind) and isinstance(state.E, e_kind), name
        if d_kind is SingleDiscriminatorOriginalMulti:
            assert len(state.D) == cfg.model.n_classes
        assert (state.hist_target is None) == (cfg.loss.batch_KL == 0), name


def test_checkpoint_round_trips_the_per_domain_ds(tmp_path):
    from srgan_tpu_torch.utils.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )

    cfg = dataclasses.replace(PRESETS["01_conventional_singlegan"](),
                              model=ModelConfig(**MODEL),
                              train=TrainConfig(batch_size=B, unrolled_k=1,
                                                encoded_feature="latent"))
    t = GANTrainer(cfg, device="cpu")
    state = t.init_state(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(0)
    src = rng.integers(0, 4, B)
    t.step(state, dict(image=rng.uniform(-1, 1, (B, HW, HW, 3))
                       .astype(np.float32), source_label=src,
                       target_label=(src + 1) % 4))
    save_checkpoint(str(tmp_path), state, step=1)
    other = t.init_state(torch.Generator().manual_seed(2))
    restore_checkpoint(str(tmp_path), other)
    for net in ("G", "D", "E"):
        a, b = getattr(state, net).state_dict(), getattr(other, net) \
            .state_dict()
        assert set(a) == set(b)
        for key in a:
            assert torch.equal(a[key], b[key]), (net, key)
    assert sorted({k.split(".")[0] for k in other.D.state_dict()}) == \
        ["0", "1", "2", "3"]
    for p, q in zip(state.D.parameters(), other.D.parameters()):
        assert torch.equal(state.opt_d.state[p]["exp_avg"],
                           other.opt_d.state[q]["exp_avg"])
