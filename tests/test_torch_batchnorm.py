"""The port's batch-norm mode (``norm_type="batch"``) against the JAX
package on the CPU, at the size of ``tests/test_batchnorm_mode.py`` (32 px,
g/d/e_nch 8, one residual block, batch 8, k 1).

  - ``CBBNorm`` against ``srgan_tpu/nn/layers.py::CBBNorm`` and
    ``BatchNorm`` against flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``:
    outputs within 1e-5 in training and in eval, running statistics after
    one update within 1e-6;
  - one ``GANTrainer.step`` from the JAX init (carried over with its
    ``batch_stats``) and the JAX step's own draw: every metric within 1e-4
    relative, G's and E's running statistics within 1e-5 of
    ``state.g_stats`` / ``state.e_stats``, the parameters by the
    Adam-sign-tolerant criterion of ``tests/test_torch_train.py``;
  - eval-mode ``transform`` and ``encode`` within 1e-4, and independent of
    the batch's composition (``test_batchnorm_mode.py:70-75``);
  - a checkpoint round trip that carries the running statistics, and
    ``serve --ckpt`` on it against the JAX ``transform`` / ``encode``,
    which the JAX ``Translator`` applies (``srgan_tpu/serving.py:49-56``).
"""

import dataclasses
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srgan_tpu.configs import ExperimentConfig as JExperimentConfig
from srgan_tpu.configs import LossWeights as JLossWeights
from srgan_tpu.configs import ModelConfig as JModelConfig
from srgan_tpu.configs import TrainConfig as JTrainConfig
from srgan_tpu.configs import config_to_dict
from srgan_tpu.nn.layers import CBBNorm as JCBBNorm
from srgan_tpu.parallel import make_mesh, shard_batch
from srgan_tpu.training import GANTrainer as JGANTrainer
from srgan_tpu_torch import serve
from srgan_tpu_torch.configs import config_from_dict, save_config
from srgan_tpu_torch.nn.layers import BatchNorm, CBBNorm
from srgan_tpu_torch.training.gan import (
    GANTrainer,
    build_generator,
    encode,
    transform,
)
from srgan_tpu_torch.utils.checkpoint import (
    encoder_state_dict_from_jax,
    generator_state_dict_from_jax,
    restore_checkpoint,
    save_checkpoint,
    solo_discriminator_state_dict_from_jax,
)

HW, B, NDIM = 32, 8, 8
LR = 1e-4
RTOL = 1e-4


def _jax_cfg():
    # the configuration of tests/test_batchnorm_mode.py, so the JAX inits'
    # compiles are shared
    model = JModelConfig(image_size=HW, g_nch=8, g_res_num=1, d_nch=8,
                         d_num_cls=2, e_nch=8, e_num_cls=2,
                         norm_type="batch")
    train = JTrainConfig(batch_size=B, unrolled_k=1, encoded_feature="mu")
    return JExperimentConfig(name="bn", model=model, train=train,
                             loss=JLossWeights.proposed_kl(cls=1.0),
                             trainer="srgan")


class InjectedPort(GANTrainer):
    def _draw_latent(self, shape):
        arr = self.draws[self.draw_i]
        self.draw_i += 1
        assert arr.shape == tuple(shape), (arr.shape, tuple(shape))
        return torch.tensor(arr)


def _state_dicts(g, d, e, g_stats, e_stats):
    return dict(G=generator_state_dict_from_jax(g, 2, 1, g_stats),
                D=solo_discriminator_state_dict_from_jax(d, 2),
                E=encoder_state_dict_from_jax(e, 2, e_stats))


def _assert_param_parity(ours, theirs, n_steps, name, bound_only=False):
    """``tests/test_torch_train.py``'s criterion on the parameters (the
    running statistics are held separately)."""
    keys = sorted(k for k in theirs if "running" not in k)
    d = np.concatenate([
        np.abs(ours[k].detach().cpu().numpy() - theirs[k].numpy()).ravel()
        for k in keys])
    assert d.max() <= 2.2 * n_steps * LR, (name, float(d.max()))
    if bound_only:
        return
    assert d.mean() < 0.02 * LR, (name, float(d.mean()))
    assert float((d > 1e-6).mean()) < 0.01, name


@pytest.mark.parametrize("kind", ["cbbnorm", "batchnorm"])
def test_norm_layers_match_flax(kind):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 5, 5, 6)) * 2 + 0.5).astype(np.float32)
    cond = rng.standard_normal((4, 12)).astype(np.float32)
    if kind == "cbbnorm":
        jm = JCBBNorm(6)
        args = (jnp.asarray(x), jnp.asarray(cond))
        train_kw, eval_kw = {}, dict(use_running_average=True)
    else:
        jm = fnn.BatchNorm(momentum=0.9, epsilon=1e-5)
        args = (jnp.asarray(x),)
        train_kw = dict(use_running_average=False)
        eval_kw = dict(use_running_average=True)
    variables = jm.init(jax.random.PRNGKey(0), *args, **train_kw)
    params, stats = variables["params"], variables["batch_stats"]
    want, upd = jm.apply(variables, *args, mutable=["batch_stats"],
                         **train_kw)
    want_eval = jm.apply({"params": params, **upd}, *args, **eval_kw)

    sd = {"weight": params["scale"], "bias": params["bias"],
          "running_mean": stats["mean"], "running_var": stats["var"]}
    if kind == "cbbnorm":
        sd["ConBias.0.weight"] = np.asarray(params["con_bias"]["kernel"]).T
        sd["ConBias.0.bias"] = params["con_bias"]["bias"]
        m = CBBNorm(6, 12)
    else:
        m = BatchNorm(6)
    m.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in
                       sd.items()})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    targs = (xt, torch.from_numpy(cond)) if kind == "cbbnorm" else (xt,)
    got = m.train()(*targs).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    for key, stat in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(m, key).numpy(),
                                   np.asarray(upd["batch_stats"][stat]),
                                   atol=1e-6, rtol=0, err_msg=key)
    got_eval = m.eval()(*targs).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got_eval.detach().numpy(),
                               np.asarray(want_eval), atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def world():
    """The JAX batch-mode init, one JAX step and one port step from the
    same weights, statistics and batch, the port handed the JAX step's own
    draw (``jax.random.split(rng, k + 4)[0]`` at k = 1,
    ``srgan_tpu/training/gan.py:440-462``).  The JAX step is the GSPMD one
    on ``make_mesh(2)``, whose statistics are the whole batch's as on one
    device (``tests/test_sharding.py``), and which
    ``tests/test_torch_parallel.py`` compiles too: one compile serves
    both files."""
    jcfg = _jax_cfg()
    jmesh = make_mesh(2)
    jt = JGANTrainer(jcfg, mesh=jmesh, donate=False)
    jstate = jt.init_state(jax.random.PRNGKey(0), image_size=HW)
    rng = np.random.default_rng(7)
    src = rng.integers(0, 4, B)
    batch = dict(image=rng.uniform(-1, 1, (B, HW, HW, 3)).astype(np.float32),
                 source_label=src.astype(np.int64),
                 target_label=((src + rng.integers(1, 4, B)) % 4)
                 .astype(np.int64))
    step_key = jax.random.PRNGKey(1)
    draws = [np.asarray(jax.random.normal(
        jax.random.split(step_key, 5)[0], (B, NDIM), jnp.float32))]
    start = _state_dicts(*jax.device_get(
        (jstate.g_params, jstate.d_params, jstate.e_params, jstate.g_stats,
         jstate.e_stats)))
    cfg = config_from_dict(config_to_dict(jcfg))
    pt = InjectedPort(cfg, device="cpu")
    pt.draws, pt.draw_i = draws, 0
    pstate = pt.init_state(g_state=start["G"], d_state=start["D"],
                           e_state=start["E"],
                           hist_target=np.asarray(jstate.hist_target))
    jstate, jm = jt.step(jstate, shard_batch(
        {k: jnp.asarray(v) for k, v in batch.items()}, jmesh), step_key)
    pm = pt.step(pstate, batch)
    post = _state_dicts(*jax.device_get(
        (jstate.g_params, jstate.d_params, jstate.e_params, jstate.g_stats,
         jstate.e_stats)))
    return types.SimpleNamespace(
        jt=jt, jstate=jstate, jm=jm, cfg=cfg, pt=pt, pstate=pstate, pm=pm,
        start=start, post=post, batch=batch, rng=rng)


def test_batch_mode_step_matches_jax(world):
    w = world
    assert w.pt.draw_i == 1
    assert set(w.pm) == set(w.jm)
    for k in w.jm:
        np.testing.assert_allclose(float(w.pm[k]), float(w.jm[k]),
                                   rtol=RTOL, err_msg=k)
    for name in ("G", "E"):
        ours = getattr(w.pstate, name).state_dict()
        running = [k for k in ours if "running" in k]
        assert len(running) == (2 * 7 if name == "G" else 2 * 4), running
        for k in running:
            np.testing.assert_allclose(ours[k].numpy(), w.post[name][k]
                                       .numpy(), atol=1e-5, rtol=0,
                                       err_msg=k)
            assert not torch.equal(ours[k], w.start[name][k]), k
    _assert_param_parity(w.pstate.G.state_dict(), w.post["G"], 2, "G",
                         bound_only=True)
    _assert_param_parity(w.pstate.D.state_dict(), w.post["D"], 1, "D")
    _assert_param_parity(w.pstate.E.state_dict(), w.post["E"], 1, "E")
    # the step leaves G and E in eval mode: running statistics outside it
    assert not w.pstate.G.training and not w.pstate.E.training


def test_batch_mode_transform_and_encode_match_jax(world):
    w = world
    images = w.batch["image"]
    labels = w.batch["target_label"]
    latent = w.rng.standard_normal((B, NDIM)).astype(np.float32)
    want = np.asarray(w.jt.transform(w.jstate, jnp.asarray(images),
                                     jnp.asarray(labels), latent=latent)[0])
    got, _ = transform(w.pstate.G, torch.from_numpy(images),
                       torch.from_numpy(labels), torch.from_numpy(latent))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    # eval mode: one image's output does not depend on the batch around it
    one, _ = transform(w.pstate.G, torch.from_numpy(images[:1]),
                       torch.from_numpy(labels[:1]),
                       torch.from_numpy(latent[:1]))
    np.testing.assert_allclose(one.numpy()[0], got.numpy()[0], atol=1e-4,
                               rtol=0)
    mu, logvar, _ = w.jt.encode(w.jstate, jnp.asarray(images))
    pmu, plogvar, _ = encode(w.pstate.E, torch.from_numpy(images))
    np.testing.assert_allclose(pmu.numpy(), np.asarray(mu), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(plogvar.numpy(), np.asarray(logvar),
                               atol=1e-4, rtol=0)


def test_batch_mode_checkpoint_round_trip_and_serve(world, tmp_path):
    w = world
    ckpt = tmp_path / "run" / "ckpt"
    save_checkpoint(str(ckpt), w.pstate, step=1)
    save_config(w.cfg, str(tmp_path / "run"))
    fresh = GANTrainer(w.cfg, device="cpu").init_state()
    restore_checkpoint(str(ckpt), fresh)
    assert fresh.step == w.pstate.step == 1
    for name in ("G", "D", "E"):
        a = getattr(fresh, name).state_dict()
        b = getattr(w.pstate, name).state_dict()
        assert set(a) == set(b)
        for k in b:
            assert torch.equal(a[k], b[k]), (name, k)
    assert any("running_var" in k for k in fresh.G.state_dict())

    args = serve.parse_args(["--ckpt", str(ckpt), "--device", "cpu",
                             "--warm-batch-sizes", "2", "4"])
    tr = serve.build_translator(args)
    images = w.batch["image"][:6]
    labels = w.batch["target_label"][:6]
    latent = w.rng.standard_normal((6, NDIM)).astype(np.float32)
    fakes, _ = tr.translate(images, labels, latent=latent)
    want = np.asarray(w.jt.transform(w.jstate, jnp.asarray(images),
                                     jnp.asarray(labels), latent=latent)[0])
    np.testing.assert_allclose(fakes, want, atol=1e-4, rtol=0)
    mu = np.asarray(w.jt.encode(w.jstate, jnp.asarray(images))[0])
    np.testing.assert_allclose(tr.encode(images)["mu"], mu, atol=1e-4,
                               rtol=0)


def test_batch_mode_init_and_norm_names():
    """A random batch-mode init: running means 0, variances 1, CBBNorm's
    weight from U(0, 1), flax BatchNorm's at 1; another norm name raises,
    as the JAX package's ``get_norm_kind`` does."""
    from srgan_tpu_torch.configs import (
        ExperimentConfig,
        LossWeights,
        ModelConfig,
        TrainConfig,
    )

    cfg = ExperimentConfig(name="bn", model=ModelConfig(
        image_size=HW, g_nch=8, g_res_num=1, norm_type="batch"),
        train=TrainConfig(), loss=LossWeights())
    G = build_generator(cfg, "cpu", torch.Generator().manual_seed(0))
    sd = G.state_dict()
    for k, v in sd.items():
        if k.endswith("running_mean"):
            assert torch.equal(v, torch.zeros_like(v)), k
        elif k.endswith("running_var"):
            assert torch.equal(v, torch.ones_like(v)), k
    w = sd["down_cnorms.0.weight"]
    assert bool(((w >= 0) & (w < 1)).all()) and len(set(w.tolist())) > 1
    assert torch.equal(sd["up_norms.0.weight"],
                       torch.ones_like(sd["up_norms.0.weight"]))
    bad = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, norm_type="group"))
    with pytest.raises(NotImplementedError, match="group"):
        build_generator(bad, "cpu")
