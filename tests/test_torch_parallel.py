"""The port's data parallel over ``torch.distributed`` (``srgan_tpu_torch/
parallel``, ``GANTrainer(mesh=...)``, the sharded feed and the CLI's
``--mesh``) against the JAX package's mesh on the CPU: two gloo ranks,
spawned with a ``file://`` rendezvous under ``tmp_path`` (no port to
collide under xdist), one thread each, every spawn with its own timeout.

  - each function of ``parallel/collectives.py`` on 2 ranks against its
    JAX ``shard_map`` form on ``make_mesh(2)`` and against the port's
    single-process loss, values within 1e-5 and gradients within 1e-5 of
    their largest entry (at least 1).  A rank's
    gradient carries the group's size (the all-reduce's backward sums the
    ranks' cotangents, as ``psum``'s transpose does; the trainer's
    gradient mean cancels it), so the rows' gradients are compared after
    dividing by 2;
  - one data-parallel step of the SRGAN trainer (instance norm, and batch
    norm under ``"auto"``) on 2 ranks, global batch 8, against the JAX
    mesh step with ``grad_sync`` "auto" and "manual" (and batch mode's
    GSPMD step), the port handed the JAX step's own draws: metrics within
    1e-4 relative, parameters by the
    Adam-sign-tolerant criterion of ``tests/test_torch_train.py``, batch
    mode's running statistics within 1e-5; both ranks bit-equal;
  - the refusals: ``manual`` without a mesh or with batch norm,
    ``SRGAN_TPU_FUSED_DIV=1`` with a mesh, ``make_mesh`` and ``--mesh``
    without a process group;
  - the feed: each rank's rows of the loader's global batches, decoded
    alone, are the single-process loader's rows;
  - ``torchrun --nproc_per_node 2 -m srgan_tpu_torch.train --mesh`` on the
    CPU against the same run on one process.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_ranks as ranks
from srgan_tpu.configs import ExperimentConfig as JExperimentConfig
from srgan_tpu.configs import LossWeights as JLossWeights
from srgan_tpu.configs import ModelConfig as JModelConfig
from srgan_tpu.configs import TrainConfig as JTrainConfig
from srgan_tpu.configs import config_to_dict
from srgan_tpu.parallel import collectives as JC
from srgan_tpu.parallel import make_mesh as jax_make_mesh
from srgan_tpu.parallel import shard_batch as jax_shard_batch
from srgan_tpu.training import GANTrainer as JGANTrainer
from srgan_tpu_torch.configs import LossWeights, config_from_dict
from srgan_tpu_torch.data import DataLoader, FaceDataset, prefetch_to_device
from srgan_tpu_torch.data import make_synthetic_celeba
from srgan_tpu_torch.ops import losses as L
from srgan_tpu_torch.parallel import Mesh, make_mesh, shard_batch
from srgan_tpu_torch.training.gan import GANTrainer
from srgan_tpu_torch.utils.checkpoint import (
    encoder_state_dict_from_jax,
    generator_state_dict_from_jax,
    solo_discriminator_state_dict_from_jax,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, B, NDIM, NB = 32, 8, 8, 16
LR = 1e-4
RTOL = 1e-4
# name -> (norm_type, grad_sync); the port's two grad_sync values run one
# recipe, so its "auto" step is also held against the JAX manual step
STEPS = {"auto": ("instance", "auto"), "manual": ("instance", "manual"),
         "batch_auto": ("batch", "auto")}


def _jax_cfg(norm_type):
    # tests/test_sharding.py's model at batch 8, k 1
    model = JModelConfig(image_size=HW, g_nch=8, g_res_num=1, d_nch=8,
                         d_num_cls=2, e_nch=8, e_num_cls=2,
                         norm_type=norm_type)
    train = JTrainConfig(batch_size=B, unrolled_k=1, encoded_feature="mu")
    return JExperimentConfig(name="dp", model=model, train=train,
                             loss=JLossWeights.proposed_kl(cls=1.0),
                             trainer="srgan")


def _state_dicts(state, batch_mode):
    g, d, e, gs, es = jax.device_get(
        (state.g_params, state.d_params, state.e_params, state.g_stats,
         state.e_stats))
    return dict(G=generator_state_dict_from_jax(g, 2, 1,
                                                gs if batch_mode else None),
                D=solo_discriminator_state_dict_from_jax(d, 2),
                E=encoder_state_dict_from_jax(e, 2,
                                              es if batch_mode else None))


def _assert_param_parity(ours, theirs, n_steps, name, bound_only=False):
    """``tests/test_torch_train.py``'s criterion on the parameters."""
    keys = sorted(k for k in theirs if "running" not in k)
    assert set(ours) == set(theirs), name
    d = np.concatenate([np.abs(ours[k].numpy() - theirs[k].numpy()).ravel()
                        for k in keys])
    assert d.max() <= 2.2 * n_steps * LR, (name, float(d.max()))
    if bound_only:
        return
    assert d.mean() < 0.02 * LR, (name, float(d.mean()))
    assert float((d > 1e-6).mean()) < 0.01, name


def _collective_inputs(rng, hist_target):
    return dict(
        mu=rng.standard_normal((NB, NDIM)).astype(np.float32),
        logvar=(0.3 * rng.standard_normal((NB, NDIM))).astype(np.float32),
        mask=(rng.integers(0, 2, NB)).astype(np.float32),
        outputs=[rng.standard_normal((NB, 1, 4, 4)).astype(np.float32),
                 rng.standard_normal((NB, 1, 2, 2)).astype(np.float32)],
        target=hist_target, n_batch=NB,
        weights=LossWeights(KL=0.1, batch_KL=10.0, corr_enc=100.0,
                            hist=100.0))


def _instance_state(bn_trainer, bn_state, jmesh):
    """The instance-mode state of the same model from a batch-mode one:
    the same parameters less the flax ``BatchNorm`` layers (CBBNorm and
    CBINorm hold the same ones), fresh Adam, no statistics.  It spares the
    instance-mode init its own compile."""
    g = {k: v for k, v in bn_state.g_params.items()
         if not k.startswith("up_norm_")}
    e = {k: ({kk: vv for kk, vv in v.items() if kk not in ("norm1", "norm2")}
             if k.startswith("layers_") else v)
         for k, v in bn_state.e_params.items()}
    state = bn_state.replace(g_params=g, e_params=e,
                             g_opt=bn_trainer.tx.init(g),
                             e_opt=bn_trainer.tx.init(e),
                             g_stats=None, e_stats=None)
    return jax.device_put(state, NamedSharding(jmesh, P()))


def jax_draws(rng_key, k=1):
    """The JAX step's normal draws for ``encoded_feature="mu"``: the k
    latents, from ``jax.random.split(rng, k + 4)[:k]`` (``srgan_tpu/
    training/gan.py:440-462``), global (B, ndim) in every grad_sync mode
    (``:261-269``)."""
    keys = jax.random.split(rng_key, k + 4)
    return [np.asarray(jax.random.normal(keys[i], (B, NDIM), jnp.float32))
            for i in range(k)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One spawn of 2 ranks running every collective and every step case,
    and the JAX side: one mesh init and the mesh steps (with their own
    draws, which the port is handed)."""
    rng = np.random.default_rng(11)
    src = rng.integers(0, 4, B)
    batch = dict(image=rng.uniform(-1, 1, (B, HW, HW, 3)).astype(np.float32),
                 source_label=src.astype(np.int64),
                 target_label=((src + rng.integers(1, 4, B)) % 4)
                 .astype(np.int64))
    step_key = jax.random.PRNGKey(1)
    draws = jax_draws(step_key)
    jmesh = jax_make_mesh(2)
    jbatch = jax_shard_batch({k: jnp.asarray(v) for k, v in batch.items()},
                             jmesh)
    trainers = {name: JGANTrainer(_jax_cfg(norm_type), mesh=jmesh,
                                  donate=False, grad_sync=grad_sync)
                for name, (norm_type, grad_sync) in STEPS.items()}
    bn_state = trainers["batch_auto"].init_state(jax.random.PRNGKey(0),
                                                 image_size=HW)
    inits = {"batch": bn_state,
             "instance": _instance_state(trainers["batch_auto"], bn_state,
                                         jmesh)}
    cases = {}
    for name, (norm_type, grad_sync) in STEPS.items():
        jstate = inits[norm_type]
        start = _state_dicts(jstate, norm_type == "batch")
        cases[name] = dict(
            config=config_to_dict(trainers[name].cfg), grad_sync=grad_sync,
            draws=draws, g=start["G"], d=start["D"], e=start["E"],
            hist_target=np.asarray(jstate.hist_target), frozen=False,
            batch=batch)
    col = _collective_inputs(rng, np.asarray(bn_state.hist_target))
    # the ranks run while the JAX steps compile
    started = ranks.start(str(tmp_path_factory.mktemp("ranks")),
                          dict(collectives=col, steps=cases))
    jax_out = {}
    for name, (norm_type, _) in STEPS.items():
        post, metrics = trainers[name].step(inits[norm_type], jbatch,
                                            step_key)
        jax_out[name] = dict(metrics={k: float(v) for k, v in
                                      metrics.items()},
                             **_state_dicts(post, norm_type == "batch"))
    out = ranks.finish(started, timeout=240.0)
    return dict(out=out, jax=jax_out, cases=cases, col=col, jmesh=jmesh)


def _jax_collective(name, col, jmesh):
    """(value, gradients) of the JAX shard_map form on the 2-device mesh,
    differentiated with respect to its first ``n_diff`` arguments."""
    target = jnp.asarray(col["target"])
    mu, logvar = jnp.asarray(col["mu"]), jnp.asarray(col["logvar"])
    mask = jnp.asarray(col["mask"])
    outs = tuple(jnp.asarray(o) for o in col["outputs"])
    # name -> (fn, sharded args, replicated args, n_diff)
    fns = {
        "global_batch_kl": (
            lambda m: JC.global_batch_kl(m, col["n_batch"], "data"),
            (mu,), (), 1),
        "global_corrcoef_loss": (
            lambda m: JC.global_corrcoef_loss(m, "data"), (mu,), (), 1),
        "global_kl_loss": (
            lambda m, lv: JC.global_kl_loss(m, lv, "data"), (mu, logvar),
            (), 2),
        "global_histogram_imitation": (
            lambda m, t: JC.global_histogram_imitation(m, t, "data"),
            (mu,), (target,), 1),
        "global_masked_lsgan_loss": (
            lambda a, b, k: JC.global_masked_lsgan_loss([a, b], 1.0, k,
                                                        "data"),
            outs + (mask,), (), 2),
        "global_diversification_loss": (
            lambda m, lv, t: JC.global_diversification_loss(
                m, lv, weights=JLossWeights(KL=0.1),
                n_batch=col["n_batch"], hist_target=t, axis="data")[0],
            (mu, logvar), (target,), 2),
    }
    fn, sharded, replicated, n_diff = fns[name]
    specs = (P("data"),) * len(sharded) + (P(),) * len(replicated)
    f = shard_map(fn, mesh=jmesh, in_specs=specs, out_specs=P())
    v, g = jax.jit(jax.value_and_grad(f, argnums=tuple(range(n_diff))))(
        *sharded, *replicated)
    return float(v), [np.asarray(x) for x in g]


def _port_single(name, col):
    """(value, gradients) of the port's single-process loss."""
    target = torch.tensor(col["target"])
    mask = torch.tensor(col["mask"])
    fns = {
        "global_batch_kl": (lambda m: L.batch_kl_loss(m, col["n_batch"]),
                            (col["mu"],)),
        "global_corrcoef_loss": (lambda m: L.corrcoef_loss(m.T),
                                 (col["mu"],)),
        "global_kl_loss": (L.kl_loss, (col["mu"], col["logvar"])),
        "global_histogram_imitation": (
            lambda m: L.histogram_imitation_loss(m, target), (col["mu"],)),
        "global_masked_lsgan_loss": (
            lambda a, b: L.masked_lsgan_loss([a, b], 1.0, mask),
            tuple(col["outputs"])),
        "global_diversification_loss": (
            lambda m, lv: L.diversification_loss(
                m, lv, weights=col["weights"], n_batch=col["n_batch"],
                hist_target=target)[0], (col["mu"], col["logvar"])),
    }
    fn, arrays = fns[name]
    xs = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    v = fn(*xs)
    v.backward()
    return float(v.detach()), [x.grad.numpy() for x in xs]


@pytest.mark.parametrize("name", [
    "global_batch_kl", "global_corrcoef_loss", "global_kl_loss",
    "global_histogram_imitation", "global_masked_lsgan_loss",
    "global_diversification_loss"])
def test_collective_matches_shard_map_and_single_process(world, name):
    r0, r1 = (o["collectives"][name] for o in world["out"])
    assert r0[0] == r1[0]
    grads = [np.concatenate([a, b]) / 2 for a, b in zip(r0[1], r1[1])]
    for want_v, want_g in (_jax_collective(name, world["col"],
                                           world["jmesh"]),
                           _port_single(name, world["col"])):
        np.testing.assert_allclose(r0[0], want_v, rtol=1e-5, atol=1e-5)
        assert len(grads) == len(want_g)
        for got, want in zip(grads, want_g):
            # 1e-5 of the gradient's scale: the stack's 100x weights give
            # entries of about 50 beside ones of about 1
            scale = max(1.0, float(np.abs(want).max()))
            assert float(np.abs(got - want).max()) <= 1e-5 * scale, name


@pytest.mark.parametrize("name", sorted(STEPS))
def test_dp_step_matches_jax_mesh_step(world, name):
    o0, o1 = (o["steps"][name] for o in world["out"])
    want = world["jax"][name]
    assert o0["draws_used"] == 1
    assert o0["metrics"] == o1["metrics"]
    assert set(o0["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(o0["metrics"][k], v, rtol=RTOL,
                                   err_msg=k)
    for net in ("G", "D", "E"):
        for k in o0[net]:
            assert torch.equal(o0[net][k], o1[net][k]), (net, k)
    _assert_param_parity(o0["G"], want["G"], 2, "G", bound_only=True)
    _assert_param_parity(o0["D"], want["D"], 1, "D")
    _assert_param_parity(o0["E"], want["E"], 1, "E")
    running = [(net, k) for net in ("G", "E") for k in want[net]
               if "running" in k]
    assert bool(running) == (name == "batch_auto")
    for net, k in running:
        np.testing.assert_allclose(o0[net][k].numpy(), want[net][k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)
    if name == "auto":
        # one recipe for both values: the JAX manual step too
        for k, v in world["jax"]["manual"]["metrics"].items():
            np.testing.assert_allclose(o0["metrics"][k], v, rtol=RTOL,
                                       err_msg=k)


def _port_cfg(norm_type="instance"):
    return config_from_dict(config_to_dict(_jax_cfg(norm_type)))


def test_refusals(monkeypatch):
    cfg, bn = _port_cfg(), _port_cfg("batch")
    mesh = Mesh(rank=0, size=2, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="requires a mesh"):
        GANTrainer(cfg, "cpu", grad_sync="manual")
    with pytest.raises(ValueError, match="auto|manual"):
        GANTrainer(cfg, "cpu", mesh=mesh, grad_sync="nope")
    with pytest.raises(ValueError, match="batch"):
        GANTrainer(bn, "cpu", mesh=mesh, grad_sync="manual")
    monkeypatch.setenv("SRGAN_TPU_FUSED_DIV", "1")
    with pytest.raises(ValueError, match="single-device"):
        GANTrainer(cfg, "cpu", mesh=mesh)
    GANTrainer(cfg, "cpu")          # one device: the fused kernel's path
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        make_mesh("cpu")


def test_train_cli_mesh_without_a_group_raises(monkeypatch, tmp_path):
    from srgan_tpu_torch import train

    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="process group"):
        train.main(["--preset", "05_srgan_full", "--synthetic", "--device",
                    "cpu", "--out", str(out), "--mesh"])
    assert not out.exists()


@pytest.mark.parametrize("decode", ["native", "pil"])
def test_sharded_loader_gives_each_rank_its_rows(tmp_path, decode):
    from srgan_tpu_torch.data import native

    if decode == "native" and not native.available():
        pytest.skip(f"the native decoder does not build here: "
                    f"{native.build_error()}")
    root, attr = make_synthetic_celeba(str(tmp_path / "data"),
                                       n_per_class=4)

    def loader(mesh=None):
        ds = FaceDataset(root, attr_file=attr, train_num=16, val_num=0,
                         test_num=0, image_size=16, seed=3)
        return DataLoader(ds, batch_size=8, seed=5, num_workers=1,
                          decode=decode, mesh=mesh)

    whole = list(loader())
    meshes = [Mesh(rank=r, size=2, device=torch.device("cpu"),
                   backend="gloo") for r in range(2)]
    parts = [list(loader(m)) for m in meshes]
    assert len(whole) == len(parts[0]) == len(parts[1]) == 2
    for i, batch in enumerate(whole):
        for key, v in batch.items():
            got = np.concatenate([parts[0][i][key], parts[1][i][key]])
            np.testing.assert_array_equal(got, v, err_msg=key)
    # the feed's own slicing of global batches
    fed = list(prefetch_to_device(iter(whole), "cpu", mesh=meshes[1]))
    for i, batch in enumerate(whole):
        for key, v in shard_batch(batch, meshes[1]).items():
            np.testing.assert_array_equal(fed[i][key].numpy(), v)


def test_train_cli_under_torchrun_matches_one_process(tmp_path):
    """``torchrun --nproc_per_node 2 -m srgan_tpu_torch.train --mesh`` on
    the CPU (gloo) against ``train_gan`` on one process: the same
    metrics.jsonl, written by rank 0 alone, and a checkpoint.  The native
    decoder draws every flip on the loader's thread; PIL's eight workers
    draw theirs in thread order, which one process does not fix."""
    from srgan_tpu_torch.data import native
    from srgan_tpu_torch.training.loop import train_gan

    if not native.available():
        pytest.skip(f"the native decoder does not build here: "
                    f"{native.build_error()}")
    args = ["--preset", "03_srgan_nopretraining", "--synthetic",
            "--device", "cpu",
            "--decode", "native", "--batch-size", "8", "--unrolled-k", "1",
            "--epochs", "1", "--image-size", "32", "--g-nch", "8",
            "--d-nch", "8", "--e-nch", "8", "--g-res-num", "1",
            "--d-num-cls", "2", "--e-num-cls", "2", "--train-num", "16",
            "--synthetic-per-class", "8", "--no-sample-grids"]
    env = dict(os.environ, TMPDIR=str(tmp_path), OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    # both runs at once, each writing the seeded fixture into its own
    # folder: torchrun's ranks (under TMPDIR) and one process here
    dp, one = tmp_path / "dp", tmp_path / "one"
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "srgan_tpu_torch.train", *args,
         "--out", str(dp), "--mesh"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        cfg = config_from_dict(config_to_dict(_jax_cfg("instance")))
        cfg = dataclasses.replace(cfg, name="03_srgan_nopretraining",
                                  train=dataclasses.replace(
                                      cfg.train, train_num=16, test_num=4,
                                      epochs=1))
        train_gan(cfg, str(one), epochs=1, sample_grids=False,
                  synthetic_per_class=8, echo=False, device="cpu",
                  decode="native",
                  synthetic_dir_override=str(tmp_path / "one_data"))
        _, err = proc.communicate(timeout=150)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-4000:]
    with open(dp / "config.json") as f:
        assert config_from_dict(json.load(f)) == cfg
    assert os.path.isdir(dp / "ckpt" / "step_1")
    dp_rows = [json.loads(line) for line in open(dp / "metrics.jsonl")]
    one_rows = [json.loads(line) for line in open(one / "metrics.jsonl")]
    assert len(dp_rows) == len(one_rows) >= 1
    for a, b in zip(dp_rows, one_rows):
        assert a["step"] == b["step"]
        for k in ("errD", "errG", "errE", "errG_ex", "loss_hist"):
            assert a[k] == pytest.approx(b[k], rel=1e-4), k
