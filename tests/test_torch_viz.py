"""The port's visualisation module and its CLIs (``srgan_tpu_torch/utils/
viz.py``, ``sample_sweep.py``, ``plot_losses.py``, the loop's grids)
against ``srgan_tpu/utils/viz.py`` on the CPU, at the size of
``tests/test_viz.py`` (32 px, g/e_nch 8, g_res_num 1, e_num_cls 2), for the
unconditional encoder (srgan) and the conditional one (singlegan_solo).

Both sides hold the same weights (the JAX init, carried over by the port's
converters) and the same latents: the sweep's, and the progress grid's four
drawn in the test from the JAX function's key split.  Arrays agree within
1e-4 absolute, the serving tolerance (tests/test_torch_serving.py); the
figures have the JAX figures' axes, titles and scales; the GIFs decode to
the same frames; the loop writes the JAX loop's PNG names.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from srgan_tpu.configs import ExperimentConfig as JExperimentConfig
from srgan_tpu.configs import LossWeights as JLossWeights
from srgan_tpu.configs import ModelConfig as JModelConfig
from srgan_tpu.configs import TrainConfig as JTrainConfig
from srgan_tpu.configs import config_to_dict
from srgan_tpu.training import GANTrainer as JGANTrainer
from srgan_tpu.training import loop as jloop
from srgan_tpu.utils import viz as jviz
from srgan_tpu_torch import plot_losses, sample_sweep
from srgan_tpu_torch.configs import config_from_dict, save_config
from srgan_tpu_torch.data import FaceDataset, make_synthetic_celeba
from srgan_tpu_torch.data.dataset import LABEL_DESCRIPTION
from srgan_tpu_torch.training import loop
from srgan_tpu_torch.training.gan import GANTrainer
from srgan_tpu_torch.utils import viz
from srgan_tpu_torch.utils.checkpoint import (
    encoder_original_state_dict_from_jax,
    encoder_state_dict_from_jax,
    generator_state_dict_from_jax,
    save_checkpoint,
)

ATOL = 1e-4
HW = 32
TRAINERS = ("srgan", "singlegan_solo")


def _jcfg(trainer, name="viz", hw=HW, **train):
    model = JModelConfig(image_size=hw, g_nch=8, g_res_num=1, d_nch=8,
                         d_num_cls=2, e_nch=8, e_num_cls=2)
    return JExperimentConfig(
        name=name, model=model,
        train=JTrainConfig(**{**dict(batch_size=4, unrolled_k=1), **train}),
        loss=JLossWeights.proposed_kl(cls=1.0), trainer=trainer)


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    img_root, attr_file = make_synthetic_celeba(
        str(tmp_path_factory.mktemp("viz")), n_per_class=6)
    return FaceDataset(img_root, attr_file=attr_file, data_type="test",
                       train_num=4, val_num=0, test_num=2, image_size=HW)


@pytest.fixture(scope="module")
def worlds():
    """trainer -> (JAX trainer, JAX state, port trainer, port state) with
    the same G and E."""
    out = {}
    for trainer in TRAINERS:
        jcfg = _jcfg(trainer)
        jt = JGANTrainer(jcfg, donate=False)
        js = jt.init_state(jax.random.PRNGKey(0), image_size=HW)
        g, e = jax.device_get((js.g_params, js.e_params))
        e_sd = (encoder_state_dict_from_jax(e, 2) if trainer == "srgan"
                else encoder_original_state_dict_from_jax(e, 2))
        pt = GANTrainer(config_from_dict(config_to_dict(jcfg)), device="cpu")
        ps = pt.init_state(g_state=generator_state_dict_from_jax(g, 2, 1),
                           e_state=e_sd,
                           hist_target=np.asarray(js.hist_target))
        out[trainer] = (jt, js, pt, ps)
    return out


@pytest.mark.parametrize("trainer", TRAINERS)
def test_get_samples_matches_jax(worlds, ds, trainer):
    jt, js, pt, ps = worlds[trainer]
    latent = np.random.default_rng(0).standard_normal((5, 8)) \
        .astype(np.float32)
    for lat in (latent, [latent[:2]] * 4):
        want_d, want_l = jviz.get_samples(jt, js, ds, 0, lat, batch=2)
        got_d, got_l = viz.get_samples(pt, ps, ds, 0, lat, batch=2)
        np.testing.assert_array_equal(got_d["source"], want_d["source"])
        np.testing.assert_array_equal(got_l["source"], want_l["source"])
        assert set(got_d["target"]) == set(want_d["target"]) == {0, 1, 2, 3}
        for cls in range(4):
            np.testing.assert_allclose(got_d["target"][cls],
                                       np.asarray(want_d["target"][cls]),
                                       atol=ATOL, rtol=0)
            np.testing.assert_allclose(got_l["latent"][cls],
                                       np.asarray(want_l["latent"][cls]),
                                       atol=ATOL, rtol=0)


def _jax_panels(jt, js, img, label, n, rng):
    """The JAX grid's images, computed as srgan_tpu/utils/viz.py:29-62
    computes them, and its four latents."""
    src = jnp.asarray(img)[None]
    src_label = np.array([label])
    tgt_all = [c for c in range(4) if c != label]
    tgt_label = np.array([tgt_all[0]])
    k1, k2, k3, k4 = jax.random.split(rng, 4)
    lat = [jax.random.normal(k, (m, 8), jnp.float32)
           for k, m in ((k1, n), (k2, len(tgt_all)), (k3, n), (k4, n))]
    style = jt.encode(js, src, src_label)[0]

    def tr(x, labels, latent):
        return np.asarray(jt.transform(js, x, labels, latent=latent)[0])

    rep = jnp.tile(src, (n, 1, 1, 1))
    tgt_rand = tr(rep, np.repeat(tgt_label, n), lat[0])
    panels = dict(
        source=np.asarray(src), tgt_by_src=tr(src, tgt_label, style),
        recon=tr(tgt_rand[:1], src_label, style), tgt_rand=tgt_rand,
        idt=tr(src, src_label, style),
        trans=tr(jnp.tile(src, (3, 1, 1, 1)), np.array(tgt_all), lat[1]),
        recon_rand=tr(jnp.tile(tgt_rand[:1], (n, 1, 1, 1)),
                      np.repeat(src_label, n), lat[2]),
        idt_rand=tr(rep, np.repeat(src_label, n), lat[3]),
        targets=np.array(tgt_all))
    return panels, [np.asarray(v) for v in lat]


@pytest.mark.parametrize("trainer", TRAINERS)
def test_progress_panels_match_jax(worlds, ds, trainer):
    jt, js, pt, ps = worlds[trainer]
    img, label = ds[0]
    want, lat = _jax_panels(jt, js, img, label, 2, jax.random.PRNGKey(0))
    got = viz.progress_panels(pt, ps, img, label, (0, 1, 2, 3), 2,
                              latents=lat)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        np.testing.assert_allclose(got[k], v, atol=ATOL, rtol=0, err_msg=k)
    # drawn from a generator: seeded, the four shapes of the JAX split
    a = viz.progress_panels(pt, ps, img, label, (0, 1, 2, 3), 2,
                            generator=torch.Generator().manual_seed(3))
    b = viz.progress_panels(pt, ps, img, label, (0, 1, 2, 3), 2,
                            generator=torch.Generator().manual_seed(3))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def _layout(fig):
    return [(ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
             ax.get_yscale()) for ax in fig.axes]


def test_figures_have_the_jax_layout(worlds, ds, tmp_path):
    jt, js, pt, ps = worlds["singlegan_solo"]
    want = jviz.training_progress_grid(jt, js, ds, 0, LABEL_DESCRIPTION,
                                       random_sample_num=2)
    got = viz.training_progress_grid(pt, ps, ds, 0, LABEL_DESCRIPTION,
                                     random_sample_num=2)
    assert len(got.axes) == len(want.axes) == 4 + 3 + 3 * 2
    assert _layout(got) == _layout(want)
    got.savefig(tmp_path / "grid.png")
    assert (tmp_path / "grid.png").stat().st_size > 0

    rows = [{"step": s, "errD": 1.0 / (s + 1), "errG": 2.0 / (s + 1),
             "errE": 100.0 / (s + 1), "loss_cycle": 0.5 / (s + 1),
             "loss_hist": 40.0 / (s + 1)} for s in range(10)]
    signed = [{"step": 0, "errD": 0.0, "loss_x": 1.0},
              {"step": 1, "errD": -0.5, "loss_x": 0.5}]
    for metrics in (rows, [{"step": 0, "errD": 1.0}], signed):
        assert _layout(viz.plot_loss_curves(metrics)) == \
            _layout(jviz.plot_loss_curves(metrics))
    with pytest.raises(ValueError):
        viz.plot_loss_curves([])
    cm = np.array([[8, 1], [2, 9]])
    assert _layout(viz.plot_confusion_matrix(cm, ["a", "b"])) == \
        _layout(jviz.plot_confusion_matrix(cm, ["a", "b"]))
    corr = np.corrcoef(np.random.default_rng(0).standard_normal((4, 50)))
    fig = viz.plot_correlation_matrix(corr, save_path=str(tmp_path / "c.png"))
    assert _layout(fig) == _layout(jviz.plot_correlation_matrix(corr))
    assert [t.get_text() for t in fig.axes[0].texts] == \
        [str(round(float(v), 4)) for v in corr.ravel()]
    import matplotlib.pyplot as plt
    plt.close("all")


def test_save_gif_frames_match_jax(tmp_path):
    imgs = np.random.default_rng(0).uniform(-1, 1, (4, HW, HW, 3)) \
        .astype(np.float32)
    viz.save_gif(imgs, str(tmp_path / "port.gif"))
    jviz.save_gif(imgs, str(tmp_path / "jax.gif"))

    def frames(path):
        out = []
        with Image.open(path) as g:
            for i in range(g.n_frames):
                g.seek(i)
                out.append(np.asarray(g.convert("RGB")))
        return out

    got, want = frames(tmp_path / "port.gif"), frames(tmp_path / "jax.gif")
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_sample_sweep_and_plot_losses_clis(worlds, tmp_path, monkeypatch):
    """``sample_sweep`` on a port checkpoint holding the JAX weights: its
    latent_mu_class*.npy equal the JAX get_samples' mu for the script's
    latents; its GIFs have one frame a latent; the grid PNG is written."""
    jt, js, pt, ps = worlds["singlegan_solo"]
    run = tmp_path / "run"
    save_config(pt.cfg, str(run))
    save_checkpoint(str(run / "ckpt"), ps, step=3)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    out = tmp_path / "sweep"
    sample_sweep.main(["--ckpt", str(run / "ckpt"), "--out", str(out),
                       "--synthetic", "--num-latents", "3", "--device",
                       "cpu"])
    img_root, attr_file = make_synthetic_celeba(
        str(tmp_path / "srgan_tpu_torch_synthetic"), n_per_class=16)
    test_ds = FaceDataset(img_root, attr_file=attr_file, data_type="test",
                          train_num=pt.cfg.train.train_num, val_num=0,
                          test_num=pt.cfg.train.test_num, image_size=HW)
    latent = np.random.default_rng(0).standard_normal((3, 8)) \
        .astype(np.float32)
    _, want = jviz.get_samples(jt, js, test_ds, 0, latent)
    for cls in range(4):
        np.testing.assert_allclose(
            np.load(out / f"latent_mu_class{cls}.npy"),
            np.asarray(want["latent"][cls]), atol=ATOL, rtol=0)
        with Image.open(out / f"index0_class{cls}.gif") as g:
            assert g.n_frames == 3
    assert (out / "result_index0_grid.png").stat().st_size > 0

    log = tmp_path / "metrics.jsonl"
    log.write_text("".join(json.dumps({"step": s, "errD": 1.0 / (s + 1),
                                       "loss_idt": 0.5}) + "\n"
                           for s in range(4)))
    plot_losses.main(["--metrics", str(log), "--out",
                      str(tmp_path / "losses.png")])
    assert (tmp_path / "losses.png").stat().st_size > 0


def test_loop_writes_the_jax_loops_grid_names(tmp_path, monkeypatch):
    """The tiny run of tests/test_loop.py (64 px, 10 images a class, 4
    steps an epoch, a log and a grid at each step), 2 epochs: with
    grid_every_epochs=2 both loops write epoch 0's grids only, under the
    same names; with 1 the port writes both epochs'.  The port's
    grid_every_epochs=2 run draws its grids; the other two runs, which
    check names only, draw a one-axes stand-in."""
    jcfg = _jcfg("srgan", name="loop_tiny", hw=64, batch_size=8,
                 encoded_feature="mu", train_num=8, val_num=0, test_num=2)
    cfg = config_from_dict(config_to_dict(jcfg))
    data = make_synthetic_celeba(str(tmp_path / "data"), n_per_class=10)
    common = dict(data_root=data[0], attr_file=data[1], epochs=2,
                  sample_grids=True, echo=False)
    port = dict(common, device="cpu", decode="pil")
    loop.train_gan(cfg, str(tmp_path / "port2"), grid_every_epochs=2, **port)

    def stand_in(*a, **k):
        import matplotlib.pyplot as plt
        fig = plt.figure(figsize=(1, 1))
        fig.add_subplot(1, 1, 1)
        return fig

    monkeypatch.setattr(jviz, "training_progress_grid", stand_in)
    monkeypatch.setattr(viz, "training_progress_grid", stand_in)
    jloop.train_gan(jcfg, str(tmp_path / "jax"), grid_every_epochs=2,
                    **common)
    loop.train_gan(cfg, str(tmp_path / "port1"), **port)

    def names(d):
        return sorted(p for p in os.listdir(tmp_path / d)
                      if p.endswith(".png"))

    want = names("jax")
    assert want == [f"progress_e000_i{i:05d}.png" for i in range(4)]
    assert names("port2") == want
    assert names("port1") == want + [f"progress_e001_i{i:05d}.png"
                                     for i in range(4)]
