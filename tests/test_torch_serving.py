"""The port's serving path (srgan_tpu_torch/serving.py, serve.py) against
the JAX GANTrainer's inference surface with the same weights, carried over
by the port's converters, and the same explicit latents, for the srgan
trainer's encoder and the SingleGAN trainers' conditional one.  fp32 on
the CPU; tolerance 1e-4 absolute, as for the models.  ``serve`` finds the
config of a training run from its checkpoint directory."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from srgan_tpu.configs import (
    ExperimentConfig,
    LossWeights,
    ModelConfig,
    TrainConfig,
    config_to_dict,
)
from srgan_tpu.training import GANTrainer
from srgan_tpu_torch import serve
from srgan_tpu_torch.configs import (
    PRESETS,
    config_from_dict,
    load_config_for_ckpt,
)
from srgan_tpu_torch.data import make_synthetic_celeba
from srgan_tpu_torch.serving import (
    Translator,
    decode_npz,
    encode_npz,
    handle_request,
)
from srgan_tpu_torch.training.loop import train_gan
from srgan_tpu_torch.utils.checkpoint import (
    encoder_original_state_dict_from_jax,
    encoder_state_dict_from_jax,
    generator_state_dict_from_jax,
)

ATOL = 1e-4
HW = 32
N = 7          # above the largest warm size: chunks of 4 + 3
WARM = (2, 4)


def _jax_cfg(trainer="srgan") -> ExperimentConfig:
    # the configuration of tests/test_serving.py, so JAX compiles are shared
    model = ModelConfig(image_size=HW, g_nch=8, g_res_num=1, d_nch=8,
                        d_num_cls=2, e_nch=8, e_num_cls=2)
    train = TrainConfig(batch_size=8, unrolled_k=1, encoded_feature="mu")
    return ExperimentConfig(name="serve_tiny", model=model, train=train,
                            loss=LossWeights.proposed_kl(cls=1.0),
                            trainer=trainer)


@pytest.fixture(scope="module")
def world():
    jcfg = _jax_cfg()
    trainer = GANTrainer(jcfg, donate=False)
    state = trainer.init_state(jax.random.PRNGKey(0), image_size=HW)
    m = jcfg.model
    g_sd = generator_state_dict_from_jax(jax.device_get(state.g_params),
                                         m.g_num_cls, m.g_res_num)
    e_sd = encoder_state_dict_from_jax(jax.device_get(state.e_params),
                                       m.e_num_cls)
    cfg = config_from_dict(config_to_dict(jcfg))
    tr = Translator.from_state_dicts(cfg, g_sd, e_sd, device="cpu",
                                     warm_batch_sizes=WARM)
    rng = np.random.default_rng(0)
    data = dict(images=rng.uniform(-1, 1, (N, HW, HW, 3)).astype(np.float32),
                labels=rng.integers(0, 4, N),
                latent=rng.standard_normal((N, m.ndim)).astype(np.float32))
    return trainer, state, cfg, g_sd, e_sd, tr, data


def test_config_parses_as_the_jax_package_writes_it(world, tmp_path):
    trainer, _, cfg, *_ = world
    assert dataclasses.asdict(cfg) == config_to_dict(trainer.cfg)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(config_to_dict(trainer.cfg), f)
    assert load_config_for_ckpt(str(tmp_path)) == cfg


@pytest.mark.parametrize("latent_kind", ["per_image", "one_for_all"])
def test_translate_matches_jax(world, latent_kind):
    trainer, state, _, _, _, tr, d = world
    lat = d["latent"] if latent_kind == "per_image" else d["latent"][0]
    want, want_lat = trainer.transform(state, d["images"], d["labels"],
                                       latent=lat)
    fakes, used = tr.translate(d["images"], d["labels"], latent=lat)
    assert fakes.shape == (N, HW, HW, 3)
    np.testing.assert_allclose(fakes, np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(used, np.asarray(want_lat))


def test_encode_matches_jax(world):
    trainer, state, _, _, _, tr, d = world
    mu, logvar, _ = trainer.encode(state, d["images"])
    out = tr.encode(d["images"])
    np.testing.assert_allclose(out["mu"], np.asarray(mu), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out["logvar"], np.asarray(logvar), atol=ATOL,
                               rtol=0)


def test_weights_dir_and_seeded_latent(world, tmp_path):
    _, _, cfg, g_sd, e_sd, tr, d = world
    torch.save(g_sd, tmp_path / "generator.pth")
    torch.save(e_sd, tmp_path / "encoder.pth")
    tr2 = Translator(cfg, str(tmp_path), device="cpu", warm_batch_sizes=WARM,
                     warmup=False)
    a, lat_a = tr.translate(d["images"], d["labels"], seed=5)
    b, lat_b = tr2.translate(d["images"], d["labels"], seed=5)
    assert lat_a.shape == (N, cfg.model.ndim)
    np.testing.assert_array_equal(lat_a, lat_b)
    np.testing.assert_array_equal(a, b)


def test_handle_request_round_trips_npz(world):
    _, _, _, _, _, tr, d = world
    code, body = handle_request(tr, "/translate", encode_npz(
        images=d["images"], target_labels=d["labels"], latent=d["latent"]))
    assert code == 200
    out = decode_npz(body)
    want, _ = tr.translate(d["images"], d["labels"], latent=d["latent"])
    np.testing.assert_array_equal(out["fakes"], want)
    np.testing.assert_array_equal(out["latent"], d["latent"])

    code, body = handle_request(tr, "/encode",
                                encode_npz(images=d["images"]))
    assert code == 200
    np.testing.assert_array_equal(decode_npz(body)["mu"],
                                  tr.encode(d["images"])["mu"])

    assert handle_request(tr, "/nope", b"")[0] == 404
    code, body = handle_request(tr, "/translate", encode_npz(
        images=d["images"], target_labels=np.full(N, 9)))
    assert code == 400 and body


def test_bfloat16_compute_dtype_runs_the_same_model(world):
    _, _, cfg, g_sd, e_sd, tr, d = world
    cfg16 = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, compute_dtype="bfloat16"))
    tr16 = Translator.from_state_dicts(cfg16, g_sd, e_sd, device="cpu",
                                       warm_batch_sizes=WARM, warmup=False)
    want, _ = tr.translate(d["images"], d["labels"], latent=d["latent"])
    got, _ = tr16.translate(d["images"], d["labels"], latent=d["latent"])
    assert got.dtype == np.float32
    # convs in bf16 (8 bits of mantissa) through the generator, norm
    # statistics in fp32
    np.testing.assert_allclose(got, want, atol=0.1, rtol=0)
    assert np.abs(got - want).mean() < 0.01


def test_cuda_translator_raises_without_cuda(world):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    _, _, cfg, g_sd, e_sd, _, _ = world
    with pytest.raises(RuntimeError, match="CUDA"):
        Translator.from_state_dicts(cfg, g_sd, e_sd, device="cuda")


def test_conditional_encoder_serves_with_labels(world):
    """A SingleGAN (02_singlegan_solod) model: /encode takes the images'
    labels, as srgan_tpu/serving.py:118-134 and :171-173 do, and matches the
    JAX trainer's encode; without labels the request fails (400)."""
    d = world[-1]
    jcfg = _jax_cfg("singlegan_solo")
    trainer = GANTrainer(jcfg, donate=False)
    state = trainer.init_state(jax.random.PRNGKey(0), image_size=HW)
    m = jcfg.model
    g_sd = generator_state_dict_from_jax(jax.device_get(state.g_params),
                                         m.g_num_cls, m.g_res_num)
    e_sd = encoder_original_state_dict_from_jax(
        jax.device_get(state.e_params), m.e_num_cls)
    tr = Translator.from_state_dicts(config_from_dict(config_to_dict(jcfg)),
                                     g_sd, e_sd, device="cpu",
                                     warm_batch_sizes=WARM)
    mu, logvar, cls = trainer.encode(state, d["images"], d["labels"])
    assert cls is None
    code, body = handle_request(tr, "/encode", encode_npz(
        images=d["images"], labels=d["labels"]))
    assert code == 200
    out = decode_npz(body)
    np.testing.assert_allclose(out["mu"], np.asarray(mu), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out["logvar"], np.asarray(logvar), atol=ATOL,
                               rtol=0)
    code, body = handle_request(tr, "/encode",
                                encode_npz(images=d["images"]))
    assert code == 400 and b"labels" in body
    want, _ = trainer.transform(state, d["images"], d["labels"],
                                latent=d["latent"])
    got, _ = tr.translate(d["images"], d["labels"], latent=d["latent"])
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


def test_serve_finds_the_config_of_a_training_run(tmp_path):
    """ROADMAP C1: a run trained with widths no preset has (g_nch 8) is
    served from its ckpt directory with no --preset: the config found is
    the run's, and the latest step's weights load strictly."""
    cfg = PRESETS["02_singlegan_solod"]()
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, image_size=HW, g_nch=8,
                                       g_res_num=1, d_nch=8, d_num_cls=2,
                                       e_nch=8, e_num_cls=2),
        train=dataclasses.replace(cfg.train, batch_size=8, unrolled_k=1,
                                  train_num=8, test_num=2))
    img_root, attr_file = make_synthetic_celeba(str(tmp_path / "data"),
                                                n_per_class=10)
    run = tmp_path / "run"
    _, state = train_gan(cfg, str(run), data_root=img_root,
                         attr_file=attr_file, epochs=1, sample_grids=False,
                         echo=False, device="cpu", decode="pil")
    tr = serve.build_translator(serve.parse_args(
        ["--ckpt", str(run / "ckpt"), "--device", "cpu",
         "--warm-batch-sizes", "2"]))
    assert tr.cfg == cfg
    for key, v in state.G.state_dict().items():
        assert torch.equal(tr.G.state_dict()[key], v), key
    # a bare weights dir inside the run finds the run's config.json too
    args = serve.parse_args(["--weights", str(run / "ckpt" / "step_1"),
                             "--device", "cpu", "--warm-batch-sizes", "2"])
    assert serve.build_translator(args).cfg == cfg
    with pytest.raises(FileNotFoundError, match="step_N"):
        serve.build_translator(serve.parse_args(
            ["--ckpt", str(tmp_path / "none"), "--device", "cpu"]))
    with pytest.raises(SystemExit):
        serve.parse_args(["--weights", str(run), "--ckpt-step", "1"])
