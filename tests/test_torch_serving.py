"""The port's serving path (srgan_tpu_torch/serving.py) against the JAX
GANTrainer's inference surface with the same weights, carried over by the
port's converters, and the same explicit latents.  fp32 on the CPU;
tolerance 1e-4 absolute, as for the models."""

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
from srgan_tpu_torch.configs import config_from_dict, load_config_for_ckpt
from srgan_tpu_torch.serving import (
    Translator,
    decode_npz,
    encode_npz,
    handle_request,
)
from srgan_tpu_torch.utils.checkpoint import (
    encoder_state_dict_from_jax,
    generator_state_dict_from_jax,
)

ATOL = 1e-4
HW = 32
N = 7          # above the largest warm size: chunks of 4 + 3
WARM = (2, 4)


def _jax_cfg() -> ExperimentConfig:
    # the configuration of tests/test_serving.py, so JAX compiles are shared
    model = ModelConfig(image_size=HW, g_nch=8, g_res_num=1, d_nch=8,
                        d_num_cls=2, e_nch=8, e_num_cls=2)
    train = TrainConfig(batch_size=8, unrolled_k=1, encoded_feature="mu")
    return ExperimentConfig(name="serve_tiny", model=model, train=train,
                            loss=LossWeights.proposed_kl(cls=1.0),
                            trainer="srgan")


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
