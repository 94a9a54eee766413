"""The port's solo discriminator (``srgan_tpu_torch/nn/discriminator.py``)
against the JAX ``SingleDiscriminatorSoloMulti`` at a small size (d_nch 8,
d_num_cls 3, 32 px, class kernels (4, 2) as the trainer sizes them): JAX
params from a seed, carried over by the port's converter and loaded with
strict=True.  fp32 on the CPU; tolerance 1e-4 absolute for sums in another
order over four conv layers.  The converter must agree with the JAX
package's own torch export."""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srgan_tpu.nn import SingleDiscriminatorSoloMulti as JDiscriminator
from srgan_tpu.utils.checkpoint import export_torch_solo_discriminator
from srgan_tpu_torch.configs import (
    ExperimentConfig,
    LossWeights,
    ModelConfig,
    TrainConfig,
)
from srgan_tpu_torch.training import gan
from srgan_tpu_torch.utils.checkpoint import (
    solo_discriminator_state_dict_from_jax,
)

ATOL = 1e-4
HW, NCH, NUM_CLS = 32, 8, 3
CFG = ExperimentConfig(
    name="t", model=ModelConfig(image_size=HW, d_nch=NCH, d_num_cls=NUM_CLS),
    train=TrainConfig(), loss=LossWeights())


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (3, HW, HW, 3)).astype(np.float32)
    jd = JDiscriminator(nch=NCH, num_cls=NUM_CLS, n_class=4,
                        cls_kernels=(HW // 2 ** NUM_CLS, HW // 2 ** NUM_CLS
                                     // 2))
    params = jax.device_get(jd.init(jax.random.PRNGKey(3),
                                    jnp.asarray(x))["params"])
    return jd, params, x


def test_converter_matches_jax_export(setup):
    _, params, _ = setup
    got = solo_discriminator_state_dict_from_jax(params, num_cls=NUM_CLS)
    want = export_torch_solo_discriminator(params, num_cls=NUM_CLS)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), k)
    D = gan.build_discriminator(CFG, "cpu", state_dict=got)   # strict=True
    assert set(D.state_dict()) == set(want)


def test_forward_matches_jax(setup):
    jd, params, x = setup
    (ja1, ja2), (jc1, jc2) = jd.apply({"params": params}, jnp.asarray(x))
    D = gan.build_discriminator(
        CFG, "cpu", state_dict=solo_discriminator_state_dict_from_jax(
            params, num_cls=NUM_CLS))
    with torch.no_grad():
        adv, cls = D(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    for got, want in zip(adv, (ja1, ja2)):
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                                   np.asarray(want), atol=ATOL, rtol=0)
    for got, want in zip(cls, (jc1, jc2)):
        assert got.dtype == torch.float32 and got.shape == (3, 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


def test_default_init_is_seeded():
    a = gan.build_discriminator(CFG, "cpu", torch.Generator().manual_seed(5))
    b = gan.build_discriminator(CFG, "cpu", torch.Generator().manual_seed(5))
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
