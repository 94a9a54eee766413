"""The port's SingleGenerator and Encoder against the JAX modules at a small
size (nch 8, res_num 2, e_num_cls 2, 32 px): JAX params from a seed,
carried over by the port's converters and loaded with strict=True.  fp32 on
the CPU; tolerance 1e-4 absolute, for sums in another order over 10+
layers.  The converters must agree with the JAX package's own torch
export."""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srgan_tpu.nn import Encoder as JEncoder
from srgan_tpu.nn import SingleGenerator as JGenerator
from srgan_tpu.utils.checkpoint import (
    export_torch_encoder,
    export_torch_generator,
)
from srgan_tpu_torch.nn.encoder import Encoder
from srgan_tpu_torch.nn.generator import SingleGenerator
from srgan_tpu_torch.utils.checkpoint import (
    encoder_state_dict_from_jax,
    generator_state_dict_from_jax,
)

ATOL = 1e-4
HW, NCH, RES, E_CLS, NUM_CON = 32, 8, 2, 2, 12


def _perturbed(params, seed):
    """Every leaf moved off its init (CBINorm's affine starts at 1 and 0,
    which would hide a swapped carry-over)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + np.float32(0.05) * rng.standard_normal(
            a.shape).astype(np.float32), jax.device_get(params))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (3, HW, HW, 3)).astype(np.float32)
    c = np.concatenate([np.eye(4, dtype=np.float32)[[0, 2, 3]],
                        rng.standard_normal((3, 8)).astype(np.float32)], 1)
    return x, c


@pytest.fixture(scope="module")
def generator_params(inputs):
    x, c = inputs
    jg = JGenerator(nch=NCH, res_num=RES, num_con=NUM_CON)
    params = _perturbed(jg.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                jnp.asarray(c))["params"], 1)
    return jg, params


@pytest.fixture(scope="module")
def encoder_params(inputs):
    x, _ = inputs
    je = JEncoder(nch=NCH, num_cls=E_CLS, num_con=4)
    params = _perturbed(je.init({"params": jax.random.PRNGKey(1),
                                 "reparam": jax.random.PRNGKey(2)},
                                jnp.asarray(x), sample=False)["params"], 3)
    return je, params


def test_generator_forward_matches_jax(inputs, generator_params):
    x, c = inputs
    jg, params = generator_params
    want = jg.apply({"params": params}, jnp.asarray(x), jnp.asarray(c))
    G = SingleGenerator(nch=NCH, res_num=RES, num_con=NUM_CON)
    G.load_state_dict(generator_state_dict_from_jax(params, 2, RES),
                      strict=True)
    with torch.no_grad():
        out = G(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                torch.from_numpy(c))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=ATOL, rtol=0)


def test_encoder_forward_matches_jax(inputs, encoder_params):
    x, _ = inputs
    je, params = encoder_params
    _, mu, logvar, cls_out, _ = je.apply(
        {"params": params}, jnp.asarray(x), sample=False,
        rngs={"reparam": jax.random.PRNGKey(0)})
    E = Encoder(nch=NCH, num_cls=E_CLS, num_con=4)
    E.load_state_dict(encoder_state_dict_from_jax(params, E_CLS), strict=True)
    with torch.no_grad():
        got = E(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    for g, w in zip(got, (mu, logvar, cls_out)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("net", ["generator", "encoder"])
def test_converter_equals_the_jax_packages_torch_export(net, request):
    if net == "generator":
        _, params = request.getfixturevalue("generator_params")
        ours = generator_state_dict_from_jax(params, 2, RES)
        theirs = export_torch_generator(params, 2, RES)
    else:
        _, params = request.getfixturevalue("encoder_params")
        ours = encoder_state_dict_from_jax(params, E_CLS)
        theirs = export_torch_encoder(params, E_CLS, conditional=False)
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k], err_msg=k)
