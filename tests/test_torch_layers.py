"""The port's layers (srgan_tpu_torch/nn/layers.py) against the JAX modules
of srgan_tpu/nn/layers.py, with the JAX parameters carried over by the
port's converters and NHWC <-> NCHW transposes.  fp32 on the CPU; tolerance
1e-5 absolute."""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srgan_tpu.nn import layers as J
from srgan_tpu_torch.nn import layers as T
from srgan_tpu_torch.utils.checkpoint import (
    _inv_conv_w,
    _inv_convT_w,
    _inv_lin_w,
)

ATOL = 1e-5


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(y):
    return y.detach().numpy().transpose(0, 2, 3, 1)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("cin,cout,k,s,p,hw,bias,mode", [
    (4, 6, 3, 1, 1, 8, False, "zeros"),
    (4, 6, 3, 1, 1, 8, False, "reflect"),
    (4, 8, 4, 2, 1, 8, False, "zeros"),     # generator down conv
    (3, 8, 7, 2, 1, 17, True, "zeros"),     # encoder stem, odd output
    # 7x7 -> 3 channels: JAX takes its space-to-depth path here
    (8, 3, 7, 1, 3, 16, False, "zeros"),
])
def test_conv2d(cin, cout, k, s, p, hw, bias, mode):
    x = _x((2, hw, hw, cin))
    jm = J.Conv2d(cout, k, s, p, use_bias=bias, padding_mode=mode)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = jm.apply({"params": params}, jnp.asarray(x))

    tm = T.Conv2d(cin, cout, k, s, p, bias=bias, padding_mode=mode)
    sd = {"weight": _t(_inv_conv_w(params["kernel"]))}
    if bias:
        sd["bias"] = _t(params["bias"])
    tm.load_state_dict(sd, strict=True)
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), np.asarray(want),
                               atol=ATOL, rtol=0)


def test_conv_transpose2d_undoes_the_pre_flip():
    x = _x((2, 8, 8, 8))
    jm = J.ConvTranspose2d(4, 4, 2, 1, use_bias=False)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = jm.apply({"params": params}, jnp.asarray(x))
    tm = T.ConvTranspose2d(8, 4, 4, 2, 1, bias=False)
    tm.load_state_dict({"weight": _t(_inv_convT_w(params["kernel"]))},
                       strict=True)
    out = _nhwc(tm(_nchw(x)))
    assert out.shape == (2, 16, 16, 4)
    np.testing.assert_allclose(out, np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("window,stride,pad,incl", [
    (3, 2, 1, False),   # reference model.py:286
    (3, 2, 1, True),
    (2, 2, 0, True),    # encoder blocks
])
def test_avg_pool2d(window, stride, pad, incl):
    x = _x((2, 9, 9, 4))
    want = J.avg_pool2d(jnp.asarray(x), window, stride, pad, incl)
    out = T.avg_pool2d(_nchw(x), window, stride, pad, incl)
    np.testing.assert_allclose(_nhwc(out), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_adaptive_avg_pool():
    x = _x((2, 7, 7, 6))
    want = J.adaptive_avg_pool(jnp.asarray(x))
    np.testing.assert_allclose(T.adaptive_avg_pool(_nchw(x)).numpy(),
                               np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("relu", [False, True])
def test_cbinorm(relu):
    x = _x((2, 6, 6, 8)) * 2
    cond = _x((2, 12), seed=1)
    jm = J.CBINorm(8)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x),
                     jnp.asarray(cond))["params"]
    # move the affine off its (1, 0) init so that its carry-over is checked
    rng = np.random.default_rng(3)
    params = {**params,
              "scale": jnp.asarray(rng.uniform(0.5, 1.5, 8), jnp.float32),
              "bias": jnp.asarray(rng.standard_normal(8), jnp.float32)}
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(cond),
                    relu=relu)

    tm = T.CBINorm(8, 12)
    tm.load_state_dict({
        "ConBias.0.weight": _t(_inv_lin_w(params["con_bias"]["kernel"])),
        "ConBias.0.bias": _t(params["con_bias"]["bias"]),
        "weight": _t(params["scale"]),
        "bias": _t(params["bias"]),
    }, strict=True)
    out = tm(_nchw(x), torch.from_numpy(cond), relu=relu)
    np.testing.assert_allclose(_nhwc(out), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_init_torch_default_draws_from_the_generator():
    m = torch.nn.Sequential(T.Conv2d(4, 8, 3), T.ConvTranspose2d(8, 2, 4),
                            T.Linear(5, 3), T.CBINorm(8, 5))
    a = T.init_torch_default_(m, torch.Generator().manual_seed(0))
    a = {k: v.clone() for k, v in a.state_dict().items()}
    b = T.init_torch_default_(m, torch.Generator().manual_seed(0)).state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    # torch's bound: 1/sqrt(fan_in), fan_in from the weight's own shape
    assert a["0.weight"].abs().max() <= 1 / np.sqrt(4 * 9)
    assert a["1.weight"].abs().max() <= 1 / np.sqrt(2 * 16)
    assert torch.equal(a["3.weight"], torch.ones(8))
    assert torch.equal(a["3.bias"], torch.zeros(8))
