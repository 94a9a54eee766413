"""The port's conditional instance norm (srgan_tpu_torch/ops/norm.py) on the
CPU against the JAX package: the Pallas kernel run in interpret mode, the
jnp CBINorm branch and the jnp instance norm.  fp32; tolerance 1e-5 absolute
(sums taken in another order over at most 64 elements)."""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srgan_tpu.nn.layers import instance_norm as jax_instance_norm
from srgan_tpu.ops.pallas.norm import _fused_fwd
from srgan_tpu_torch.ops import norm
from srgan_tpu_torch.utils import spans

ATOL = 1e-5
B, C = 2, 8
# H*W divisible by 16 (8x8) and not (5x5)
SHAPES = [(8, 8), (5, 5)]


def _launches(totals):
    """The kernels' launch counters among the ``spans.totals()``."""
    return {k: v for k, v in totals.items() if k.startswith("launch.")}


def _inputs(hw):
    rng = np.random.default_rng(7)
    H, W = hw
    x = (rng.standard_normal((B, H, W, C)) * 2 + 0.3).astype(np.float32)
    x[0, :, :, 1] = 0.5   # a constant plane: the variance clamp at 0
    t = np.tanh(rng.standard_normal((B, C))).astype(np.float32)
    g = rng.uniform(0.5, 1.5, C).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    return x, t, g, b


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(y):
    return y.numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("relu", [False, True])
def test_cbinorm_matches_pallas_kernel(hw, relu):
    x, t, g, b = _inputs(hw)
    want, want_mu, want_r = _fused_fwd(jnp.asarray(x), jnp.asarray(t),
                                       jnp.asarray(g), jnp.asarray(b),
                                       1e-5, relu)
    out, mu, r = norm.fused_cbinorm(_nchw(x), torch.from_numpy(t),
                                    torch.from_numpy(g), torch.from_numpy(b),
                                    1e-5, relu)
    np.testing.assert_allclose(_nhwc(out), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(mu.numpy(), np.asarray(want_mu), atol=ATOL,
                               rtol=0)
    # the constant plane's rstd is rsqrt(eps) ~ 316 on both sides
    np.testing.assert_allclose(r.numpy(), np.asarray(want_r), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("relu", [False, True])
def test_cbinorm_plain_matches_jnp_cbinorm_branch(hw, relu):
    """srgan_tpu/nn/layers.py:356-361, the CBINorm path without the kernel."""
    x, t, g, b = _inputs(hw)
    want = jax_instance_norm(jnp.asarray(x), 1e-5).astype(jnp.float32) \
        + jnp.asarray(t)[:, None, None, :]
    want = want * jnp.asarray(g) + jnp.asarray(b)
    if relu:
        want = jnp.maximum(want, 0.0)
    out, _, _ = norm.cbinorm_plain(_nchw(x), torch.from_numpy(t),
                                   torch.from_numpy(g), torch.from_numpy(b),
                                   1e-5, relu)
    np.testing.assert_allclose(_nhwc(out), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("relu", [False, True])
def test_fused_instance_norm_matches_jnp(hw, relu):
    x, _, _, _ = _inputs(hw)
    want = jax_instance_norm(jnp.asarray(x), 1e-5, relu)
    out = norm.fused_instance_norm(_nchw(x), 1e-5, relu)
    np.testing.assert_allclose(_nhwc(out), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_bfloat16_input_keeps_dtype_and_fp32_stats():
    x, t, g, b = _inputs((8, 8))
    xb = _nchw(x).to(torch.bfloat16)
    out, mu, r = norm.fused_cbinorm(xb, torch.from_numpy(t),
                                    torch.from_numpy(g), torch.from_numpy(b))
    assert out.dtype == torch.bfloat16
    assert mu.dtype == r.dtype == torch.float32
    ref, _, _ = norm.cbinorm_plain(xb.float(), torch.from_numpy(t),
                                   torch.from_numpy(g), torch.from_numpy(b))
    # one bf16 rounding of the output: half an ulp at |y| < 8 is 1/64
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=1 / 64,
                               rtol=0)


@pytest.mark.parametrize("bad", ["x_3d", "x_int", "t_shape", "g_f64",
                                 "x_strided", "meta_device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, t, g, b = (torch.from_numpy(a) for a in _inputs((8, 8)))
    x = x.permute(0, 3, 1, 2).contiguous()
    if bad == "x_3d":
        x = x[0]
    elif bad == "x_int":
        x = x.to(torch.int32)
    elif bad == "t_shape":
        t = t[:, :4]
    elif bad == "g_f64":
        g = g.double()
    elif bad == "x_strided":
        x = x[:, :, :, ::2]
    elif bad == "meta_device":
        x, t, g, b = (v.to("meta") for v in (x, t, g, b))
    before = spans.totals()
    with pytest.raises((ValueError, TypeError)):
        norm.fused_cbinorm(x, t, g, b)
    assert _launches(spans.totals()) == _launches(before)
