"""The gradient of the port's conditional instance norm
(``srgan_tpu_torch/ops/norm.py``: ``CBINormFunction`` and its plain
backward) on the CPU against the JAX package: ``jax.grad`` of the Pallas
``fused_cbinorm`` (forward in interpret mode, backward ``_cbinorm_bwd``)
and of the jnp CBINorm branch.  fp32; tolerance 1e-5 relative plus 1e-5
absolute (sums in another order over at most 128 elements; the constant
plane's rstd of about 316 scales its dx)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srgan_tpu.nn.layers import instance_norm as jax_instance_norm
from srgan_tpu.ops.pallas.norm import fused_cbinorm as jax_fused_cbinorm
from srgan_tpu_torch.ops import norm

TOL = dict(rtol=1e-5, atol=1e-5)
B, C = 2, 8
SHAPES = [(8, 8), (5, 5)]


def _inputs(hw, seed=7):
    rng = np.random.default_rng(seed)
    H, W = hw
    x = (rng.standard_normal((B, H, W, C)) * 2 + 0.3).astype(np.float32)
    x[0, :, :, 1] = 0.5   # a constant plane: the variance clamp at 0
    t = np.tanh(rng.standard_normal((B, C))).astype(np.float32)
    g = rng.uniform(0.5, 1.5, C).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    dy = rng.standard_normal((B, H, W, C)).astype(np.float32)
    return x, t, g, b, dy


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _port_grads(x, t, g, b, dy, relu):
    xs = _nchw(x).requires_grad_(True)
    ts, gs, bs = (torch.from_numpy(a).requires_grad_(True) for a in (t, g, b))
    out = norm.fused_cbinorm(xs, ts, gs, bs, 1e-5, relu)[0]
    assert out.grad_fn is not None
    out.backward(_nchw(dy))
    return (xs.grad.numpy().transpose(0, 2, 3, 1), ts.grad.numpy(),
            gs.grad.numpy(), bs.grad.numpy())


def _jnp_cbinorm(x, t, g, b, relu):
    """srgan_tpu/nn/layers.py:356-361, the CBINorm path without the
    kernel."""
    y = jax_instance_norm(x, 1e-5).astype(jnp.float32) + t[:, None, None, :]
    y = y * g + b
    return jnp.maximum(y, 0.0) if relu else y


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("oracle", ["pallas", "jnp"])
def test_cbinorm_grad_matches_jax(hw, relu, oracle):
    x, t, g, b, dy = _inputs(hw)
    if oracle == "pallas":
        def f(*a):
            return jnp.sum(jax_fused_cbinorm(*a, 1e-5, relu) * dy)
    else:
        def f(*a):
            return jnp.sum(_jnp_cbinorm(*a, relu) * dy)
    want = jax.grad(f, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, t, g, b)))
    got = _port_grads(x, t, g, b, dy, relu)
    for name, w, o in zip(("dx", "dt", "dg", "db"), want, got):
        np.testing.assert_allclose(o, np.asarray(w), err_msg=name, **TOL)


class _PlainCBINorm(torch.autograd.Function):
    """cbinorm_plain with cbinorm_bwd_plain as its gradient, in any float
    dtype, for gradcheck."""

    @staticmethod
    def forward(ctx, x, t, g, b, relu):
        out, mu, rstd = norm.cbinorm_plain(x, t, g, b, 1e-5, relu)
        ctx.save_for_backward(x, t, g, b, mu, rstd)
        ctx.relu = relu
        return out

    @staticmethod
    def backward(ctx, dy):
        x, t, g, b, mu, rstd = ctx.saved_tensors
        return (*norm.cbinorm_bwd_plain(x, t, g, b, mu, rstd, dy, ctx.relu),
                None)


@pytest.mark.parametrize("relu", [False, True])
def test_plain_backward_gradcheck_float64(relu):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 3, 3, 4)))
    t = torch.from_numpy(np.tanh(rng.standard_normal((2, 3))))
    g = torch.from_numpy(rng.uniform(0.5, 1.5, 3))
    b = torch.from_numpy(rng.standard_normal(3) * 0.5)
    args = [v.clone().requires_grad_(True) for v in (x, t, g, b)]
    assert torch.autograd.gradcheck(
        lambda *a: _PlainCBINorm.apply(*a, relu), args, eps=1e-6, atol=1e-6)


def test_bfloat16_backward_keeps_dtypes():
    x, t, g, b, dy = _inputs((8, 8))
    xs = _nchw(x).to(torch.bfloat16).requires_grad_(True)
    ts = torch.from_numpy(t).requires_grad_(True)
    out = norm.fused_cbinorm(xs, ts, torch.from_numpy(g),
                             torch.from_numpy(b), 1e-5, True)[0]
    out.backward(_nchw(dy).to(torch.bfloat16))
    assert xs.grad.dtype == torch.bfloat16 and ts.grad.dtype == torch.float32
    x32 = xs.detach().float().requires_grad_(True)
    ref = norm.cbinorm_plain(x32, torch.from_numpy(t), torch.from_numpy(g),
                             torch.from_numpy(b), 1e-5, True)[0]
    ref.backward(_nchw(dy).to(torch.bfloat16).float())
    # one bf16 rounding of dx: |dx| < 8 here, so half an ulp is 1/64
    np.testing.assert_allclose(xs.grad.float().numpy(), x32.grad.numpy(),
                               atol=1 / 64, rtol=0)


def test_model_gradients_through_function_match_plain_autograd(monkeypatch):
    """A generator + encoder forward and backward through the Function
    equals the same models with the norm as plain autograd through
    ``cbinorm_plain``: every parameter's gradient, 1e-5 relative to its
    largest entry (sums in another order through ten layers)."""
    from srgan_tpu_torch.configs import (
        ExperimentConfig, LossWeights, ModelConfig, TrainConfig)
    from srgan_tpu_torch.training import gan

    cfg = ExperimentConfig(
        name="t", model=ModelConfig(image_size=32, g_nch=8, g_res_num=2,
                                    e_nch=8, e_num_cls=2),
        train=TrainConfig(), loss=LossWeights())
    G = gan.build_generator(cfg, "cpu", torch.Generator().manual_seed(0))
    E = gan.build_encoder(cfg, "cpu", torch.Generator().manual_seed(1))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-1, 1, (3, 3, 32, 32)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((3, 12)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 32, 32)).astype(
        np.float32))
    params = list(G.parameters()) + list(E.parameters())

    def grads():
        fake = G(x, c)
        mu, logvar, cls = E(fake)
        loss = ((fake * w).mean() + mu.square().mean() + logvar.mean()
                + cls.square().mean())
        return torch.autograd.grad(loss, params)

    got = grads()
    monkeypatch.setattr(norm, "fused_cbinorm",
                        lambda *a, **k: norm.cbinorm_plain(*a, **k))
    want = grads()
    for g1, g2 in zip(got, want):
        scale = float(g2.abs().max()) or 1.0
        assert float((g1 - g2).abs().max()) <= 1e-5 * scale
