"""The gradient of the port's conditional instance norm
(``srgan_tpu_torch/ops/norm.py``: ``CBINormFunction`` and its plain
backward) on the CPU against the JAX package: ``jax.grad`` of the Pallas
``fused_cbinorm`` and ``fused_instance_norm`` (forward in interpret mode,
backward ``_cbinorm_bwd``) and of the jnp CBINorm branch.  fp32; tolerance
1e-5 relative plus 1e-5 absolute (sums in another order over at most 450
elements; the constant plane's rstd of about 316 scales its dx).  Also the
backward kernel's plan (``bwd_plan``) for every norm shape of every
preset."""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srgan_tpu.nn.layers import instance_norm as jax_instance_norm
from srgan_tpu.ops.pallas.norm import fused_cbinorm as jax_fused_cbinorm
from srgan_tpu.ops.pallas.norm import \
    fused_instance_norm as jax_fused_instance_norm
from srgan_tpu_torch.configs import PRESETS
from srgan_tpu_torch.nn.encoder import Encoder
from srgan_tpu_torch.nn.generator import SingleGenerator
from srgan_tpu_torch.ops import norm

TOL = dict(rtol=1e-5, atol=1e-5)
B, C = 2, 8
SHAPES = [(8, 8), (5, 5), (7, 7), (15, 15)]


def _inputs(hw, seed=7):
    rng = np.random.default_rng(seed)
    H, W = hw
    x = (rng.standard_normal((B, H, W, C)) * 2 + 0.3).astype(np.float32)
    # a constant plane: the variance clamp at 0.  At 15 x 15 it is 0, not
    # 0.5: XLA computes the Pallas forward's E[x^2] as sum * (1 / 225),
    # which puts a constant 0.5 plane's variance at 3e-8 instead of 0, and
    # 1 / sqrt(eps) turns that into a 3e-4 relative change of its rstd and
    # dx (the port's forward gets 0; ROADMAP C records the difference)
    x[0, :, :, 1] = 0.0 if hw == (15, 15) else 0.5
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


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("relu", [False, True])
def test_instance_norm_grad_matches_jax_and_skips_affine(hw, relu,
                                                         monkeypatch):
    """``fused_instance_norm``'s dx equals ``jax.grad`` of the Pallas one,
    and its backward asks the kernel for dx alone: t, g and b, made inside,
    need no gradient, so ``CBINormFunction.backward`` returns None for
    them."""
    x, _, _, _, dy = _inputs(hw)
    want = jax.grad(lambda a: jnp.sum(
        jax_fused_instance_norm(a, 1e-5, relu) * dy))(jnp.asarray(x))
    seen = []
    real_bwd = norm.cbinorm_bwd

    def spy(*a, **k):
        out = real_bwd(*a, **k)
        seen.append((k.get("affine", True), out))
        return out

    monkeypatch.setattr(norm, "cbinorm_bwd", spy)
    xs = _nchw(x).requires_grad_(True)
    out = norm.fused_instance_norm(xs, 1e-5, relu)
    out.backward(_nchw(dy))
    np.testing.assert_allclose(xs.grad.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), **TOL)
    [(affine, grads)] = seen
    assert affine is False and grads[1:] == (None, None, None)

    class Ctx:
        saved_tensors = (xs.detach(), *(torch.zeros(B, C), torch.ones(C),
                                        torch.zeros(C)),
                         *norm.cbinorm_fwd(xs.detach(), torch.zeros(B, C),
                                           torch.ones(C), torch.zeros(C),
                                           1e-5, relu)[1:])
        needs_input_grad = (True, False, False, False, False, False)

    Ctx.relu = relu
    got = norm.CBINormFunction.backward(Ctx(), _nchw(dy), None, None)
    assert got[1:] == (None,) * 5
    assert torch.equal(got[0], xs.grad)


def _preset_norm_shapes(cfg, monkeypatch):
    """(C, H, W) of every norm launch of one G and one E forward of
    ``cfg``, traced on the meta device (no arithmetic; autocast, which
    CBINorm turns off around its conditional bias, has no meta device)."""
    m = cfg.model
    with torch.device("meta"):
        G = SingleGenerator(nch_in=m.nch_in, nch=m.g_nch, reduce=m.g_reduce,
                            num_cls=m.g_num_cls, res_num=m.g_res_num,
                            norm_type=m.norm_type, num_con=m.num_con)
        E = Encoder(nch_in=m.nch_in, nch_out=m.ndim, nch=m.e_nch,
                    num_cls=m.e_num_cls, num_con=m.n_classes)
    shapes = set()

    def recording(x, t, g, b, eps=1e-5, relu=False):
        shapes.add(tuple(x.shape[1:]))
        return (torch.empty_like(x), torch.empty(x.shape[:2], device="meta"),
                torch.empty(x.shape[:2], device="meta"))

    monkeypatch.setattr(norm, "fused_cbinorm", recording)
    monkeypatch.setattr(torch, "autocast",
                        lambda *a, **k: contextlib.nullcontext())
    x = torch.empty((1, m.nch_in, m.image_size, m.image_size), device="meta")
    G(x, torch.empty((1, m.num_con), device="meta"))
    E(x)
    return shapes


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_bwd_plan_holds_every_preset_norm_shape(preset, monkeypatch):
    """Every plane of every preset's G and E lands in a register tier (one
    read of x and dy), within its template's per-thread count, in fp32 and
    bf16, aligned or not; and the plans match the kernel's own check
    (``csrc/cbinorm.cu::plan_ok``)."""
    shapes = _preset_norm_shapes(PRESETS[preset](), monkeypatch)
    assert len(shapes) >= 6, shapes
    for (_, H, W) in shapes:
        hw = H * W
        for itemsize in (4, 2):
            for aligned in (True, False):
                tier, items, vec, cluster = norm.bwd_plan(hw, itemsize,
                                                          aligned)
                assert tier in (norm.BWD_WARP, norm.BWD_CTA), (hw, tier)
                assert vec in (1, 16 // itemsize) and hw % vec == 0
                assert aligned or vec == 1
                if aligned and hw % (16 // itemsize) == 0 and (
                        tier == norm.BWD_CTA or items % (16 // itemsize) == 0):
                    assert vec == 16 // itemsize, (hw, itemsize)
                if tier == norm.BWD_WARP:
                    assert items in norm.WARP_ITEMS and items % vec == 0
                    assert 32 * items >= hw and cluster == 1
                else:
                    chunk = norm.CTA_THREADS * norm.CTA_ITEMS
                    assert items == norm.CTA_ITEMS
                    assert 1 <= cluster <= norm.MAX_CLUSTER
                    assert (cluster - 1) * chunk < hw <= cluster * chunk


@pytest.mark.parametrize("hw, itemsize, plan", [
    (1, 4, (0, 2, 1, 1)), (49, 4, (0, 2, 1, 1)), (64, 4, (0, 2, 1, 1)),
    (65, 4, (0, 8, 1, 1)), (225, 2, (0, 8, 1, 1)), (256, 2, (0, 8, 8, 1)),
    (961, 4, (0, 32, 1, 1)), (1024, 4, (0, 32, 4, 1)),
    (1025, 4, (1, 16, 1, 1)), (3844, 4, (1, 16, 4, 1)),
    (3844, 2, (1, 16, 1, 1)), (4096, 2, (1, 16, 8, 1)),
    (4097, 4, (1, 16, 1, 2)), (16129, 4, (1, 16, 1, 4)),
    (16384, 4, (1, 16, 4, 4)), (32768, 4, (1, 16, 4, 8)),
    (32769, 4, (2, 0, 1, 1)), (65536, 2, (2, 0, 1, 1)),
])
def test_bwd_plan_tier_edges(hw, itemsize, plan):
    assert norm.bwd_plan(hw, itemsize) == plan


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
