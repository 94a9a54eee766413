"""Channels-last activations in the port, on the CPU: the norm's wrapper
(``srgan_tpu_torch/ops/norm.py``) on a channels-last x against the same
values stored NCHW, forward and gradient, keeping the layout; the NHWC
kernels' plan for every preset's norm shapes; the nets (G, both Ds, both
encoders, ``ReflectConv2d``) in channels-last against NCHW; and one
``GANTrainer`` step with channels-last nets against the NCHW step, on one
process and on a mesh of two gloo ranks.  On
CUDA under bf16 the nets are channels-last
(``training/gan.py::memory_format``); here the tests put them so.
Tolerances: the same values summed in another order (mkldnn's NHWC
convolutions against its NCHW ones), fp32 round-off.
The kernels themselves are held to the plain twin on the card by
``tests/test_torch_card.py``."""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)

import contextlib
import dataclasses
import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_parallel_ranks as ranks
from srgan_tpu_torch.configs import PRESETS, ModelConfig, config_to_dict
from srgan_tpu_torch.nn import layers
from srgan_tpu_torch.nn.layers import ReflectConv2d
from srgan_tpu_torch.ops import norm
from srgan_tpu_torch.training import gan

CL = torch.channels_last
TOL = dict(rtol=1e-5, atol=1e-5)


def _cl(x):
    return x.contiguous(memory_format=CL)


def _inputs(seed=0, B=2, C=16, H=5, W=7, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn((B, C, H, W), generator=gen) * 2 + 0.3).to(dtype)
    t = torch.tanh(torch.randn((B, C), generator=gen))
    g = torch.rand((C,), generator=gen) + 0.5
    b = torch.randn((C,), generator=gen) * 0.3
    dy = torch.randn((B, C, H, W), generator=gen).to(dtype)
    return x, t, g, b, dy


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               want.detach().float().numpy(),
                               **(tol or TOL))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("fn", ["fused_cbinorm", "fused_instance_norm"])
def test_norm_on_channels_last_matches_nchw_and_keeps_layout(fn, relu,
                                                             dtype):
    x, t, g, b, dy = _inputs(dtype=dtype)
    outs, grads = [], []
    for xin in (x, _cl(x)):
        xs = xin.clone(memory_format=torch.preserve_format) \
            .requires_grad_(True)
        ts = t.clone().requires_grad_(True)
        gs = g.clone().requires_grad_(True)
        bs = b.clone().requires_grad_(True)
        if fn == "fused_cbinorm":
            out = norm.fused_cbinorm(xs, ts, gs, bs, 1e-5, relu)[0]
            leaves = (xs, ts, gs, bs)
        else:
            out = norm.fused_instance_norm(xs, 1e-5, relu)
            leaves = (xs,)
        out.backward(dy)
        assert out.dtype == dtype and xs.grad.dtype == dtype
        assert out.is_contiguous(memory_format=norm.layout(xin))
        assert xs.grad.is_contiguous(memory_format=norm.layout(xin))
        outs.append(out)
        grads.append([v.grad for v in leaves])
    assert norm.channels_last(outs[1]) and norm.channels_last(grads[1][0])
    # the same elements, summed in the same order by the plain twins: bf16
    # outputs and dx may round once the other way
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    _close(outs[1], outs[0], **tol)
    for a, w in zip(grads[1], grads[0]):
        _close(a, w, **tol)


def test_backward_brings_dy_to_x_layout():
    """An NCHW dy for a channels-last x (and the reverse) gives the same
    dx, dt, dg, db, with dx in x's layout."""
    x, t, g, b, dy = _inputs(1)
    _, mu, rstd = norm.cbinorm_fwd(x, t, g, b, 1e-5, True)
    want = norm.cbinorm_bwd(x, t, g, b, mu, rstd, dy, True)
    got = norm.cbinorm_bwd(_cl(x), t, g, b, mu, rstd, dy, True)
    assert norm.channels_last(got[0])
    back = norm.cbinorm_bwd(x, t, g, b, mu, rstd, _cl(dy), True)
    assert back[0].is_contiguous()
    for a, c, w in zip(got, back, want):
        _close(a, w)
        _close(c, w)


class _PlainCBINorm(torch.autograd.Function):
    """The plain forward with the plain backward as its gradient."""

    @staticmethod
    def forward(ctx, x, t, g, b, relu):
        out, mu, rstd = norm.cbinorm_plain(x, t, g, b, 1e-5, relu)
        ctx.save_for_backward(x, t, g, b, mu, rstd)
        ctx.relu = relu
        return out

    @staticmethod
    def backward(ctx, dy):
        x, t, g, b, mu, rstd = ctx.saved_tensors
        dy = dy.contiguous(memory_format=norm.layout(x))
        return (*norm.cbinorm_bwd_plain(x, t, g, b, mu, rstd, dy, ctx.relu),
                None)


@pytest.mark.parametrize("relu", [False, True])
def test_plain_backward_gradcheck_float64_channels_last(relu):
    rng = np.random.default_rng(5)
    x = _cl(torch.from_numpy(rng.standard_normal((2, 3, 3, 4))))
    t = torch.from_numpy(np.tanh(rng.standard_normal((2, 3))))
    g = torch.from_numpy(rng.uniform(0.5, 1.5, 3))
    b = torch.from_numpy(rng.standard_normal(3) * 0.5)
    args = [v.clone(memory_format=torch.preserve_format).requires_grad_(True)
            for v in (x, t, g, b)]
    assert norm.channels_last(args[0])
    assert norm.channels_last(_PlainCBINorm.apply(*args, relu))
    assert torch.autograd.gradcheck(
        lambda *a: _PlainCBINorm.apply(*a, relu), args, eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("make", [
    lambda x: x.transpose(2, 3),                   # (B, C, W, H) view
    lambda x: x[:, :, ::2],                        # every other row
    lambda x: x.permute(1, 0, 2, 3),               # C before B
    lambda x: _cl(x)[:, :, :, 1:],                 # a channels-last slice
])
def test_check_refuses_strides_of_neither_layout(make):
    x, t, g, b, _ = _inputs(2, B=2, C=2, H=6, W=6)
    bad = make(x)
    B, C = bad.shape[:2]
    with pytest.raises(ValueError, match="must be contiguous"):
        norm.cbinorm_fwd(bad, t[:B, :C].contiguous(), g[:C].contiguous(),
                         b[:C].contiguous())
    # the layers hand the norm a copy of such an x
    assert norm.dense(bad).is_contiguous()
    assert norm.dense(_cl(x)) is not x and norm.channels_last(
        norm.dense(_cl(x)))


def test_layout_reads_strides():
    x = torch.zeros((2, 4, 3, 3))
    assert norm.layout(x) == torch.contiguous_format
    assert norm.layout(_cl(x)) == CL
    # both layouts at once (C = 1): the NCHW pair takes it
    assert not norm.channels_last(_cl(torch.zeros((2, 1, 3, 3))))
    # channels-last where cuDNN's convolutions run NHWC: CUDA under bf16
    assert gan.memory_format("cuda", "bfloat16") == CL
    assert gan.memory_format("cuda", "float32") == torch.contiguous_format
    assert gan.memory_format("cpu", "bfloat16") == torch.contiguous_format


def _path_shapes(cfg, monkeypatch):
    """(C, H, W) of every norm application of the preset's G and E, traced
    on the meta device."""
    seen = set()

    def recording(x, t, g, b, eps=1e-5, relu=False):
        seen.add(tuple(x.shape[1:]))
        return x, t, t

    m = cfg.model
    G = gan.build_generator(cfg, "meta")
    E = gan.build_encoder(cfg, "meta")
    monkeypatch.setattr(norm, "fused_cbinorm", recording)
    monkeypatch.setattr(torch, "autocast",
                        lambda *a, **k: contextlib.nullcontext())
    x = torch.empty((1, m.nch_in, m.image_size, m.image_size), device="meta")
    c = torch.empty((1, m.num_con), device="meta")
    G(x, c)
    E(x, c[:, :m.n_classes]) if gan.conditional_encoder(cfg) else E(x)
    return seen


def _plan_holds(plan, B, hw, C, itemsize, tensors):
    """The NHWC plan's contract: whole vectors a group, boxes of a multiple
    of 8 pixels, a cluster that covers the sample's pixels with no block
    idle, and a ring of more slots than a tile's boxes (at least one box
    loading while a tile is in hand) that fits the shared memory a block
    may use with its bookkeeping.  Returns (a block's share of a tile in
    bytes, the call's blocks a round)."""
    tc, rows, boxes, cluster, slots = plan
    assert tc in norm.NHWC_TC and C % (tc * 16 // itemsize) == 0
    assert rows % 8 == 0 and 8 <= rows <= norm.NHWC_BOX_ROWS and boxes >= 1
    assert 1 <= cluster <= norm.NHWC_MAX_CLUSTER
    pixels = rows * boxes
    assert (cluster - 1) * pixels < hw <= cluster * pixels
    share = pixels * tc * 16 * tensors
    assert boxes < slots <= norm.NHWC_MAX_SLOTS
    assert slots * rows * tc * 16 * tensors < norm.nhwc_smem(
        plan, itemsize, tensors) <= norm.NHWC_SMEM == 227 * 1024
    return share, B * C // (tc * 16 // itemsize) * cluster


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_nhwc_plan_holds_every_preset_norm_shape(preset, monkeypatch):
    """Every norm shape of every preset's G and E has an NHWC plan in fp32
    and bf16, forward and backward, at batch 1, 32, 128 and 256 (G runs at
    twice the batch): each ring fits a block's shared memory and the
    cluster holds the sample's pixels with no block idle.  From batch 32 the
    blocks fill the card's SMs, and in bf16 a block's share of a tile keeps
    to the plan's aim."""
    shapes = _path_shapes(PRESETS[preset](), monkeypatch)
    assert len(shapes) >= 6, shapes
    for C, H, W in shapes:
        for itemsize, B, tensors in itertools.product((4, 2), (1, 32, 128,
                                                               256), (1, 2)):
            plan = norm.nhwc_plan(B, H * W, C, itemsize, tensors)
            assert plan is not None, (preset, C, H, W, itemsize, B, tensors)
            share, blocks = _plan_holds(plan, B, H * W, C, itemsize, tensors)
            if B >= 32:
                assert blocks >= norm.NHWC_SMS, (C, H, W, B, plan)
            if itemsize == 2:
                assert share <= norm.NHWC_TILE_BYTES, (C, H, W, plan)


# (forward, backward) plans at batch 128
@pytest.mark.parametrize("hw, c, itemsize, plan", [
    # G's outer layers: 16-block clusters, the forward's groups the whole
    # 128-byte pixel; the backward's x and dy take groups half as wide
    (128 * 128, 64, 2, ((8, 256, 4, 16, 6), (4, 256, 4, 16, 6))),
    (64 * 64, 128, 2, ((8, 256, 4, 4, 6), (8, 256, 2, 8, 3))),
    # the residual blocks: a block a sample and group, 128-byte rows
    (32 * 32, 256, 2, ((8, 256, 4, 1, 6), (8, 256, 2, 2, 3))),
    (62 * 62, 64, 2, ((8, 248, 4, 4, 6), (8, 248, 2, 8, 3))),
    (15 * 15, 256, 2, ((8, 232, 1, 1, 3), (8, 232, 1, 1, 3))),
    (7 * 7, 512, 2, ((8, 56, 1, 1, 3), (8, 56, 1, 1, 3))),  # one box
    (128 * 128, 64, 4, ((8, 256, 4, 16, 6), (4, 256, 4, 16, 6))),
    (181 * 181, 16, 2, ((2, 256, 16, 8, 18), (2, 256, 8, 16, 10))),
    # above the register-held kernels' pixels: narrower groups, more boxes
    (182 * 182, 16, 2, ((2, 248, 15, 9, 17), (1, 248, 15, 9, 17))),
    (256 * 256, 64, 2, ((2, 256, 16, 16, 18), (1, 256, 16, 16, 18))),
    (100, 3, 2, (None, None)),        # C not a whole number of vectors
    (100, 12, 4, ((1, 104, 1, 1, 3), (1, 104, 1, 1, 3))),  # 3 vectors
    # a call of 200 KB: one block a tile, no cluster exchange
    (100, 8, 2, ((1, 104, 1, 1, 3), (1, 104, 1, 1, 3))),
])
def test_nhwc_plan_edges(hw, c, itemsize, plan):
    got = tuple(norm.nhwc_plan(128, hw, c, itemsize, n) for n in (1, 2))
    assert got == plan
    for p, n in zip(got, (1, 2)):
        if p is not None:
            _plan_holds(p, 128, hw, c, itemsize, n)


def test_nhwc_plan_weighs_latency_in_a_small_call():
    """Serving's batch 1 moves too few bytes to be bound by the memory's
    rate: a sample of G's outer layers is spread over a 16-block cluster
    in rows of 32 bytes, not 16; the residual blocks' tile stays in one
    block, with no cluster exchange; and the training batch keeps its
    plans."""
    assert norm.nhwc_plan(1, 128 * 128, 64, 2) == (2, 256, 4, 16, 6)
    assert norm.nhwc_plan(1, 32 * 32, 256, 2) == (2, 256, 4, 1, 6)
    assert norm.nhwc_plan(1, 32 * 32, 256, 2, 2) == (2, 256, 4, 1, 6)
    for hw, c in ((128 * 128, 64), (64 * 64, 128), (32 * 32, 256)):
        assert norm.nhwc_plan(1, hw, c, 2)[0] >= 2
    assert norm.nhwc_plan(128, 32 * 32, 256, 2) == (8, 256, 4, 1, 6)


def _tiny(trainer="srgan", **train):
    base = {"srgan": "05_srgan_full",
            "singlegan": "01_proposed_singlegan_k5"}[trainer]
    cfg = PRESETS[base]()
    return dataclasses.replace(
        cfg, model=ModelConfig(image_size=32, g_nch=8, g_res_num=1, d_nch=8,
                               d_num_cls=3, e_nch=8, e_num_cls=2),
        train=dataclasses.replace(cfg.train, batch_size=4, **train))


def test_transform_and_encode_follow_the_nets_layout(monkeypatch):
    """``transform`` and ``encode`` hand the nets their images in the
    layout the nets were built in, and give the NCHW nets' answers."""
    cfg = _tiny("srgan")
    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.uniform(-1, 1, (2, 32, 32, 3))
                           .astype(np.float32))
    seen, outs = [], []
    for fmt in (torch.contiguous_format, CL):
        monkeypatch.setattr(gan, "memory_format", lambda *a, f=fmt: f)
        G = gan.build_generator(cfg, "cpu", torch.Generator().manual_seed(0))
        E = gan.build_encoder(cfg, "cpu", torch.Generator().manual_seed(1))
        G.register_forward_pre_hook(lambda m, a: seen.append(
            a[0].is_contiguous(memory_format=fmt)))
        fake, _ = gan.transform(G, img, [1, 2], torch.zeros(cfg.model.ndim))
        outs.append((fake, *gan.encode(E, img)[:2]))
    assert seen == [True, True]
    for a, w in zip(outs[1], outs[0]):
        _close(a, w, rtol=1e-4, atol=1e-5)


def test_reflect_conv_keeps_channels_last_and_nn_conv2d_values():
    conv = ReflectConv2d(6, 5, 3, 1, 1, bias=False)
    ref = torch.nn.Conv2d(6, 5, 3, 1, 1, bias=False, padding_mode="reflect")
    ref.load_state_dict(conv.state_dict())
    assert list(conv.state_dict()) == ["weight"]
    x = torch.randn((2, 6, 9, 8))
    dy = torch.randn((2, 5, 9, 8))
    xs = [x.clone().requires_grad_(True),
          _cl(x).requires_grad_(True)]
    out_ref = ref(xs[0])
    out = conv.to(memory_format=CL)(xs[1])
    assert norm.channels_last(out)
    out_ref.backward(dy)
    out.backward(dy)
    _close(out, out_ref)
    _close(xs[1].grad, xs[0].grad)
    assert norm.channels_last(xs[1].grad)
    _close(conv.weight.grad, ref.weight.grad)
    # on an NCHW input it is nn.Conv2d's reflect convolution
    _close(conv(x), out_ref)


@pytest.mark.parametrize("pool", [(3, 2, 1, False), (3, 2, 1, True),
                                  (2, 2, 0, True)])
def test_avg_pool_keeps_channels_last_and_nchw_values(pool):
    """``layers.avg_pool2d`` on a channels-last x: F.avg_pool2d's values on
    the same x stored NCHW, forward and gradient (float64: the same sums
    in another order), channels-last in and out."""
    k, s, p, cip = pool
    x = torch.randn((2, 5, 9, 8), dtype=torch.float64)
    dy = torch.randn(F.avg_pool2d(x, k, s, p, count_include_pad=cip).shape,
                     dtype=torch.float64)
    xs = [x.clone().requires_grad_(True), _cl(x).requires_grad_(True)]
    want = F.avg_pool2d(xs[0], k, s, p, count_include_pad=cip)
    got = layers.avg_pool2d(xs[1], k, s, p, count_include_pad=cip)
    assert norm.channels_last(got)
    assert torch.equal(got, want)
    want.backward(dy)
    got.backward(dy)
    assert norm.channels_last(xs[1].grad)
    _close(xs[1].grad, xs[0].grad, rtol=1e-12, atol=1e-12)
    assert torch.autograd.gradcheck(
        lambda v: layers.avg_pool2d(v, k, s, p, count_include_pad=cip),
        [_cl(x[:1, :2]).requires_grad_(True)])


@pytest.mark.parametrize("trainer", ["srgan", "singlegan"])
def test_nets_in_channels_last_match_nchw(trainer, monkeypatch):
    """G, D and E built channels-last give the NCHW nets' outputs from the
    same weights, within fp32 round-off, and keep the layout through G."""
    cfg = _tiny(trainer)
    m = cfg.model
    nets = {}
    for fmt in (torch.contiguous_format, CL):
        monkeypatch.setattr(gan, "memory_format", lambda *a, f=fmt: f)
        nets[fmt] = [build(cfg, "cpu", torch.Generator().manual_seed(i))
                     for i, build in enumerate((gan.build_generator,
                                                gan.build_discriminator,
                                                gan.build_encoder))]
    G1, D1, E1 = nets[CL]
    assert all(p.is_contiguous(memory_format=CL)
               for p in G1.parameters() if p.dim() == 4)
    assert gan.net_format(G1) == CL and gan.net_format(E1) == CL
    assert gan.net_format(nets[torch.contiguous_format][0]) == \
        torch.contiguous_format
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.uniform(-1, 1, (3, m.image_size, m.image_size,
                                               3)).astype(np.float32))
    cond = torch.from_numpy(rng.standard_normal((3, m.num_con))
                            .astype(np.float32))
    onehot = gan.onehot([0, 1, 3], m.n_classes)
    outs = {}
    for fmt, (G, D, E) in nets.items():
        x = gan._nchw(img, fmt)
        with torch.no_grad():
            fake = G(x, cond)
            d_out = [D[i](x) for i in range(len(D))] \
                if trainer == "singlegan" else D(x)
            e_out = E(x, onehot) if trainer == "singlegan" else E(x)
        assert fake.is_contiguous(memory_format=fmt)
        outs[fmt] = (fake, d_out, e_out)
    flat = [torch.utils._pytree.tree_leaves(outs[f]) for f in (
        torch.contiguous_format, CL)]
    assert len(flat[0]) == len(flat[1])
    for a, w in zip(flat[1], flat[0]):
        _close(a, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("trainer", ["srgan", "singlegan"])
def test_step_with_channels_last_nets_matches_nchw_step(trainer,
                                                        monkeypatch):
    """One ``GANTrainer`` step (k = 2) with channels-last nets gives the
    NCHW step's losses within 1e-4 relative (plus 1e-6 absolute), and its
    parameters and Adam's moments stay channels-last; state-dict keys and
    values keep their NCHW shapes."""
    cfg = _tiny(trainer, unrolled_k=2)
    rng = np.random.default_rng(11)
    B, hw = cfg.train.batch_size, cfg.model.image_size
    src = rng.integers(0, 4, B)
    batch = {"image": torch.from_numpy(rng.uniform(-1, 1, (B, hw, hw, 3))
                                       .astype(np.float32)),
             "source_label": torch.from_numpy(src),
             "target_label": torch.from_numpy((src + rng.integers(1, 4, B))
                                              % 4)}
    runs = {}
    for fmt in (torch.contiguous_format, CL):
        monkeypatch.setattr(gan, "memory_format", lambda *a, f=fmt: f)
        t = gan.GANTrainer(cfg, device="cpu")
        st = t.init_state(torch.Generator().manual_seed(0))
        metrics = t.step(st, batch)
        runs[fmt] = (st, {k: float(v) for k, v in metrics.items()})
    (st0, m0), (st1, m1) = runs[torch.contiguous_format], runs[CL]
    assert set(m0) == set(m1)
    for k in m0:
        assert abs(m1[k] - m0[k]) <= 1e-4 * abs(m0[k]) + 1e-6, (k, m0[k],
                                                               m1[k])
    for net in ("G", "D", "E"):
        for p in getattr(st1, net).parameters():
            if p.dim() == 4:
                assert p.is_contiguous(memory_format=CL), net
    for p in st1.G.parameters():
        if p.dim() == 4:
            assert st1.opt_g.state[p]["exp_avg"].is_contiguous(
                memory_format=CL)
    sd0, sd1 = st0.G.state_dict(), st1.G.state_dict()
    assert list(sd0) == list(sd1)
    for k in sd0:
        assert sd0[k].shape == sd1[k].shape
        # the parameters after one step: Adam's first steps are sign-like,
        # so a gradient near 0 may step the other way (2 lr at most)
        assert float((sd1[k] - sd0[k]).abs().max()) <= 2.2 * max(
            cfg.train.lr_g, cfg.train.lr_d, cfg.train.lr_e), k


def test_mesh_step_with_channels_last_nets_matches_nchw_mesh_step(tmp_path):
    """One data-parallel step (k = 2) on 2 gloo ranks, global batch 4,
    with channels-last nets gives the NCHW mesh step's losses within 1e-4
    relative (plus 1e-6 absolute) and its parameters within the
    one-process test's bound; both ranks agree bit for bit; the ranks' mean
    gradients keep each gradient's layout, so the 4-D parameters and
    Adam's moments stay channels-last."""
    cfg = _tiny("srgan", unrolled_k=2)
    st = gan.GANTrainer(cfg, device="cpu").init_state(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(12)
    B, hw = cfg.train.batch_size, cfg.model.image_size
    src = rng.integers(0, 4, B)
    batch = dict(image=rng.uniform(-1, 1, (B, hw, hw, 3)).astype(np.float32),
                 source_label=src.astype(np.int64),
                 target_label=((src + rng.integers(1, 4, B)) % 4)
                 .astype(np.int64))
    case = dict(config=config_to_dict(cfg), grad_sync="auto", draws=None,
                g=st.G.state_dict(), d=st.D.state_dict(),
                e=st.E.state_dict(), hist_target=st.hist_target,
                frozen=False, batch=batch)
    out = ranks.finish(ranks.start(str(tmp_path), dict(steps={
        "nchw": case, "channels_last": dict(case, channels_last=True)})),
        timeout=240.0)
    for name in ("nchw", "channels_last"):
        o0, o1 = (o["steps"][name] for o in out)
        assert o0["metrics"] == o1["metrics"], name
        for net in ("G", "D", "E"):
            for k in o0[net]:
                assert torch.equal(o0[net][k], o1[net][k]), (name, net, k)
        assert o0["layouts"]["means_kept"], name
    (m0, s0), (m1, s1) = ((out[0]["steps"][n]["metrics"], out[0]["steps"][n])
                          for n in ("nchw", "channels_last"))
    assert set(m0) == set(m1)
    for k in m0:
        assert abs(m1[k] - m0[k]) <= 1e-4 * abs(m0[k]) + 1e-6, (k, m0[k],
                                                               m1[k])
    lr = max(cfg.train.lr_g, cfg.train.lr_d, cfg.train.lr_e)
    for net in ("G", "D", "E"):
        for k in s0[net]:
            assert s0[net][k].shape == s1[net][k].shape
            assert float((s1[net][k] - s0[net][k]).abs().max()) <= 2.2 * lr, \
                (net, k)
    cl = s1["layouts"]
    assert cl["params"] and cl["moments"] and cl["means_channels_last"] > 0
