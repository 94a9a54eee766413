"""The port's card tests: the channels-last (NHWC) norm kernels against
their plain twins (``srgan_tpu_torch/ops/norm.py``) at every shape the nets
give them (G's 128^2 x 64, 64^2 x 128 and 32^2 x 256, the encoder's 62^2 x
64, 31^2 x 128, 15^2 x 256 and 7^2 x 512) at batch 1, 32 and 128, and at
ragged pixel counts and a C of one vector, fp32 and bf16, ReLU on and off,
with and without affine, each call twice for the same bits, and the paths
around them (the NCHW copy where a shape has no NHWC plan, the
``norm.nhwc`` counter); the channels-last pools of ``nn/layers.py`` against
CUDA's NCHW pools; and the train step replayed from CUDA graphs
(``GANTrainer._graphed_step``) against the same trainer stepping eagerly.
Every test is marked ``card`` and skips without CUDA.  On the card, from
the repository's root:

    python -m pytest tests/test_torch_card.py -q -m card --noconftest

This file imports no JAX, and ``--noconftest`` keeps pytest from loading
the test tree's conftest.py, which sets up the JAX package for the CPU
tests (the card's host has none)."""

import dataclasses
import json
import os

import pytest
import torch

import torch.nn.functional as F

from srgan_tpu_torch.configs import PRESETS
from srgan_tpu_torch.nn import layers
from srgan_tpu_torch.ops import norm
from srgan_tpu_torch.training.gan import GANTrainer
from srgan_tpu_torch.utils import spans
from srgan_tpu_torch.utils.checkpoint import (
    TRAIN_STATE_FILE,
    restore_checkpoint,
    save_checkpoint,
)

pytestmark = pytest.mark.card

BATCH = 128
# (C, H, W) of G's and the encoder's norms
SHAPES = ((64, 128, 128), (128, 64, 64), (256, 32, 32), (64, 62, 62),
          (128, 31, 31), (256, 15, 15), (512, 7, 7))
# fp32 outputs against the plain twin, relative to the largest entry: the
# same sums in another order over up to 16,384 elements
REL_TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _inputs(dev, B, C, H, W, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    # |y| stays below 4: |x_hat| <= sqrt(3) for uniform x
    x = ((torch.rand((B, C, H, W), generator=gen, device=dev) * 2 - 1) * 3
         + 0.5).to(dtype).contiguous(memory_format=torch.channels_last)
    t = torch.tanh(torch.randn((B, C), generator=gen, device=dev))
    g = 0.8 + 0.4 * torch.rand((C,), generator=gen, device=dev)
    b = 0.4 * torch.rand((C,), generator=gen, device=dev) - 0.2
    dy = torch.randn((B, C, H, W), generator=gen, device=dev).to(dtype) \
        .contiguous(memory_format=torch.channels_last)
    return x, t, g, b, dy


def _rel(got, want) -> float:
    scale = float(want.float().abs().max()) or 1.0
    return float((got.float() - want.float()).abs().max()) / scale


def _bf16_ok(got, want) -> bool:
    """Every element within two bf16 ulps of the fp32-computed plain twin,
    plus 1e-5 of the largest entry for results that cancel to near 0."""
    got, want = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(
        want.abs().clamp_min(1e-30))) - 7)
    floor = 1e-5 * float(want.abs().max())
    return bool(((got - want).abs() <= 2 * ulp + floor).all())


def _held(got, want, dtype) -> bool:
    if dtype == torch.float32:
        return _rel(got, want) <= REL_TOL
    return _bf16_ok(got, want)


def _nhwc_against_plain(x, t, g, b, dy, dtype, relu):
    """The NHWC pair on (x, t, g, b, dy) against the plain twins: forward,
    backward with and without affine, every output the same bits on a
    second call, out and dx channels-last, three ``norm.nhwc`` calls."""
    assert norm.channels_last(x)
    assert norm._nhwc_plan_for(x) is not None
    assert norm._nhwc_plan_for(x, dy) is not None
    with spans.recording() as rec:
        y, mu, r = norm.cbinorm_fwd(x, t, g, b, 1e-5, relu)
        full = norm.cbinorm_bwd(x, t, g, b, mu, r, dy, relu)
        alone = norm.cbinorm_bwd(x, t, g, b, mu, r, dy, relu, affine=False)
    again = norm.cbinorm_fwd(x, t, g, b, 1e-5, relu)
    full2 = norm.cbinorm_bwd(x, t, g, b, mu, r, dy, relu)
    torch.cuda.synchronize()
    assert rec.counters[(norm.NHWC_COUNTER, None)] == 3
    assert norm.channels_last(y) and norm.channels_last(full[0])
    # the same bits on every call
    assert all(torch.equal(a, c) for a, c in zip((y, mu, r), again))
    assert all(torch.equal(a, c) for a, c in zip(full, full2))
    assert torch.equal(alone[0], full[0])
    assert all(v is None for v in alone[1:])

    yp, mup, rp = norm.cbinorm_plain(x, t, g, b, 1e-5, relu)
    assert _held(y, yp, dtype), _rel(y, yp)
    assert _rel(mu, mup) <= REL_TOL and _rel(r, rp) <= REL_TOL
    # the mask is the kernel's y > 0, which its backward recomputes bit for
    # bit; the plain twin's own can round the other way where y is ~1e-7
    dy_m = dy * (y > 0) if relu else dy
    want = norm.cbinorm_bwd_plain(x, t, g, b, mu, r, dy_m, False)
    assert _held(full[0], want[0], dtype), _rel(full[0], want[0])
    for name, got, w in zip(("dt", "dg", "db"), full[1:], want[1:]):
        assert _rel(got, w) <= REL_TOL, (name, _rel(got, w))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 32, BATCH])
@pytest.mark.parametrize("shape", SHAPES)
def test_nhwc_kernels_match_plain_twin(shape, batch, dtype, relu, dev):
    C, H, W = shape
    x, t, g, b, dy = _inputs(dev, batch, C, H, W, dtype,
                             seed=C * H + batch + int(relu))
    _nhwc_against_plain(x, t, g, b, dy, dtype, relu)


# (vectors of C, H, W, batch): pixel counts that fill no box or cluster
# evenly, and groups of one vector
RAGGED = ((1, 13, 11, 3), (3, 37, 29, 2), (1, 181, 181, 2),
          (8, 127, 129, 2), (5, 66, 66, 5))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vectors, H, W, batch", RAGGED)
def test_nhwc_kernels_ragged_and_narrow(vectors, H, W, batch, dtype, relu,
                                        dev):
    C = vectors * 128 // torch.finfo(dtype).bits  # 16 bytes a vector
    x, t, g, b, dy = _inputs(dev, batch, C, H, W, dtype,
                             seed=H * W + C + int(relu))
    _nhwc_against_plain(x, t, g, b, dy, dtype, relu)


@pytest.mark.parametrize("what, B, C, H, W", [
    ("above the NHWC plan's pixels", 2, 64, 512, 512),
    ("C not a whole number of vectors", 2, 12, 16, 16),
])
def test_channels_last_without_plan_takes_nchw_kernels(what, B, C, H, W,
                                                       dev):
    """A channels-last x with no NHWC plan (bf16: C a multiple of 8 here
    only for the first case) runs the NCHW kernels on a copy: the plain
    twin's values, out and dx channels-last, no ``norm.nhwc``."""
    x, t, g, b, dy = _inputs(dev, B, C, H, W, torch.bfloat16, seed=3)
    assert norm._nhwc_plan_for(x, dy) is None, what
    with spans.recording() as rec:
        y, mu, r = norm.cbinorm_fwd(x, t, g, b, 1e-5, True)
        dx = norm.cbinorm_bwd(x, t, g, b, mu, r, dy, True)[0]
    torch.cuda.synchronize()
    assert (norm.NHWC_COUNTER, None) not in rec.counters
    assert norm.channels_last(y) and norm.channels_last(dx)
    yp = norm.cbinorm_plain(x, t, g, b, 1e-5, True)[0]
    want = norm.cbinorm_bwd_plain(x, t, g, b, mu, r, dy * (y > 0), False)[0]
    assert _bf16_ok(y, yp) and _bf16_ok(dx, want)


def test_nchw_x_keeps_the_nchw_kernels(dev):
    x, t, g, b, dy = _inputs(dev, 4, 64, 32, 32, torch.float32, seed=5)
    x, dy = x.contiguous(), dy.contiguous()
    with spans.recording() as rec:
        y, mu, r = norm.cbinorm_fwd(x, t, g, b, 1e-5, False)
        dx = norm.cbinorm_bwd(x, t, g, b, mu, r, dy, False)[0]
    torch.cuda.synchronize()
    assert (norm.NHWC_COUNTER, None) not in rec.counters
    assert y.is_contiguous() and dx.is_contiguous()
    # the two pairs agree on the same values
    y2, _, _ = norm.cbinorm_fwd(x.contiguous(memory_format=torch
                                             .channels_last), t, g, b)
    assert _rel(y2, y) <= REL_TOL


@pytest.mark.parametrize("shape, dtype, pool", [
    ((256, 3, 128, 128), torch.float32, (3, 2, 1, False)),  # D's copy
    ((256, 64, 62, 62), torch.bfloat16, (2, 2, 0, True)),   # the encoder's
    ((256, 512, 7, 7), torch.bfloat16, (2, 2, 0, True)),
    ((64, 128, 31, 31), torch.bfloat16, (3, 2, 1, True)),
])
def test_channels_last_avg_pool_matches_nchw(shape, dtype, pool, dev):
    """``layers.avg_pool2d`` on a channels-last CUDA x gives CUDA's NCHW
    pool's output bit for bit and its gradient within one bf16 rounding
    (sums in another order), both channels-last."""
    k, s, p, cip = pool
    gen = torch.Generator(device=dev).manual_seed(7)
    x = (torch.rand(shape, generator=gen, device=dev) * 2 - 1).to(dtype)
    xs = [x.clone().requires_grad_(True),
          x.contiguous(memory_format=torch.channels_last)
          .requires_grad_(True)]
    want = F.avg_pool2d(xs[0], k, s, p, count_include_pad=cip)
    got = layers.avg_pool2d(xs[1], k, s, p, count_include_pad=cip)
    dy = torch.randn(want.shape, generator=gen, device=dev).to(dtype)
    want.backward(dy)
    got.backward(dy)
    torch.cuda.synchronize()
    assert norm.channels_last(got) and norm.channels_last(xs[1].grad)
    assert torch.equal(got, want)
    tol = 1e-6 if dtype == torch.float32 else 2 ** -6
    assert float((xs[1].grad.float() - xs[0].grad.float()).abs().max()) \
        <= tol * float(xs[0].grad.float().abs().max())


# ---- the graphed train step against the eager one
#
# The graphed step launches the eager step's kernels on the same inputs
# and draws, with the same (capturable) Adam.  So, from one state, the
# first step's errD and loss_cycle (computed before any backward) are equal
# bit for bit, and at full size so are D's parameters after the first
# step's k updates (D's backward adds in a fixed order there: bit-equal in
# every eager and graphed run on the card).  The backward through the
# encoder's reflect pads and overlapping pools adds with atomics, whose
# order moves the last bits: the G and E of two eager runs, whose
# gradients pass through it, differ after every step, and Adam's
# normalised step carries that into every later number.
# Whether the first step's later losses and first moments differ at all
# is a draw of that order (some eager pairs equal, some not, on the card),
# so those numbers are held to the cell's limit alone.  The numbers that
# sum the divergence over the steps, FOLLOWED, are held to GAP_RATIO times
# the largest of the same number between EAGER_TWINS more eager runs and
# the first, all from the same state, and to the cell's limit
# (benchmark/harness/train.py::compare, benchmark/limits/; PERF.md
# section 2).

GAP_RATIO = 3
EAGER_TWINS = 3
FOLLOWED = ("loss_gap", "change_gap", "change_gap_median")
# computed before any backward: bit for bit on every path
EXACT_FIRST = ("errD", "loss_cycle")

CELLS = {"01_proposed_singlegan_k5": "singlegan_k5.train_b128",
         "05_srgan_full": "srgan_full.train_b128"}


def _limits(preset):
    path = os.path.join(os.path.dirname(__file__), os.pardir, "benchmark",
                        "limits", CELLS[preset] + ".json")
    with open(path) as f:
        return json.load(f)


def _step_cfg(preset, size=None, **train):
    """``preset`` in bf16; ``size``: a small model (64 px, nch 8) at that
    batch."""
    cfg = PRESETS[preset]()
    model = cfg.model
    train = {"compute_dtype": "bfloat16", **train}
    if size is not None:
        model = dataclasses.replace(model, image_size=64, g_nch=8,
                                    g_res_num=1, d_nch=8, d_num_cls=2,
                                    e_nch=8, e_num_cls=2)
        train["batch_size"] = size
    return dataclasses.replace(cfg, model=model, train=dataclasses.replace(
        cfg.train, **train))


def _step_batch(cfg, dev, seed, b=None):
    m, b = cfg.model, b or cfg.train.batch_size
    gen = torch.Generator(device=dev).manual_seed(seed)
    src = torch.randint(0, m.n_classes, (b,), generator=gen, device=dev)
    return {"image": torch.rand((b, m.image_size, m.image_size, m.nch_in),
                                generator=gen, device=dev) * 2 - 1,
            "source_label": src,
            "target_label": (src + torch.randint(
                1, m.n_classes, (b,), generator=gen, device=dev))
            % m.n_classes}


def _trainer(cfg, dev, graphed: bool):
    t = GANTrainer(cfg, dev)
    st = t.init_state(torch.Generator().manual_seed(0),
                      freeze_pretrained=cfg.pretrained_encoder)
    if not graphed:
        t._graphable = lambda: False
    return t, st


NETS = ("G", "D", "E")


def _nets(st):
    return dict(zip(NETS, (st.G, st.D, st.E)))


def _record(t, st, steps):
    """``benchmark/harness/train.py::record_check``'s record of ``steps``
    ((batch, epoch) pairs): the losses of each, Adam's first moments after
    the first, the parameters after the last."""
    opts = dict(zip(NETS, (st.opt_g, st.opt_d, st.opt_e)))
    rec = {"losses": []}
    for i, (b, epoch) in enumerate(steps):
        rec["losses"].append({k: float(v)
                              for k, v in t.step(st, b, epoch).items()})
        if i == 0:
            rec["d_first"] = [p.detach().float().cpu().clone()
                              for p in st.D.parameters()]
            rec["moments"] = {
                k: {n: opts[k].state[p]["exp_avg"].float().cpu().clone()
                    for n, p in net.named_parameters() if p in opts[k].state}
                for k, net in _nets(st).items()}
    torch.cuda.synchronize()
    rec["params"] = {k: {n: p.detach().float().cpu().clone()
                         for n, p in net.named_parameters()}
                     for k, net in _nets(st).items()}
    return rec


def _same_state(dst_t, dst, src_t, src):
    """``dst``'s nets, Adam's state and step and its trainer's generator
    set to ``src``'s in place, so its graphs stay valid."""
    with torch.no_grad():
        for a, b in zip(_nets(dst).values(), _nets(src).values()):
            for x, y in zip(a.state_dict().values(),
                            b.state_dict().values()):
                x.copy_(y)
        for oa, ob in zip((dst.opt_g, dst.opt_d, dst.opt_e),
                          (src.opt_g, src.opt_d, src.opt_e)):
            for pa, pb in zip([p for g in oa.param_groups
                               for p in g["params"]],
                              [p for g in ob.param_groups
                               for p in g["params"]]):
                for key, v in oa.state[pa].items():
                    v.copy_(ob.state[pb][key])
    dst.step = src.step
    dst_t.rng.set_state(src_t.rng.get_state())


def _graphed_against_eager(preset, cfg, dev, warm, steps, exact_d=False):
    """1 + EAGER_TWINS eager trainers and a graphed one from the same
    weights through the ``warm`` steps (the graphed one captures there),
    every other one then set to the first eager one's state, and all
    through ``steps``: the graphed record against the first eager one,
    each number of the benchmark's comparison under the cell's limit, the
    FOLLOWED ones under GAP_RATIO times the eager twins' largest too;
    ``exact_d``: D after the first step bit-equal as well."""
    from benchmark.harness.train import compare

    eagers = [_trainer(cfg, dev, graphed=False)
              for _ in range(1 + EAGER_TWINS)]
    tg, sg = _trainer(cfg, dev, graphed=True)
    for seed, b, epoch in warm:
        batch = _step_batch(cfg, dev, seed, b)
        for t, st in eagers + [(tg, sg)]:
            t.step(st, batch, epoch)
    te, se = eagers[0]
    for t, st in eagers[1:] + [(tg, sg)]:
        _same_state(t, st, te, se)
    initial = {k: {n: p.detach().float().cpu().clone()
                   for n, p in net.named_parameters()}
               for k, net in _nets(se).items()}
    batches = [(_step_batch(cfg, dev, seed, b), epoch)
               for seed, b, epoch in steps]
    eager = dict(_record(te, se, batches), initial=initial)
    twins = [_record(t, st, batches) for t, st in eagers[1:]]
    made = dict(tg._graphs)
    graphed = _record(tg, sg, batches)
    # every step replayed graphs captured in the warm-up, and drew what
    # the eager steps drew
    assert all(g is not None for g in made.values())
    assert all(tg._graphs[k] is made[k] for k in made)
    assert {(b or cfg.train.batch_size) for _, b, _ in steps} <= \
        {k[0] for k in made}
    assert torch.equal(tg.rng.get_state(), te.rng.get_state())
    for k in EXACT_FIRST:
        assert all(rec["losses"][0][k] == eager["losses"][0][k]
                   for rec in twins + [graphed]), k
    if exact_d:
        for rec in twins + [graphed]:
            assert all(torch.equal(a, b) for a, b in
                       zip(rec["d_first"], eager["d_first"]))
    numbers = compare(graphed, eager)
    twin_gaps = [compare(twin, eager) for twin in twins]
    eager_gaps = {k: max(g[k] for g in twin_gaps) for k in numbers}
    print(f"{preset}: graphed against eager {numbers}; eager against "
          f"eager, the largest of {EAGER_TWINS} {eager_gaps}")
    for k in FOLLOWED:
        assert numbers[k] <= GAP_RATIO * eager_gaps[k], \
            (k, numbers, eager_gaps)
    for k, limit in _limits(preset).items():
        assert numbers[k] <= limit, (k, numbers)
    return numbers


@pytest.mark.parametrize("preset", sorted(CELLS))
def test_graphed_step_matches_eager_at_full_size(preset, dev):
    """Batch 128, 128 px, bf16: three replayed steps against three eager
    steps from the same weights, batches and draws."""
    cfg = _step_cfg(preset)
    _graphed_against_eager(preset, cfg, dev, [(0, None, 0), (1, None, 0)],
                           [(s, None, 0) for s in range(2, 5)],
                           exact_d=True)


@pytest.mark.parametrize("preset, train", [
    ("01_proposed_singlegan_k5", dict(unrolled_restore=True,
                                      encoded_feature="latent")),
    ("01_proposed_singlegan_k5", dict(unrolled_k=1,
                                      unrolled_restore=True)),
    ("05_srgan_full", dict(unrolled_restore=True, encoded_feature="latent",
                           lr_gamma=0.5)),
])
def test_graphed_step_options_partial_batch_and_epoch(preset, train, dev):
    """64 px, nch 8, batch 8, the option's segments: warm-up at batch 8 and
    at a partial batch of 5 (graphs of its own), then both sizes replayed
    across an epoch change (new rates in the same tensors, no new
    capture)."""
    cfg = _step_cfg(preset, size=8, **train)
    _graphed_against_eager(
        preset, cfg, dev, [(0, None, 0), (1, None, 0), (2, 5, 0), (3, 5, 0)],
        [(4, None, 0), (5, 5, 1), (6, None, 1)])


def test_resume_from_a_graphed_checkpoint(dev, tmp_path):
    """A checkpoint written mid-run by the graphed step keeps a plain
    Adam's layout, and a new graphed trainer resumed from it (an eager
    step, a capture, a replay) steps as the run it was saved from goes on
    (replays), by the benchmark's comparison."""
    from benchmark.harness.train import compare

    cfg = _step_cfg("05_srgan_full", size=8)
    t, st = _trainer(cfg, dev, graphed=True)
    for seed in range(3):
        t.step(st, _step_batch(cfg, dev, seed))
    save_checkpoint(str(tmp_path), st, st.step)
    rng = t.rng.get_state()
    initial = {k: {n: p.detach().float().cpu().clone()
                   for n, p in net.named_parameters()}
               for k, net in _nets(st).items()}
    batches = [(_step_batch(cfg, dev, seed), 0) for seed in range(3, 6)]
    go_on = dict(_record(t, st, batches), initial=initial)
    saved = torch.load(os.path.join(tmp_path, "step_3", TRAIN_STATE_FILE),
                       map_location="cpu", weights_only=True)
    # Adam steps in 3 train steps: G twice a step, D k times, E once
    k = cfg.train.unrolled_k
    for opt, n in (("opt_g", 6), ("opt_d", 3 * k), ("opt_e", 3)):
        group = saved[opt]["param_groups"][0]
        assert type(group["lr"]) is float and not group["capturable"]
        steps = [s["step"] for s in saved[opt]["state"].values()]
        assert all(s.device.type == "cpu" and float(s) == n for s in steps)
    t2, st2 = _trainer(cfg, dev, graphed=True)
    restore_checkpoint(str(tmp_path), st2)
    t2.rng.set_state(rng)
    resumed = _record(t2, st2, batches)
    for k in EXACT_FIRST:
        assert resumed["losses"][0][k] == go_on["losses"][0][k], k
    assert list(t2._graphs) == [(8, "bfloat16")]
    assert t2._graphs[(8, "bfloat16")] is not None
    assert st2.opt_g.param_groups[0]["capturable"]
    numbers = compare(resumed, go_on)
    print(f"resumed against the run it was saved from {numbers}")
    for key, limit in _limits("05_srgan_full").items():
        assert numbers[key] <= limit, (key, numbers)
