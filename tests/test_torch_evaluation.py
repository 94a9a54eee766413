"""The port's PRDC evaluation (``srgan_tpu_torch/evaluation``,
``training/vgg_finetune.py``, ``finetune_vgg.py``) against ``srgan_tpu``
on the CPU: VGG19-BN at 224 px, batch 2.  The two CLIs' end-to-end runs
are in ``tests/test_torch_evaluation_cli.py``.

Both sides hold the same weights: a JAX init, its batch-norm statistics
and affine perturbed from a numpy seed (so that a miswired running
statistic cannot hide behind mean 0 and variance 1), carried over by
``vgg_state_dict_from_jax``.  Tolerances:

  - ``preprocess_for_vgg``: bit-equal (the same numpy and PIL calls);
  - features and scores: 1e-4 of the largest entry (fp32 sums in another
    order through 16 convolutions and batch norms);
  - one fine-tune step: loss 1e-4; running mean and variance 1e-5 of each
    tensor's largest entry, the variance the biased one (with torch's own
    ``BatchNorm2d``, which keeps the unbiased one, the last layer's would
    be 3.9e-4 away); the
    parameters by the Adam-sign-tolerant criterion of
    ``tests/test_torch_train.py``;
  - PRDC: the same counts as the JAX package and the ``prdc`` package:
    the fractions equal the package's (float64) and the JAX package's
    (fp32) at 1e-6, also end to end on inputs whose comparisons sit far
    from ties.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from srgan_tpu.evaluation import GANEvaluation as JGANEvaluation
from srgan_tpu.evaluation import compute_prdc as jcompute_prdc
from srgan_tpu.evaluation import evaluation_init as jevaluation_init
from srgan_tpu.evaluation.features import VGG19BN as JVGG19BN
from srgan_tpu.evaluation.features import init_vgg as jinit_vgg
from srgan_tpu.evaluation.features import (
    preprocess_for_vgg as jpreprocess_for_vgg,
)
from srgan_tpu.evaluation.harness import comparison_table as jcomparison_table
from srgan_tpu.evaluation.prdc import compute_prdc_numpy as jprdc_numpy
from srgan_tpu.training.vgg_finetune import VGGFinetuneTrainer as JFinetune
from srgan_tpu.utils.checkpoint import export_torch_vgg
from srgan_tpu_torch.evaluation import GANEvaluation, compute_prdc
from srgan_tpu_torch.evaluation import evaluation_init
from srgan_tpu_torch.evaluation.features import (
    VGG19BN,
    init_vgg,
    load_vgg,
    pool_to_7,
    preprocess_for_vgg,
)
from srgan_tpu_torch.evaluation.harness import comparison_table
from srgan_tpu_torch.evaluation.prdc import (
    compute_prdc_numpy,
    kth_nn_radii,
    pairwise_distances,
)
from srgan_tpu_torch.finetune_vgg import imagenet_start
from srgan_tpu_torch.training.vgg_finetune import VGGFinetuneTrainer
from srgan_tpu_torch.utils.checkpoint import vgg_state_dict_from_jax
from vendor_prdc import compute_prdc as vendor_prdc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEAT_TOL = 1e-4
LOSS_TOL = 1e-4
STATS_TOL = 1e-5
LR = 5e-5


def _perturbed(variables, seed):
    """The variables as numpy with every batch-norm scale, bias, mean and
    variance drawn anew from ``seed``."""
    rng = np.random.default_rng(seed)
    v = jax.tree.map(lambda a: np.array(a), variables)
    for name in v["batch_stats"]:
        c = v["batch_stats"][name]["mean"].shape
        v["batch_stats"][name]["mean"] = rng.normal(0, 0.1, c).astype(
            np.float32)
        v["batch_stats"][name]["var"] = rng.uniform(0.5, 1.5, c).astype(
            np.float32)
        v["params"][name]["scale"] = rng.uniform(0.7, 1.3, c).astype(
            np.float32)
        v["params"][name]["bias"] = rng.normal(0, 0.05, c).astype(np.float32)
    return v


@pytest.fixture(scope="module")
def vgg1000():
    return _perturbed(jinit_vgg(jax.random.PRNGKey(0))[1], 0)


def _sd(variables):
    return vgg_state_dict_from_jax(variables["params"],
                                   variables["batch_stats"])


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def test_preprocess_is_bit_equal():
    rng = np.random.default_rng(1)
    for shape in ((3, 128, 128, 3), (2, 64, 64, 3), (1, 32, 32, 1)):
        imgs = rng.uniform(-1, 1, shape).astype(np.float32)
        got, want = preprocess_for_vgg(imgs), jpreprocess_for_vgg(imgs)
        assert got.shape == (shape[0], 224, 224, 3)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_vgg_state_dict_is_the_torchvision_layout(vgg1000):
    """The bridge gives the JAX package's own torchvision export, which
    the port's net loads with strict=True."""
    sd = _sd(vgg1000)
    ref = export_torch_vgg(vgg1000)
    assert list(sd) == list(ref)
    for k in sd:
        assert np.array_equal(sd[k].numpy(), np.asarray(ref[k])), k
    assert list(VGG19BN().state_dict()) == list(sd)
    assert load_vgg(sd).num_classes == 1000


def test_features_and_scores_match_jax(vgg1000):
    x = np.random.default_rng(2).standard_normal(
        (2, 224, 224, 3)).astype(np.float32)
    model = load_vgg(_sd(vgg1000))
    jmodel = JVGG19BN(num_classes=1000)
    with torch.inference_mode():
        for output in ("feature", "score"):
            got = model(_nchw(x), output=output).numpy()
            want = np.asarray(jmodel.apply(vgg1000, x, output=output))
            assert got.shape == want.shape
            assert _rel(got, want) <= FEAT_TOL, (output, _rel(got, want))


def test_pool_to_7_is_the_jax_pool():
    """At 7x7 and 14x14 it is AdaptiveAvgPool2d(7); at 8x8 the JAX
    package's window h // 7 = 1 keeps 8x8, where torchvision's adaptive
    pool gives 7x7 (a known difference, kept)."""
    rng = np.random.default_rng(3)
    for h in (7, 14, 8):
        x = rng.standard_normal((2, h, h, 5)).astype(np.float32)
        got = pool_to_7(_nchw(x)).permute(0, 2, 3, 1).numpy()
        win = h // 7
        want = x if h == 7 else np.asarray(
            fnn.avg_pool(x, (win, win), strides=(win, win)))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        if h != 8:
            np.testing.assert_allclose(
                got, F.adaptive_avg_pool2d(_nchw(x), 7).permute(
                    0, 2, 3, 1).numpy(), atol=1e-6, rtol=0)
    assert got.shape[1] == 8


def test_init_vgg_is_torchvision_default():
    model = init_vgg(torch.Generator().manual_seed(0), num_classes=4)
    model.requires_grad_(False)
    conv, bn, lin = model.features[0], model.features[1], \
        model.classifier[6]
    assert lin.out_features == 4 and float(lin.bias.abs().max()) == 0
    assert float(conv.bias.abs().max()) == 0
    assert float(bn.weight.min()) == float(bn.weight.max()) == 1.0
    assert abs(float(conv.weight.std()) - (2 / (9 * 64)) ** 0.5) < 0.01
    assert abs(float(model.classifier[3].weight.std()) - 0.01) < 1e-4
    again = init_vgg(torch.Generator().manual_seed(0), num_classes=4)
    assert torch.equal(again.features[0].weight, conv.weight)


def test_finetune_step_matches_jax():
    """One fine-tune step in train mode: the loss, the biased running
    variance and the parameters against the JAX step."""
    v4 = _perturbed(jinit_vgg(jax.random.PRNGKey(1), num_classes=4)[1], 1)
    sd = _sd(v4)
    x = np.random.default_rng(4).standard_normal(
        (2, 224, 224, 3)).astype(np.float32)
    y = np.array([0, 3])
    jt = JFinetune(n_classes=4, lr=LR)
    jstate = jt.init_state(jax.random.PRNGKey(0), jax.tree.map(
        jnp.array, v4))
    jstate, jm = jt.step(jstate, x, y, preprocessed=True)
    t = VGGFinetuneTrainer(n_classes=4, lr=LR, device="cpu")
    state = t.init_state(state_dict=sd)
    m = t.step(state, x, y, preprocessed=True)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                             abs=LOSS_TOL)
    assert float(m["accuracy"]) == float(jm["accuracy"])
    got = state.model.state_dict()
    want = _sd({"params": jax.tree.map(np.array, jstate.params),
                "batch_stats": jax.tree.map(np.array, jstate.batch_stats)})
    n_stats = 0
    for k in want:
        if k.endswith(("running_mean", "running_var")):
            err = float((got[k] - want[k]).abs().max()
                        / want[k].abs().max())
            assert err <= STATS_TOL, (k, err)
            n_stats += 1
    assert n_stats == 32
    # what torch's own BatchNorm2d would keep: the unbiased variance
    last = [k for k in want if k.endswith("running_var")][-1]
    n = 2 * 14 * 14         # batch 2, the last block's 14 x 14
    unbiased = (want[last] - 0.9 * sd[last]) * n / (n - 1) + 0.9 * sd[last]
    assert float(((unbiased - want[last]).abs() / want[last]).max()) \
        > 10 * STATS_TOL
    d = np.concatenate([
        (got[k] - want[k]).abs().numpy().ravel() for k in want
        if not k.endswith(("running_mean", "running_var",
                           "num_batches_tracked"))])
    assert d.max() <= 2.2 * LR, float(d.max())
    assert d.mean() < 0.02 * LR, float(d.mean())
    assert float((d > 1e-6).mean()) < 0.01


def _prdc_sets():
    local = np.random.default_rng(11)
    real = local.standard_normal((128, 24)).astype(np.float32)
    fake = (local.standard_normal((77, 24)) * 0.8 + 0.5).astype(np.float32)
    yield real, fake, 5
    local = np.random.default_rng(12)
    base = local.standard_normal((20, 8)).astype(np.float32)
    dup_real = np.concatenate([base, base, base])          # every point x3
    dup_fake = np.concatenate([base[:10], base[:10],
                               local.standard_normal((25, 8))
                               .astype(np.float32)])
    for k in (1, 3, 5):
        yield dup_real, dup_fake, k


def test_compute_prdc_matches_jax_and_the_prdc_package():
    """Sets of 45-128 rows (above cdist's 25-row switch to the matrix
    product), and sets where every point has duplicates, whose kth-NN
    radii are exactly 0 for small k."""
    for real, fake, k in _prdc_sets():
        got = compute_prdc(real, fake, nearest_k=k, device="cpu")
        want = jcompute_prdc(real, fake, nearest_k=k)
        pkg = vendor_prdc(real, fake, nearest_k=k)
        for m in got:   # the fractions: float64 here and in the package,
            # fp32 in the JAX package
            assert got[m] == pytest.approx(float(pkg[m]), abs=1e-12), m
            assert got[m] == pytest.approx(want[m], abs=1e-6), m
        ours, theirs = (compute_prdc_numpy(real, fake, k),
                        jprdc_numpy(real, fake, k))
        assert ours == theirs
    x = next(_prdc_sets())[0]
    assert float(pairwise_distances(torch.from_numpy(x),
                                     torch.from_numpy(x)).diag().max()) == 0
    with pytest.raises(ValueError, match="nearest_k"):
        compute_prdc(x[:5], x, nearest_k=5, device="cpu")


def _smooth_images(rng, n):
    base = torch.from_numpy(rng.standard_normal((n, 3, 8, 8))
                            .astype(np.float32))
    t = F.interpolate(base, size=(32, 32), mode="bilinear",
                      align_corners=False)
    return np.tanh(t.numpy() * 1.5).transpose(0, 2, 3, 1)


def test_get_prdc_matches_the_jax_harness(vgg1000):
    """The whole of get_prdc (preprocess, features in batches, PRDC) from
    the same weights.  The inputs are chosen free of near-ties: every
    distance that PRDC compares with a radius is further from it (relative)
    than ten times the largest relative difference between the two sides'
    distances and radii."""
    rng = np.random.default_rng(5)
    true, pred = _smooth_images(rng, 8), _smooth_images(rng, 8)
    ev = GANEvaluation("vgg-ImageNet", state_dict=_sd(vgg1000),
                       device="cpu")
    jev = JGANEvaluation("vgg-ImageNet", variables=vgg1000)
    k = 3
    got = ev.get_prdc(true, pred, nearest_k=k, batch=4)
    want = jev.get_prdc(true, pred, nearest_k=k, batch=4)
    assert set(got) == set(want)
    for m in got:
        assert got[m] == pytest.approx(want[m], abs=1e-6), (got, want)

    def distances(f1, f2):
        f1, f2 = torch.as_tensor(f1), torch.as_tensor(f2)
        return (pairwise_distances(f1, f2), kth_nn_radii(f1, k),
                kth_nn_radii(f2, k))

    d, r1, r2 = distances(ev.get_feature(ev.preprocess(true)),
                          ev.get_feature(ev.preprocess(pred)))
    jd, jr1, jr2 = distances(jev.get_feature(jev.preprocess(true)),
                             jev.get_feature(jev.preprocess(pred)))
    margin = min(float(((d - r1[:, None]).abs() / r1[:, None]).min()),
                 float(((d - r2[None, :]).abs() / r2[None, :]).min()),
                 float(((d.min(1).values - r1).abs() / r1).min()))
    apart = max(float(((a - b).abs() / b).max())
                for a, b in ((d, jd), (r1, jr1), (r2, jr2)))
    assert margin > 10 * apart, (margin, apart)

    same = ev.get_prdc(true, true, nearest_k=k)
    assert same["precision"] == same["coverage"] == same["recall"] == 1.0
    with pytest.raises(ValueError, match="needs weights"):
        GANEvaluation("vgg-CelebA", device="cpu")


def test_evaluation_init_and_comparison_table():
    fes, classes = ["vgg-initialization", "vgg-CelebA"], (0, 1, 2)
    ours, theirs = evaluation_init(fes, classes), jevaluation_init(fes,
                                                                   classes)
    assert ours == theirs
    rng = np.random.default_rng(6)
    for s in classes:
        for t in classes:
            for m in ours["vgg-CelebA"][s][t]:
                vals = rng.uniform(0, 1, 2).tolist()
                ours["vgg-CelebA"][s][t][m] += vals
                theirs["vgg-CelebA"][s][t][m] += vals
    for m in ("precision", "coverage"):
        got = comparison_table(ours, "vgg-CelebA", m, classes)
        assert got.shape == (3, 3)
        assert np.array_equal(got, jcomparison_table(theirs, "vgg-CelebA",
                                                     m, classes))


def test_imagenet_start_replaces_the_head(tmp_path):
    """--imagenet-pth: a torchvision 1000-way state dict, its head swapped
    for a fresh 4-way one; every other tensor as in the file."""
    src = init_vgg(torch.Generator().manual_seed(8)).state_dict()
    path = str(tmp_path / "vgg19_bn.pth")
    torch.save(src, path)
    sd = imagenet_start(path)
    assert sd["classifier.6.weight"].shape == (4, 4096)
    for k, v in src.items():
        if not k.startswith("classifier.6."):
            assert torch.equal(sd[k], v), k
    state = VGGFinetuneTrainer(device="cpu").init_state(state_dict=sd)
    assert state.model.num_classes == 4
