"""The port's losses (``srgan_tpu_torch/ops/losses.py``) and the plain twins
of its histogram and fused-diversification kernels on the CPU against the
JAX package: ``srgan_tpu/ops/losses.py`` and the Pallas kernels run in
interpret mode.  Inputs from numpy with a seed.  fp32; tolerance 1e-5
relative (plus 1e-6 absolute for entries near 0): sums in another order
over at most a few hundred terms."""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srgan_tpu.configs import LossWeights as JLossWeights
from srgan_tpu.ops import losses as JL
from srgan_tpu.ops.pallas.diversification import _reference_jnp
from srgan_tpu.ops.pallas.diversification import (
    fused_diversification as jax_fused_diversification,
)
from srgan_tpu.ops.pallas.histogram import (
    soft_histogram_cols as jax_soft_histogram_cols,
)
from srgan_tpu_torch.configs import LossWeights
from srgan_tpu_torch.ops import diversification, histogram
from srgan_tpu_torch.ops import losses as L
from srgan_tpu_torch.utils import spans

TOL = dict(rtol=1e-5, atol=1e-6)
N, D = 32, 8


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    mu = (rng.standard_normal((N, D)) * 1.3 + 0.2).astype(np.float32)
    target = np.asarray(JL.histogram_target(jax.random.PRNGKey(0)))
    return types.SimpleNamespace(mu=mu, target=target, rng=rng)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **TOL)


# ---------------------------------------------------------------------------
# the soft histogram (Pallas rows 2 and 3)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("oracle", ["pallas", "jnp"])
def test_soft_histogram_cols_forward_and_gradient(data, oracle):
    gh = data.rng.standard_normal((D, 50)).astype(np.float32)
    if oracle == "pallas":
        fn = jax_soft_histogram_cols
    else:
        def fn(m):
            return jax.vmap(JL.gaussian_histogram, in_axes=1)(m)
    mu = jnp.asarray(data.mu)
    want = fn(mu)
    want_grad = jax.grad(lambda m: jnp.sum(fn(m) * gh))(mu)

    mu_t = _t(data.mu, grad=True)
    got = histogram.soft_histogram_cols(mu_t)
    assert got.grad_fn is not None
    (got * _t(gh)).sum().backward()
    _close(got, want)
    _close(mu_t.grad, want_grad)


def test_soft_histogram_plain_twins_agree(data):
    """The closed-form backward twin equals autograd of the forward twin."""
    gh = _t(data.rng.standard_normal((D, 50)).astype(np.float32))
    mu_t = _t(data.mu, grad=True)
    (histogram.soft_histogram_cols_plain(mu_t) * gh).sum().backward()
    _close(histogram.soft_histogram_cols_bwd_plain(_t(data.mu), gh),
           mu_t.grad.numpy())


BAD_HIST_INPUTS = {
    "float64": lambda mu, gh: (mu.double(), gh),
    "non_contiguous": lambda mu, gh: (mu.T.contiguous().T, gh),
    "empty": lambda mu, gh: (mu[:0], gh),
    "gh_shape": lambda mu, gh: (mu, gh.T.contiguous()),
}


@pytest.mark.parametrize("case", sorted(BAD_HIST_INPUTS) + ["cpu_is_plain"])
def test_soft_histogram_wrapper_contract(data, case):
    """The wrappers refuse what the kernels do not take, with ValueError,
    and on a CPU tensor return the plain twins' bits."""
    mu = _t(data.mu)
    gh = _t(data.rng.standard_normal((D, 50)).astype(np.float32))
    if case == "cpu_is_plain":
        h = histogram.soft_histogram_fwd(mu)
        assert torch.equal(h, histogram.soft_histogram_cols_plain(mu))
        assert torch.equal(histogram.soft_histogram_bwd(mu, gh),
                           histogram.soft_histogram_cols_bwd_plain(mu, gh))
        mu_g = _t(data.mu, grad=True)
        got = histogram.soft_histogram_cols(mu_g)
        got.backward(gh)
        assert torch.equal(got.detach(), h)
        assert torch.equal(mu_g.grad,
                           histogram.soft_histogram_cols_bwd_plain(mu, gh))
        return
    bad_mu, bad_gh = BAD_HIST_INPUTS[case](mu, gh)
    if case != "gh_shape":
        with pytest.raises(ValueError):
            histogram.soft_histogram_fwd(bad_mu)
    with pytest.raises(ValueError):
        histogram.soft_histogram_bwd(bad_mu, bad_gh)


# ---------------------------------------------------------------------------
# the fused diversification loss (Pallas row 4)
# ---------------------------------------------------------------------------

# (B, D, bins) beside the module's (N, D, 50): batch 2, a ragged shape,
# more dimensions than a cluster has blocks, and a batch of 2,048, above the
# 1,476 the old one-block kernel's 48 KB of shared memory took
DIV_SHAPES = ((2, 8, 50), (37, 3, 7), (128, 20, 50), (2048, 8, 50))
DIV_CASES = [pytest.param(o, None, id=o) for o in ("pallas", "jnp")] + [
    pytest.param(o, s, id=f"{o}-{s[0]}x{s[1]}x{s[2]}")
    for s in DIV_SHAPES for o in ("pallas", "jnp")]


@pytest.mark.parametrize("oracle, shape", DIV_CASES)
def test_fused_diversification_values_and_gradient(data, oracle, shape):
    w = np.asarray([10.0, 100.0, 100.0], np.float32)
    if shape is None:
        mu_np, target_np, n_cfg, bins = data.mu, data.target, 32, 50
    else:
        B, Dm, bins = shape
        rng = np.random.default_rng(B * 1000 + Dm * 10 + bins)
        mu_np = (rng.standard_normal((B, Dm)) * 1.3 + 0.2).astype(np.float32)
        target_np = np.asarray(JL.histogram_target(jax.random.PRNGKey(0),
                                                   bins))
        n_cfg = B
    target = jnp.asarray(target_np)
    if oracle == "pallas":
        def fn(m):
            return jax_fused_diversification(m, target, n_cfg, bins)
    else:
        def fn(m):
            return _reference_jnp(m, target, n_cfg, bins, -10.0, 10.0, 0.2)
    mu = jnp.asarray(mu_np)
    want = fn(mu)
    want_grad = jax.grad(lambda m: jnp.sum(fn(m) * w))(mu)

    mu_t = _t(mu_np, grad=True)
    got = diversification.fused_diversification(mu_t, _t(target_np), n_cfg,
                                                bins)
    (got * _t(w)).sum().backward()
    _close(got, want)
    _close(mu_t.grad, want_grad)


BAD_DIV_INPUTS = {
    "float64": lambda mu, t: (mu.double(), t),
    "non_contiguous": lambda mu, t: (mu.T.contiguous().T, t),
    "batch_1": lambda mu, t: (mu[:1], t),
    "dim_1": lambda mu, t: (mu[:, :1].contiguous(), t),
    # D * D pair indexes past 2^31
    "dim_46341": lambda mu, t: (torch.zeros((2, 46341)), t),
    "target_length": lambda mu, t: (mu, t[:-1].contiguous()),
    "target_device": lambda mu, t: (mu, t.to("meta")),
}


def _launches(totals):
    """The kernels' launch counters among the ``spans.totals()``."""
    return {k: v for k, v in totals.items() if k.startswith("launch.")}


@pytest.mark.parametrize("case", sorted(BAD_DIV_INPUTS) + ["cpu_is_plain"])
def test_fused_diversification_wrapper_contract(data, case):
    """The wrapper refuses what the kernel does not take, with ValueError,
    and on a CPU tensor returns the plain twin's bits without counting a
    launch."""
    mu, target = _t(data.mu), _t(data.target)
    before = _launches(spans.totals())
    if case == "cpu_is_plain":
        want = diversification.diversification_plain(mu, target, 32)
        assert torch.equal(
            diversification.diversification_fwd(mu, target, 32), want)
        got = diversification.fused_diversification(mu, target, 32)
        assert torch.equal(got, want)
        assert _launches(spans.totals()) == before
        return
    with pytest.raises(ValueError):
        diversification.diversification_fwd(
            *BAD_DIV_INPUTS[case](mu, target), 32)
    assert _launches(spans.totals()) == before


@pytest.mark.parametrize("Dm", [2, 3, 7, 8, 9, 20, 600])
def test_fused_diversification_plan(Dm):
    """K is 1 to 8 blocks and at most D, so that every block owns a column
    and the blocks' columns d = r, r + K, ... cover every dimension once."""
    K = diversification.plan(Dm)
    assert 1 <= K <= diversification.MAX_CLUSTER and K <= Dm
    cols = [d for r in range(K) for d in range(r, Dm, K)]
    assert sorted(cols) == list(range(Dm))
    assert all(len(range(r, Dm, K)) >= 1 for r in range(K))


# ---------------------------------------------------------------------------
# every loss of ops/losses.py
# ---------------------------------------------------------------------------

def _two_scales(rng, shapes=((4, 3, 3, 1), (4, 1, 1, 1))):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def test_elementwise_losses(data):
    rng = data.rng
    a, b = (rng.standard_normal((4, 3, 8, 8)).astype(np.float32)
            for _ in range(2))
    _close(L.l1_loss(_t(a), _t(b)), JL.l1_loss(a, b))
    outs = _two_scales(rng)
    for target in (0.0, 1.0):
        _close(L.lsgan_loss([_t(o) for o in outs], target),
               JL.lsgan_loss([jnp.asarray(o) for o in outs], target))
    for mask in ([1, 0, 1, 1], [0, 0, 0, 0]):
        m = np.asarray(mask, np.float32)
        _close(L.masked_lsgan_loss([_t(o) for o in outs], 1.0, _t(m)),
               JL.masked_lsgan_loss([jnp.asarray(o) for o in outs], 1.0,
                                    jnp.asarray(m)))
    probs = [np.asarray(jax.nn.softmax(rng.standard_normal((4, 4)), -1),
                        np.float32) for _ in range(2)]
    onehot = np.eye(4, dtype=np.float32)[[0, 3, 1, 1]]
    _close(L.domain_classification_loss([_t(p) for p in probs], _t(onehot)),
           JL.domain_classification_loss([jnp.asarray(p) for p in probs],
                                         jnp.asarray(onehot)))


def test_distribution_losses(data):
    mu = data.mu
    logvar = (data.rng.standard_normal((N, D)) * 0.3).astype(np.float32)
    _close(L.kl_loss(_t(mu), _t(logvar)), JL.kl_loss(mu, logvar))
    # n_batch is the configured batch, not the one given (quirk #12)
    _close(L.batch_kl_loss(_t(mu), 128), JL.batch_kl_loss(mu, 128))
    _close(L.corrcoef(_t(mu.T)), JL.corrcoef(jnp.asarray(mu.T)))
    _close(L.corrcoef_loss(_t(mu.T)), JL.corrcoef_loss(jnp.asarray(mu.T)))
    _close(L.gaussian_histogram(_t(mu[:, 0])),
           JL.gaussian_histogram(jnp.asarray(mu[:, 0])))
    for use_kernel in (None, False):
        _close(L.histogram_imitation_loss(_t(mu), _t(data.target),
                                          use_kernel=use_kernel),
               JL.histogram_imitation_loss(jnp.asarray(mu),
                                           jnp.asarray(data.target),
                                           use_pallas=False))


def test_histogram_target_is_normalized():
    t = L.histogram_target(torch.Generator().manual_seed(1))
    assert t.shape == (50,) and t.dtype == torch.float32
    assert float(t.sum()) == pytest.approx(1.0, abs=1e-3)
    assert bool((t > 0).all())


GATES = {
    # tests/test_losses.py:115: corr and hist fire only under batch_KL > 0
    "batch_kl_off": dict(KL=0.0, batch_KL=0.0, corr_enc=100.0, hist=100.0),
    "proposed": dict(KL=0.0, batch_KL=10.0, corr_enc=100.0, hist=100.0),
    "proposed_fused": dict(KL=0.0, batch_KL=10.0, corr_enc=100.0,
                           hist=100.0),
    "no_corr": dict(KL=0.0, batch_KL=10.0, corr_enc=0.0, hist=100.0),
    "no_hist_fused": dict(KL=0.0, batch_KL=10.0, corr_enc=100.0, hist=0.0),
    "kl_only": dict(KL=0.1, batch_KL=0.0, corr_enc=0.0, hist=0.0),
}


@pytest.mark.parametrize("case", sorted(GATES))
def test_diversification_loss_gating(data, case):
    w = GATES[case]
    use_kernel = True if case.endswith("_fused") else None
    mu = data.mu[:16]
    logvar = (data.rng.standard_normal((16, D)) * 0.3).astype(np.float32)
    want, want_m = JL.diversification_loss(
        jnp.asarray(mu), jnp.asarray(logvar), weights=JLossWeights(**w),
        n_batch=16, hist_target=jnp.asarray(data.target), use_pallas=False)
    mu_t = _t(mu, grad=True)
    got, got_m = L.diversification_loss(
        mu_t, _t(logvar), weights=LossWeights(**w), n_batch=16,
        hist_target=_t(data.target), use_kernel=use_kernel)
    assert set(got_m) == set(want_m)
    if case == "batch_kl_off":
        assert float(got) == 0.0 and got_m == {}
        return
    _close(got, want)
    for k in want_m:
        _close(got_m[k], want_m[k])
    want_grad = jax.grad(lambda m: JL.diversification_loss(
        m, jnp.asarray(logvar), weights=JLossWeights(**w), n_batch=16,
        hist_target=jnp.asarray(data.target), use_pallas=False)[0])(
            jnp.asarray(mu))
    got.backward()
    _close(mu_t.grad, want_grad)


def test_loss_weights_fields_match_jax():
    assert ([f.name for f in dataclasses.fields(LossWeights)]
            == [f.name for f in dataclasses.fields(JLossWeights)])
