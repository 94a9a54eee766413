"""The port's encoder-classifier pretraining (``srgan_tpu_torch/nn/
encoder.py::EncoderClassifier``, ``training/classifier.py``,
``pretrain_classifier.py``) against ``srgan_tpu`` on the CPU, at 32 px,
e_nch 8, e_num_cls 2, batch 4.

Both sides start from the JAX init, carried over by
``classifier_state_dict_from_jax``.  Tolerances:

  - probabilities, loss and accuracy within 1e-5 (fp32 sums in another
    order through two residual blocks);
  - parameters after Adam steps by the Adam-sign-tolerant criterion of
    ``tests/test_torch_train.py`` (copied below): an early Adam update is
    about lr * sign(grad), so an element whose gradient sits at the fp32
    noise floor may step the other way on the two sides.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srgan_tpu.configs import ClassifierConfig as JClassifierConfig
from srgan_tpu.configs import ModelConfig as JModelConfig
from srgan_tpu.training.classifier import ClassifierTrainer as JTrainer
from srgan_tpu.utils.checkpoint import export_torch_classifier
from srgan_tpu_torch.configs import ClassifierConfig, ModelConfig
from srgan_tpu_torch.nn.encoder import Encoder
from srgan_tpu_torch.training.classifier import ClassifierTrainer
from srgan_tpu_torch.training.loop import load_pretrained_encoder
from srgan_tpu_torch.utils.checkpoint import classifier_state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, B, LR = 32, 4, 1e-4
MODEL = dict(image_size=HW, e_nch=8, e_num_cls=2)
TOL = 1e-5


def _configs(**over):
    return (JClassifierConfig(model=JModelConfig(**MODEL), batch_size=B,
                              **over),
            ClassifierConfig(model=ModelConfig(**MODEL), batch_size=B,
                             **over))


def _numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(-1, 1, (B, HW, HW, 3)).astype(np.float32),
             rng.integers(0, 4, B).astype(np.int32)) for _ in range(n)]


def _assert_param_parity(ours, theirs, n_steps, name):
    """Copied from tests/test_torch_train.py: (a) the bulk of elements
    match tightly, (b) outliers are bounded by n_steps opposite full Adam
    steps, (c) the mean difference is a tiny fraction of one step."""
    assert set(ours) == set(theirs), name
    d = np.concatenate([
        np.abs(ours[k].detach().cpu().numpy().astype(np.float32)
               - theirs[k].numpy().astype(np.float32)).ravel()
        for k in sorted(ours)])
    assert d.max() <= 2.2 * n_steps * LR, (name, float(d.max()))
    assert d.mean() < 0.02 * LR, (name, float(d.mean()))
    frac = float((d > 1e-6).mean())
    assert frac < 0.01, (name, frac)


@pytest.fixture(scope="module")
def jax_init():
    jcfg, _ = _configs()
    state = JTrainer(jcfg).init_state(jax.random.PRNGKey(0))
    return _numpy_tree(state.params)


def _jax_state(jtrainer, params):
    """A fresh JAX state on a copy of ``params`` (its step donates)."""
    params = jax.tree.map(jnp.array, params)
    return type(jtrainer.init_state(jax.random.PRNGKey(1)))(
        step=jnp.zeros((), jnp.int32), params=params,
        opt=jtrainer.tx.init(params))


def test_encoder_classifier_probs_match_jax(jax_init):
    jcfg, cfg = _configs()
    jt, t = JTrainer(jcfg), ClassifierTrainer(cfg, device="cpu")
    state = t.init_state(state_dict=classifier_state_dict_from_jax(
        jax_init, num_cls=2))
    x = _batches(1, 0)[0][0]
    want = np.asarray(jt.model.apply({"params": jax_init}, jnp.asarray(x)))
    with torch.no_grad():
        got = state.model(torch.from_numpy(x).permute(0, 3, 1, 2)
                          .contiguous()).numpy()
    assert got.shape == (B, 4)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-6)


def test_steps_across_an_epoch_boundary_match_jax(jax_init):
    """Two steps, at epoch 0 and epoch 1 (lr 1e-4, then 0.99e-4): the
    double-softmax loss and the accuracy of each, then the parameters."""
    jcfg, cfg = _configs()
    jt, t = JTrainer(jcfg), ClassifierTrainer(cfg, device="cpu")
    jstate = _jax_state(jt, jax_init)
    state = t.init_state(state_dict=classifier_state_dict_from_jax(
        jax_init, num_cls=2))
    for epoch, (x, y) in enumerate(_batches(2, 1)):
        jstate, jm = jt.step(jstate, jnp.asarray(x), jnp.asarray(y), epoch)
        m = t.step(state, x, y, epoch)
        for k in ("loss", "accuracy"):
            assert float(m[k]) == pytest.approx(float(jm[k]), abs=TOL), \
                (epoch, k)
    assert state.step == int(jstate.step) == 2
    _assert_param_parity(
        state.model.state_dict(),
        classifier_state_dict_from_jax(_numpy_tree(jstate.params), 2),
        2, "classifier")


def test_loss_is_cross_entropy_of_the_probabilities():
    """Quirk #13 kept: log_softmax applied to softmax outputs, not to
    logits.  Its value differs from the CE of the logits."""
    _, cfg = _configs()
    t = ClassifierTrainer(cfg, device="cpu")
    state = t.init_state(torch.Generator().manual_seed(0))
    x, y = _batches(1, 2)[0]
    with torch.no_grad():
        probs = state.model(torch.from_numpy(x).permute(0, 3, 1, 2)
                            .contiguous())
    want = -torch.log_softmax(probs, -1)[torch.arange(B), torch.tensor(
        y).long()].mean()
    logits_ce = -torch.log(probs)[torch.arange(B), torch.tensor(
        y).long()].mean()
    got = t.step(state, x, y)["loss"]
    assert float(got) == pytest.approx(float(want), abs=1e-6)
    assert abs(float(got) - float(logits_ce)) > 1e-3


class _Scripted:
    """Stands in the evaluate of a trainer: runs the real one (kept in
    ``real``), snapshots the parameters, and reports the scripted
    accuracy."""

    def __init__(self, script):
        self.script, self.real, self.snaps = script, [], []

    def wrap(self, evaluate, params_of):
        def scripted(state, batches):
            labels, preds, acc = evaluate(state, batches)
            self.real.append(acc)
            self.snaps.append(params_of(state))
            return labels, preds, self.script[len(self.real) - 1]
        return scripted


def test_fit_keeps_the_best_epoch_like_jax(jax_init):
    """``fit`` over a fixed batch sequence, validation every epoch: the
    real validation accuracies equal the JAX ones epoch by epoch; with the
    accuracies then reported as (0.25, 0.75, 0.5, 0.75) both keep epoch
    1's parameters (strict ``>``: epoch 3's tie does not replace them),
    and the port's are a copy of that epoch's, not the live tensors of the
    last."""
    jcfg, cfg = _configs(test_interval=1, epochs=4)
    jt, t = JTrainer(jcfg), ClassifierTrainer(cfg, device="cpu")
    train, val = _batches(2, 3), _batches(2, 4)
    script = (0.25, 0.75, 0.5, 0.75)
    js, ps = _Scripted(script), _Scripted(script)
    jt.evaluate = js.wrap(jt.evaluate, lambda s: _numpy_tree(s.params))
    t.evaluate = ps.wrap(t.evaluate, lambda s: {
        k: v.clone() for k, v in s.model.state_dict().items()})
    jlog, log = [], []
    _, jbest, jacc = jt.fit(_jax_state(jt, jax_init), lambda: iter(train),
                            lambda: iter(val), log_fn=jlog.append)
    state = t.init_state(state_dict=classifier_state_dict_from_jax(
        jax_init, num_cls=2))
    state, best, acc = t.fit(state, lambda: iter(train), lambda: iter(val),
                             log_fn=log.append)
    assert ps.real == js.real and len(ps.real) == 4
    assert acc == jacc == 0.75
    assert [r["epoch"] for r in log] == [r["epoch"] for r in jlog]
    for r, jr in zip(log, jlog):
        assert r["val_accuracy"] == jr["val_accuracy"]
        assert r["loss"] == pytest.approx(jr["loss"], abs=TOL)
    for k, v in best.items():
        assert torch.equal(v, ps.snaps[1][k]), k
    final = state.model.state_dict()
    assert any(not torch.equal(best[k], final[k]) for k in best)
    _assert_param_parity(best, classifier_state_dict_from_jax(jbest, 2),
                         2 * 2, "best")


def test_classifier_state_dict_is_the_reference_layout(jax_init, tmp_path):
    """The bridge gives the JAX package's own torch export, and a saved
    classifier loads through the port's nb05 transfer into an ``Encoder``
    whose trunk and ``fcclass`` then equal it bit for bit."""
    sd = classifier_state_dict_from_jax(jax_init, num_cls=2)
    ref = export_torch_classifier(jax_init, num_cls=2)
    assert list(sd) == list(ref)
    for k in sd:
        assert np.array_equal(sd[k].numpy(), ref[k]), k
    _, cfg = _configs()
    state = ClassifierTrainer(cfg, device="cpu").init_state(state_dict=sd)
    assert list(state.model.state_dict()) == list(sd)
    path = str(tmp_path / "classifier_best.pth")
    torch.save(state.model.state_dict(), path)
    E = Encoder(nch=8, num_cls=2)
    load_pretrained_encoder(path, E)
    esd = E.state_dict()
    for k, v in sd.items():
        assert torch.equal(esd[k], v), k


def test_cli_pretrains_on_the_cpu(tmp_path):
    """The flags of tests/test_cli.py::test_pretrain_classifier_cli, on
    the CPU with PIL decode."""
    out = tmp_path / "clf"
    r = subprocess.run(
        [sys.executable, "-m", "srgan_tpu_torch.pretrain_classifier",
         "--synthetic", "--synthetic-per-class", "12", "--train-num", "8",
         "--val-num", "2", "--test-num", "2", "--batch-size", "8",
         "--epochs", "2", "--image-size", "64", "--e-nch", "8",
         "--e-num-cls", "2", "--device", "cpu", "--decode", "pil",
         "--out", str(out)],
        cwd=ROOT, env=dict(os.environ, TMPDIR=str(tmp_path)),
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    m = json.load(open(out / "test_metrics.json"))
    assert 0.0 <= m["test_accuracy"] <= 1.0
    assert np.asarray(m["confusion_matrix"]).shape == (4, 4)
    assert m["test_n"] == 8 == np.sum(m["confusion_matrix"])
    # the figure of that matrix, as scripts/pretrain_classifier.py:123-128
    # draws it
    assert (out / "confusion_matrix.png").stat().st_size > 0
    recs = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert [rec["epoch"] for rec in recs] == [0]
    assert m["best_val_accuracy"] == recs[0]["val_accuracy"]
    E = Encoder(nch=8, num_cls=2)
    load_pretrained_encoder(str(out / "classifier_best.pth"), E)
