"""The port's script twins (``srgan_tpu_torch/{make_fixture,
build_label_folder,translation_oracle,compare_results,bench_loader,
data_scale_dryrun,bench_serving}.py``) on the CPU against the JAX
package's scripts under ``scripts/``, each loaded by its file path.

Sizes are small: fixtures of 4-8 images a class, a 4,000-row attribute file
with splits of 100 / 10 / 10 a class, a 32 px / nch 8 generator.

Tolerances: the fixture files, the label-folder pickles, the oracle's
class means and predictions and the compare_results JSON are equal, byte
for byte or value for value (the same numpy arithmetic on the same bits);
the printed tables to 4 decimals (both round there); the generator's fakes
within 1e-4 of the JAX transform's (the models' tolerance in
``tests/test_torch_models.py``), so that the oracle's pairs are equal
unless a fake's channel mean lies within 1e-4 of a decision boundary; the
timings are not compared.
"""

import torch_one_thread  # first: one intra-op thread

import dataclasses
import filecmp
import importlib.util
import json
import os
import pickle
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srgan_tpu.configs import ExperimentConfig as JExperimentConfig
from srgan_tpu.configs import LossWeights as JLossWeights
from srgan_tpu.configs import ModelConfig as JModelConfig
from srgan_tpu.configs import TrainConfig as JTrainConfig
from srgan_tpu.training.gan import GANTrainer as JGANTrainer
from srgan_tpu_torch import (
    bench_loader,
    bench_serving,
    build_label_folder,
    compare_results,
    data_scale_dryrun,
    make_fixture,
    translation_oracle,
)
from srgan_tpu_torch.configs import (
    ExperimentConfig,
    LossWeights,
    ModelConfig,
    TrainConfig,
    save_config,
)
from srgan_tpu_torch.data import make_scale_attr_file, make_synthetic_celeba
from srgan_tpu_torch.data import native
from srgan_tpu_torch.training import gan
from srgan_tpu_torch.utils.checkpoint import (
    encoder_state_dict_from_jax,
    generator_state_dict_from_jax,
    save_checkpoint,
    solo_discriminator_state_dict_from_jax,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAKE_ATOL = 1e-4
MODEL = dict(image_size=32, g_nch=8, g_res_num=1, d_nch=8, d_num_cls=2,
             e_nch=8, e_num_cls=2)
TRAIN = dict(batch_size=4, unrolled_k=1, train_num=4, val_num=0,
             test_num=4)


def load_script(name):
    """``scripts/<name>.py`` as a module (the JAX package's script)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_script(monkeypatch, mod, *argv):
    """A JAX script's ``main()``, which reads ``sys.argv``."""
    monkeypatch.setattr(sys, "argv", [mod.__file__, *map(str, argv)])
    return mod.main()


def same_tree(a, b):
    files = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    for f in files:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                           shallow=False), f
    return files


# ------------------------------------------------------------ make_fixture

@pytest.mark.parametrize("recipe", ["structured", "boost", "strong"])
def test_make_fixture_is_the_jax_fixture(tmp_path, monkeypatch, recipe):
    jmod = load_script("make_fixture")
    assert make_fixture.RECIPES == jmod.RECIPES
    run_script(monkeypatch, jmod, "--recipe", recipe, "--n-per-class", 4,
               "--out", tmp_path / "jax")
    make_fixture.main(["--recipe", recipe, "--n-per-class", "4", "--out",
                       str(tmp_path / "port")])
    files = same_tree(tmp_path / "jax", tmp_path / "port")
    assert "fixture.json" in files and "list_attr_celeba.txt" in files
    assert sum(f.endswith(".png") for f in files) == 16
    with open(tmp_path / "port" / "fixture.json") as f:
        assert json.load(f) == {"recipe": recipe, "params": {
            **make_fixture.RECIPES[recipe], "n_per_class": 4}}


# ------------------------------------------------------ build_label_folder

def test_build_label_folder_writes_the_jax_pickles(tmp_path, monkeypatch):
    attr = make_scale_attr_file(str(tmp_path / "list_attr_celeba.txt"),
                                12_000, 3)
    run_script(monkeypatch, load_script("build_label_folder"),
               "--attr-file", attr, "--out", tmp_path / "jax")
    paths = build_label_folder.main(["--attr-file", attr, "--out",
                                     str(tmp_path / "port")])
    assert len(paths) == 3
    assert same_tree(tmp_path / "jax", tmp_path / "port") == [
        "000000_to_004999.pkl", "005000_to_009999.pkl",
        "010000_to_011999.pkl"]


# ------------------------------------------------------ translation_oracle

def test_oracle_means_and_classes_are_the_jax_ones():
    jmod = load_script("translation_oracle")
    rng = np.random.default_rng(0)
    by_class = {c: rng.uniform(-1, 1, (5, 8, 8, 3)).astype(np.float32)
                + 0.1 * c for c in range(4)}
    sigs, jsigs = (translation_oracle.class_means(by_class),
                   jmod.class_means(by_class))
    assert sorted(sigs) == sorted(jsigs)
    for c in sigs:
        np.testing.assert_array_equal(sigs[c], jsigs[c])
    images = rng.uniform(-1, 1, (64, 8, 8, 3)).astype(np.float32) \
        + rng.uniform(0, 0.3, (64, 1, 1, 1)).astype(np.float32)
    pred = translation_oracle.oracle_classify(images, sigs)
    np.testing.assert_array_equal(pred, jmod.oracle_classify(images, jsigs))
    assert len(set(pred.tolist())) > 1


@pytest.fixture(scope="module")
def oracle_case(tmp_path_factory):
    """A fixture of 8 images a class (its last 4 are the test split), the
    JAX init of a 32 px / nch 8 model carried over to the port, and the
    latents of the JAX script's key chain."""
    tmp = tmp_path_factory.mktemp("oracle")
    data = make_synthetic_celeba(str(tmp / "celeba"), n_per_class=8,
                                 noise_sigma=15.0, smiling_boost=40.0)
    jcfg = JExperimentConfig(
        name="oracle", model=JModelConfig(**MODEL),
        train=JTrainConfig(**TRAIN), loss=JLossWeights.proposed_kl(cls=1.0),
        trainer="srgan")
    cfg = ExperimentConfig(
        name="oracle", model=ModelConfig(**MODEL),
        train=TrainConfig(**TRAIN), loss=LossWeights.proposed_kl(cls=1.0),
        trainer="srgan")
    jtrainer = JGANTrainer(jcfg)
    jstate = jtrainer.init_state(jax.random.PRNGKey(0))
    by_class = translation_oracle.images_by_class(cfg, *data, test_num=4)
    key, latents = jax.random.PRNGKey(0), {}
    for s, t in translation_oracle.ordered_pairs(by_class):
        key, sub = jax.random.split(key)
        latents[f"{s}->{t}"] = np.asarray(jax.random.normal(
            sub, (len(by_class[s]), 8), jnp.float32))
    g, d, e = jax.device_get((jstate.g_params, jstate.d_params,
                              jstate.e_params))
    start = dict(g_state=generator_state_dict_from_jax(g, 2, 1),
                 d_state=solo_discriminator_state_dict_from_jax(d, 2),
                 e_state=encoder_state_dict_from_jax(e, 2),
                 hist_target=np.asarray(jstate.hist_target))
    return dict(tmp=tmp, data=data, cfg=cfg, jtrainer=jtrainer,
                jstate=jstate, by_class=by_class, latents=latents,
                start=start)


def test_oracle_pairs_match_jax_pair_for_pair(oracle_case):
    jmod = load_script("translation_oracle")
    c = oracle_case
    by_class = c["by_class"]
    assert sorted(by_class) == [0, 1, 2, 3]
    assert all(len(v) == 4 for v in by_class.values())
    sigs = translation_oracle.class_means(by_class)
    assert all((translation_oracle.oracle_classify(by_class[k], sigs) == k)
               .all() for k in by_class)
    G = gan.build_generator(c["cfg"], "cpu",
                            state_dict=c["start"]["g_state"])
    pairs, acc = translation_oracle.pair_accuracies(G, by_class, sigs,
                                                    c["latents"])
    jpairs, jacc = jmod.pair_accuracies(c["jtrainer"], c["jstate"],
                                        by_class, sigs,
                                        jax.random.PRNGKey(0))
    assert list(pairs) == list(jpairs) == [
        f"{s}->{t}" for s in range(4) for t in range(4) if s != t]
    keys = sorted(sigs)
    for s, t in translation_oracle.ordered_pairs(by_class):
        lat = c["latents"][f"{s}->{t}"]
        fake = translation_oracle.translate(G, by_class[s], t, lat)
        jfake, _ = c["jtrainer"].transform(
            c["jstate"], by_class[s], np.full(len(by_class[s]), t),
            latent=lat)
        jfake = np.asarray(jfake)
        np.testing.assert_allclose(fake, jfake, rtol=0, atol=FAKE_ATOL)
        if pairs[f"{s}->{t}"] != jpairs[f"{s}->{t}"]:
            # a differing pair: each image classified apart lies within
            # 1e-4 of the boundary between the two classes
            p = translation_oracle.oracle_classify(fake, sigs)
            q = translation_oracle.oracle_classify(jfake, sigs)
            means = jfake.mean(axis=(1, 2))
            for i in np.flatnonzero(p != q):
                d = {k: np.linalg.norm(means[i] - sigs[k]) for k in keys}
                assert abs(d[p[i]] - d[q[i]]) <= FAKE_ATOL, (s, t, i, d)
    if pairs == jpairs:
        assert acc == jacc


def test_oracle_cli_scores_a_port_checkpoint(oracle_case, tmp_path,
                                             monkeypatch):
    """The CLI end to end on the CPU: a port checkpoint written from the
    JAX init, the JAX key chain's latents in place of the seeded draws;
    its ``trained`` pairs are ``pair_accuracies`` of the checkpoint's G,
    its ``init`` pairs those of ``build_generator`` seeded with 0 (torch's
    draws, not JAX's: ROADMAP C)."""
    c = oracle_case
    seeded = translation_oracle.pair_latents(c["by_class"], 8)
    assert list(seeded) == list(c["latents"])
    assert all(seeded[k].shape == c["latents"][k].shape for k in seeded)
    monkeypatch.setattr(translation_oracle, "pair_latents",
                        lambda by_class, ndim: c["latents"])
    cfg = c["cfg"]
    run = tmp_path / "run"
    state = gan.GANTrainer(cfg, "cpu").init_state(**c["start"])
    save_checkpoint(str(run / "ckpt"), state, step=3)
    save_config(cfg, str(run))
    out = tmp_path / "oracle" / "summary.json"
    summary = translation_oracle.main(
        ["--ckpt", str(run / "ckpt"), "--data-root", c["data"][0],
         "--attr-file", c["data"][1], "--test-num", "4", "--device", "cpu",
         "--out", str(out)])
    with open(out) as f:
        assert json.load(f) == summary
    assert list(summary) == ["real_acc", "init", "trained"]
    assert summary["real_acc"] == 1.0
    sigs = translation_oracle.class_means(c["by_class"])
    for key, G in (
            ("trained", state.G),
            ("init", gan.build_generator(cfg, "cpu",
                                         torch.Generator().manual_seed(0)))):
        assert list(summary[key]) == ["acc", "perfect_pairs", "pairs"]
        pairs, acc = translation_oracle.pair_accuracies(
            G, c["by_class"], sigs, c["latents"])
        assert summary[key]["pairs"] == pairs
        assert summary[key]["acc"] == acc
        assert summary[key]["perfect_pairs"] == sum(
            v == 1.0 for v in pairs.values())


# --------------------------------------------------------- compare_results

def _prdc_pickles(tmp_path):
    """2 models x 2 extractors x 4 classes x 3 repeats, in the
    ``evaluation_init`` layout."""
    rng = np.random.default_rng(5)
    paths = []
    for m in range(2):
        res = {fe: {s: {t: {k: [float(v) for v in rng.uniform(0, 1.5, 3)]
                            for k in compare_results.METRICS}
                        for t in range(4)} for s in range(4)}
               for fe in ("vgg-initialization", "vgg-CelebA")}
        path = tmp_path / f"model{m}.pkl"
        with open(path, "wb") as f:
            pickle.dump(res, f)
        paths.append(str(path))
    return paths


def _table_numbers(text):
    return [float(x) for x in re.findall(r"-?\d+\.\d+", text)]


def test_compare_results_matches_the_jax_tables(tmp_path, monkeypatch,
                                                capsys):
    paths = _prdc_pickles(tmp_path)
    args = [*paths, "--names", "alpha", "beta", "--fe", "vgg-CelebA"]
    run_script(monkeypatch, load_script("compare_results"), *args,
               "--json-out", tmp_path / "jax.json")
    jax_out = capsys.readouterr().out
    tables = compare_results.main(args + ["--json-out",
                                          str(tmp_path / "port.json")])
    port_out = capsys.readouterr().out
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == want == tables
    assert filecmp.cmp(tmp_path / "jax.json", tmp_path / "port.json",
                       shallow=False)
    # the three tables' numbers, to 4 decimals, in the same order
    got, ref = (_table_numbers(port_out.split("JSON tables")[0]),
                _table_numbers(jax_out.split("JSON tables")[0]))
    assert len(got) == len(ref) == 2 * 4 + 4 * 4 + 2 * 4
    np.testing.assert_allclose(got, ref, rtol=0, atol=0.5e-4 + 1e-12)


def test_compare_results_never_imports_pandas(tmp_path):
    paths = _prdc_pickles(tmp_path)
    code = ("import sys\n"
            "from srgan_tpu_torch import compare_results\n"
            f"compare_results.main({paths!r} + ['--json-out', "
            f"{str(tmp_path / 'x.json')!r}])\n"
            "assert 'pandas' not in sys.modules, 'pandas imported'\n"
            "print('NO PANDAS')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=torch_one_thread.env(), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO PANDAS" in r.stdout


# ------------------------------------------------------------ bench_loader

def test_bench_loader_keys_and_missing_native(tmp_path, monkeypatch):
    jmod = load_script("bench_loader")
    real = jmod.make_synthetic_celeba
    # the JAX script writes its fixture to a fixed /tmp path: keep it here
    monkeypatch.setattr(jmod, "make_synthetic_celeba", lambda _, **kw:
                        real(str(tmp_path / "jax_fixture"), **kw))
    flags = ["--per-class", "4", "--batch-size", "4", "--epochs", "1"]
    run_script(monkeypatch, jmod, *flags, "--out", tmp_path / "jax.json")
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    monkeypatch.chdir(tmp_path)
    got = bench_loader.main(flags + ["--out", str(tmp_path / "port.json")])
    assert set(got) == set(want)
    assert {k: got[k] for k in ("n_images", "batch_size", "epochs")} == \
        {k: want[k] for k in ("n_images", "batch_size", "epochs")}
    assert got["pil"] > 0 and got["native"] > 0
    # the decoder cannot build: native null with the reason, PIL timed as
    # pil only, and the run completes
    monkeypatch.setattr(native, "CXX", "/nonexistent/g++")
    got = bench_loader.main(flags + ["--out", str(tmp_path / "none.json")])
    with open(tmp_path / "none.json") as f:
        assert json.load(f) == got
    assert got["native"] is None
    assert "/nonexistent/g++" in got["native_error"]
    assert got["pil"] > 0
    assert set(got) == set(want) | {"native_error"}
    assert sorted(os.listdir(tmp_path)) == ["jax.json", "jax_fixture",
                                            "none.json", "port.json"]


# ------------------------------------------------------- data_scale_dryrun

TIMING = re.compile(r"(_s|seconds|img_per_s|native_speedup|loadavg_.*)$")


def _non_timing(node):
    if isinstance(node, dict):
        return {k: _non_timing(v) for k, v in node.items()
                if not TIMING.search(k)}
    return node


def test_data_scale_dryrun_matches_jax(tmp_path, monkeypatch):
    jmod = load_script("data_scale_dryrun")
    for mod in (jmod, data_scale_dryrun):
        monkeypatch.setattr(mod, "TRAIN_NUM", 100)
        monkeypatch.setattr(mod, "VAL_NUM", 10)
        monkeypatch.setattr(mod, "TEST_NUM", 10)
    flags = ["--n-rows", "4000", "--pixel-pool", "16", "--bench-batches",
             "4", "--batch-size", "8", "--workers", "2"]
    run_script(monkeypatch, jmod, *flags, "--workdir", tmp_path / "jax",
               "--out", tmp_path / "jax.json")
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    got = data_scale_dryrun.main(flags + ["--workdir",
                                          str(tmp_path / "port"), "--out",
                                          str(tmp_path / "port.json")])
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == json.loads(json.dumps(got))
    assert json.loads(json.dumps(_non_timing(got))) == _non_timing(want)
    assert got["label_chunks"] == 1 and got["selected_images"] == 480
    assert got["loader"]["native"]["images"] == 32
    assert got["loader"]["pil"]["images"] == 32
    assert set(got) == set(want)
    # without --workdir the work directory is a temporary one
    monkeypatch.chdir(tmp_path / "port")
    before = sorted(os.listdir("."))
    data_scale_dryrun.main(flags + ["--out", str(tmp_path / "tmp.json")])
    assert sorted(os.listdir(".")) == before


# ------------------------------------------------------------ bench_serving

def _small_preset():
    jcfg = load_script("bench_serving").PRESETS["03_srgan_nopretraining"]()
    cfg = bench_serving.PRESETS["03_srgan_nopretraining"]()
    assert cfg.name == jcfg.name and cfg.model.image_size == \
        jcfg.model.image_size == 128 and cfg.model.g_nch == 64
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, **MODEL))


def test_bench_serving_runs_in_process_on_the_cpu(tmp_path, monkeypatch):
    small = _small_preset()
    monkeypatch.setattr(bench_serving, "PRESETS",
                        {"03_srgan_nopretraining": lambda: small})
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "bench.json"
    got = bench_serving.main(["--device", "cpu", "--batch-sizes", "1,2",
                              "--iters", "2", "--out", str(out)])
    assert os.listdir(tmp_path) == ["bench.json"]
    with open(out) as f:
        assert json.load(f) == got
    # the JAX script's keys, plus the compute dtype and the device
    assert set(got) == {"preset", "image_size", "warmup_s", "batches",
                        "device_only", "compute_dtype", "device"}
    assert got["preset"] == "03_srgan_nopretraining"
    assert got["image_size"] == 32 and got["device"] == "cpu"
    assert [r["batch"] for r in got["batches"]] == [1, 2]
    for r in got["batches"]:
        assert set(r) == {"batch", "p50_ms", "p95_ms", "img_per_sec_p50"}
        assert 0 < r["p50_ms"] <= r["p95_ms"]
    assert set(got["device_only"]) == {"batch", "ms_per_forward",
                                       "img_per_sec", "chained_steps"}
    assert got["device_only"]["batch"] == 2
    assert got["device_only"]["chained_steps"] == 20
    got16 = bench_serving.main(["--device", "cpu", "--batch-sizes", "2",
                                "--iters", "2", "--compute-dtype",
                                "bfloat16", "--out", str(out)])
    assert got16["compute_dtype"] == "bfloat16"
