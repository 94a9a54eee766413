"""The port's throughput bench (``srgan_tpu_torch/bench.py``) and chip-lock
guard (``srgan_tpu_torch/utils/chiplock.py``) on the CPU, against
``bench.py`` and ``srgan_tpu/utils/chiplock.py``, mirroring
``tests/test_cli.py::test_bench_probe_paths``,
``test_bench_busy_chip_guard`` and ``test_chiplock_hold_and_clean``.

Sizes: the measured configs are 64 px / nch 8 / batch 4 / k 1 (the bench
runs on the card only; ``measure(..., device="cpu")`` exists for these
tests); the FLOP count is held against XLA's at full width (128 px, nch
64, k 5) and batch 2, since at narrow widths the elementwise work that
FlopCounterMode does not count weighs more (XLA's count is 33 % above it
at nch 8, 64 px).

Tolerances: the FLOP count of one step within 3 % of XLA's
``cost_analysis()["flops"]`` of the JAX step with the encoder trained
(measured +2.0 %: the two frameworks count some operations differently)
and within 1 % with its trunk frozen (measured +0.41 %).
"""

import torch_one_thread  # first: one intra-op thread

import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srgan_tpu import configs as jconfigs
from srgan_tpu.training.gan import GANTrainer as JGANTrainer
from srgan_tpu.utils import chiplock as jchiplock
from srgan_tpu_torch import bench
from srgan_tpu_torch.configs import PRESETS, config_to_dict
from srgan_tpu_torch.training import gan, loop
from srgan_tpu_torch.utils import chiplock
from torch_loop_common import _train, data, tiny_cfg  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the keys of bench.py's stdout line (:255-268) and of _measure's record
# (:148-156); unstable_timing and contended_with_pids only where they apply
LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "mfu", "step_ms"}
ERROR_KEYS = {"metric", "value", "unit", "vs_baseline", "error"}
RECORD_KEYS = {"label", "images_per_sec", "step_ms", "flops_per_step",
               "mfu"}


def _tiny(cfg, **train):
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, image_size=64, g_nch=8,
                                       g_res_num=1, d_nch=8, d_num_cls=2,
                                       e_nch=8, e_num_cls=2),
        train=dataclasses.replace(cfg.train, **{
            "batch_size": 4, "unrolled_k": 1, "compute_dtype": "float32",
            **train}))


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def test_bench_without_cuda_prints_an_error_line_and_exits_1(tmp_path):
    """No CUDA: one JSON line with value null and the probe's error, exit
    1, no CPU fallback; a probe past its timeout reads "unreachable", as
    bench.py's does."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    env = torch_one_thread.env(TMPDIR=str(tmp_path))
    r = subprocess.run([sys.executable, "-m", "srgan_tpu_torch.bench"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 1, r.stderr[-2000:]
    line = _last_json(r.stdout)
    assert set(line) == ERROR_KEYS
    assert line["value"] is None and line["vs_baseline"] is None
    assert line["error"].startswith("device probe failed")
    assert "CUDA is not available" in line["error"]
    assert len(r.stdout.strip().splitlines()) == 1

    env["BENCH_PROBE_TIMEOUT"] = "0.2"
    bad = subprocess.run([sys.executable, "-m", "srgan_tpu_torch.bench",
                          "--all"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert bad.returncode == 1
    line = _last_json(bad.stdout)
    assert line["value"] is None and "unreachable" in line["error"]
    # bench.py's own line on the same timeout has the same keys
    jax_bad = subprocess.run([sys.executable, os.path.join(ROOT, "bench.py")],
                             cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=300)
    assert jax_bad.returncode == 1
    assert set(_last_json(jax_bad.stdout)) == set(line)


def test_bench_probe_only_and_busy_chip_guard(tmp_path, monkeypatch, capsys):
    """With the probe passing: BENCH_PROBE_ONLY prints probe-ok; under
    BENCH_GUARD_ONLY a free lock dir gives no holders, a live marker is
    waited on and reported as contended, and a dead pid's is pruned."""
    monkeypatch.setattr(bench, "probe_backend", lambda timeout_s: None)
    locks = tmp_path / "locks"
    monkeypatch.setenv("SRGAN_TPU_LOCK_DIR", str(locks))
    monkeypatch.setenv("BENCH_BUSY_WAIT", "0.5")
    monkeypatch.setenv("BENCH_PROBE_ONLY", "1")
    assert bench.main([]) is None
    assert _last_json(capsys.readouterr().out) == {"probe": "ok"}

    monkeypatch.delenv("BENCH_PROBE_ONLY")
    monkeypatch.setenv("BENCH_GUARD_ONLY", "1")
    bench.main([])
    assert _last_json(capsys.readouterr().out)["holders"] == []

    locks.mkdir()
    (locks / f"{os.getpid()}.pid").write_text("test holder")
    (locks / "999999999.pid").write_text("stale")
    bench.main([])
    out = capsys.readouterr()
    assert _last_json(out.out) == {"probe": "ok", "holders": [os.getpid()]}
    assert not (locks / "999999999.pid").exists()
    assert "contended" in out.err


def test_chiplock_shares_the_jax_lock_dir(tmp_path, monkeypatch):
    """One lock dir, two packages: each sees the other's markers and prunes
    stale or malformed ones; the directory comes from SRGAN_TPU_LOCK_DIR,
    read at each call, with a default under the temporary directory that is
    the JAX package's where TMPDIR is unset; a CPU device holds no
    marker."""
    assert jchiplock.LOCK_DIR == os.environ.get("SRGAN_TPU_LOCK_DIR",
                                                "/tmp/srgan_tpu_chip_locks")
    monkeypatch.delenv("SRGAN_TPU_LOCK_DIR", raising=False)
    monkeypatch.setattr(tempfile, "tempdir", "/tmp")
    assert chiplock.default_lock_dir() == "/tmp/srgan_tpu_chip_locks"
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert chiplock.default_lock_dir() == str(tmp_path /
                                              "srgan_tpu_chip_locks")
    d = str(tmp_path / "locks")
    pid, parent = os.getpid(), os.getppid()
    with chiplock.hold_chip("port", lock_dir=d, device="cuda"):
        assert jchiplock.busy_pids(d) == chiplock.busy_pids(d) == [pid]
        with open(os.path.join(d, f"{pid}.pid")) as f:
            assert f.read() == "port"
    assert jchiplock.busy_pids(d) == chiplock.busy_pids(d) == []
    with jchiplock.hold_chip("jax", lock_dir=d, only_on_tpu=False):
        with open(os.path.join(d, f"{parent}.pid"), "w") as f:
            f.write("another live holder")
        assert chiplock.busy_pids(d) == sorted([pid, parent])
        monkeypatch.setenv("SRGAN_TPU_LOCK_DIR", d)
        assert chiplock.busy_pids() == sorted([pid, parent])
        assert chiplock.wait_chip_free(0.2, poll_s=0.05) == \
            sorted([pid, parent])
    os.unlink(os.path.join(d, f"{parent}.pid"))
    assert chiplock.wait_chip_free(5.0, poll_s=0.05) == []

    for name in ("999999999.pid", "not-a-pid.pid", "-3.pid"):
        with open(os.path.join(d, name), "w") as f:
            f.write("stale")
    assert chiplock.busy_pids(d) == []
    assert os.listdir(d) == []
    with open(os.path.join(d, "999999999.pid"), "w") as f:
        f.write("stale")
    assert jchiplock.busy_pids(d) == []
    assert os.listdir(d) == []

    with chiplock.hold_chip("cpu", lock_dir=d, device="cpu"):
        assert os.listdir(d) == []
    if not torch.cuda.is_available():
        with chiplock.hold_chip("default", lock_dir=d):
            assert os.listdir(d) == []


@pytest.mark.parametrize("argv,device", [
    ([], "cuda"), (["--synthetic", "--device", "cpu"], "cpu"),
    (["--device=cpu", "--epochs", "1"], "cpu"), (["--device", "cuda:0"],
                                                 "cuda:0")])
def test_cli_device_is_the_device_the_cli_parses(argv, device):
    """The CLIs' __main__ blocks hold the card for the --device their main
    parses (default cuda), so a --device cpu run holds no marker."""
    assert chiplock.cli_device(argv) == device


def test_configs_are_the_jax_bench_configs():
    """The flagship and the two --all arms are bench.py's, with the chip's
    compute dtype (bench.py:169-180, 241-256)."""
    def jbf16(cfg, **train):
        return dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, compute_dtype="bfloat16", **train))

    flag = jbf16(jconfigs.srgan_full())
    assert config_to_dict(bench.flagship_cfg()) == \
        jconfigs.config_to_dict(flag)
    assert config_to_dict(bench.flagship_cfg()) == config_to_dict(
        dataclasses.replace(PRESETS["05_srgan_full"](), train=dataclasses.
                            replace(PRESETS["05_srgan_full"]().train,
                                    compute_dtype="bfloat16")))
    arms = bench.arm_cfgs()
    assert list(arms) == ["singlegan_perdomain_k5_b128", "srgan_full_b256"]
    want = {"singlegan_perdomain_k5_b128": jbf16(
                jconfigs.conventional_singlegan(5, 0.5, "proposedKL")),
            "srgan_full_b256": jbf16(jconfigs.srgan_full(), batch_size=256)}
    for label, cfg in arms.items():
        assert config_to_dict(cfg) == jconfigs.config_to_dict(want[label])
    assert arms["singlegan_perdomain_k5_b128"].train.batch_size == 128


def test_bench_batch_is_the_jax_bench_batch():
    """bench.py:115-121's draws, in its order."""
    cfg = _tiny(bench.flagship_cfg())
    got = bench.bench_batch(cfg, "cpu")
    rng = np.random.default_rng(0)
    src = rng.integers(0, 4, 4)
    img = rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32)
    tgt = (src + rng.integers(1, 4, 4)) % 4
    np.testing.assert_array_equal(got["image"].numpy(), img)
    np.testing.assert_array_equal(got["source_label"].numpy(), src)
    np.testing.assert_array_equal(got["target_label"].numpy(), tgt)


def test_count_step_flops_reads_shapes_not_the_dtype():
    """The count of one step is the same under bf16 autocast as in fp32,
    and twice as large at twice the batch (chip_smoke.py phase 19 scales a
    CPU count at batch 2 to the card's batch)."""
    counts = {}
    for dtype, b in (("float32", 4), ("bfloat16", 4), ("float32", 8)):
        cfg = _tiny(bench.flagship_cfg(), compute_dtype=dtype, batch_size=b)
        trainer = gan.GANTrainer(cfg, "cpu")
        state = trainer.init_state(torch.Generator().manual_seed(0))
        counts[dtype, b] = bench.count_step_flops(
            trainer, state, bench.bench_batch(cfg, "cpu"))
    assert counts["float32", 4] > 0
    assert counts["bfloat16", 4] == counts["float32", 4]
    assert counts["float32", 8] == pytest.approx(2 * counts["float32", 4],
                                                 rel=1e-6)


def test_measure_record_and_the_stdout_line(tmp_path, monkeypatch, capsys):
    """measure's record has bench.py's keys (mfu null off the card, FLOPs
    counted), stderr adds the card and its power limit; main's line has
    bench.py's keys, writes the per-card baseline where it is absent
    (vs_baseline 1.0), holds later runs against it, gives null against
    another card's, and carries the contended pids and the spread."""
    monkeypatch.setenv("BENCH_WARMUP", "1")
    monkeypatch.setenv("BENCH_ITERS", "1")
    monkeypatch.setenv("BENCH_SPREAD_BOUND", "1e9")
    rec = bench.measure(_tiny(bench.flagship_cfg()), "tiny", device="cpu")
    assert set(rec) == RECORD_KEYS
    assert rec["label"] == "tiny" and rec["mfu"] is None
    assert rec["flops_per_step"] > 0 and rec["images_per_sec"] > 0
    err = _last_json(capsys.readouterr().err)
    assert err == {**rec, "card": None, "power_limit": None}
    assert bench.chip_peak("NVIDIA H100 80GB HBM3", "bfloat16") == 989.4e12
    assert bench.chip_peak("NVIDIA H100 80GB HBM3", "float32") == 66.9e12
    assert bench.chip_peak("NVIDIA H100 PCIe", "bfloat16") is None
    assert bench.chip_peak("cpu", "float32") is None

    real_measure = bench.measure
    monkeypatch.setattr(bench, "probe_backend", lambda timeout_s: None)
    monkeypatch.setattr(bench, "flagship_cfg",
                        lambda: _tiny(PRESETS["05_srgan_full"]()))
    monkeypatch.setattr(bench, "arm_cfgs", lambda: {
        "singlegan_perdomain_k5_b128": _tiny(PRESETS[
            "01_proposed_singlegan_k5"]()),
        "srgan_full_b256": _tiny(PRESETS["05_srgan_full"](), batch_size=8)})
    monkeypatch.setattr(bench, "measure", lambda cfg, label, card: (
        real_measure(cfg, label, device="cpu", card=card)))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "card A")
    monkeypatch.setattr(bench, "SELF_PATH", str(tmp_path / "self.json"))
    locks = tmp_path / "locks"
    monkeypatch.setenv("SRGAN_TPU_LOCK_DIR", str(locks))
    monkeypatch.setenv("BENCH_BUSY_WAIT", "0")
    monkeypatch.setenv("BENCH_SPREAD_BOUND", "0.5")
    arms_out = tmp_path / "runs" / "arms.json"
    line = bench.main(["--all", "--arms-out", str(arms_out)])
    assert _last_json(capsys.readouterr().out) == line
    assert set(line) == LINE_KEYS | {"unstable_timing"}
    assert line["metric"] == "srgan_train_images_per_sec_per_chip"
    assert line["unit"] == "images/sec" and line["mfu"] is None
    assert line["vs_baseline"] == 1.0
    base = json.load(open(tmp_path / "self.json"))
    assert set(base) == {"images_per_sec", "card", "power_limit", "note"}
    assert base["images_per_sec"] == line["value"]
    assert base["card"] == "card A"
    arms = json.load(open(arms_out))["results"]
    assert [a["label"] for a in arms] == [
        "srgan_full_b128", "singlegan_perdomain_k5_b128", "srgan_full_b256"]
    assert all(set(a) == RECORD_KEYS | {"unstable_timing"} for a in arms)

    canned = dict(label="x", images_per_sec=2 * base["images_per_sec"],
                  step_ms=1.0, flops_per_step=1.0, mfu=None)
    monkeypatch.setattr(bench, "measure", lambda cfg, label, card: canned)
    locks.mkdir()
    (locks / f"{os.getpid()}.pid").write_text("test holder")
    line = bench.main([])
    assert line == {"metric": "srgan_train_images_per_sec_per_chip",
                    "value": canned["images_per_sec"], "unit": "images/sec",
                    "vs_baseline": 2.0, "mfu": None, "step_ms": 1.0,
                    "contended_with_pids": [os.getpid()]}
    assert "contended" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "card B")
    assert bench.main([])["vs_baseline"] is None
    assert json.load(open(tmp_path / "self.json")) == base


def test_train_gan_holds_the_card_during_its_steps(tmp_path, data,
                                                    monkeypatch):
    """train_gan advertises its device for the epochs, as the JAX loop does
    (srgan_tpu/training/loop.py:174-178), and releases it after; on the
    CPU the marker is not dropped, so the device is taken as a card here."""
    locks = str(tmp_path / "locks")
    labels, seen = [], []
    real_hold = chiplock.hold_chip

    def hold(label, device=None):
        labels.append((label, torch.device(device).type))
        return real_hold(label, lock_dir=locks, device="cuda")

    real_step = gan.GANTrainer.step

    def step(self, *a, **kw):
        seen.append(chiplock.busy_pids(locks))
        return real_step(self, *a, **kw)

    monkeypatch.setattr(loop, "hold_chip", hold)
    monkeypatch.setattr(gan.GANTrainer, "step", step)
    _train(tiny_cfg(), tmp_path / "run", data, epochs=2)
    out = str(tmp_path / "run")
    assert labels == [(f"train_gan {out}", "cpu")]
    assert len(seen) >= 2 and all(s == [os.getpid()] for s in seen)
    assert chiplock.busy_pids(locks) == []


@pytest.mark.parametrize("frozen,rel", [(False, 0.03), (True, 0.01)],
                         ids=["encoder_trained", "trunk_frozen"])
def test_count_step_flops_matches_xla_at_full_width(frozen, rel):
    """count_step_flops of one 05_srgan_full step (128 px, nch 64, k 5,
    batch 2, fp32) against XLA's count of the lowered JAX step, the number
    bench.py divides by the step time."""
    cfg = dataclasses.replace(PRESETS["05_srgan_full"](), train=dataclasses.
                              replace(PRESETS["05_srgan_full"]().train,
                                      batch_size=2))
    trainer = gan.GANTrainer(cfg, "cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0),
                               freeze_pretrained=frozen)
    ours = bench.count_step_flops(trainer, state,
                                  bench.bench_batch(cfg, "cpu"))
    del trainer, state

    jcfg = jconfigs.config_from_dict(config_to_dict(cfg))
    jt = JGANTrainer(jcfg, donate=False)
    jstate = jt.init_state(jax.random.PRNGKey(0), freeze_pretrained=frozen)
    src = np.arange(2) % 4
    lowered = jt._jit_step.lower(
        jstate, jnp.zeros((2, 128, 128, 3), jnp.float32), jnp.asarray(src),
        jnp.asarray((src + 1) % 4), jax.random.PRNGKey(0),
        jnp.float32(1e-4), jnp.float32(1e-4), jnp.float32(1e-4))
    xla = lowered.cost_analysis()["flops"]
    assert abs(ours / xla - 1) <= rel, (ours, xla, ours / xla - 1)
