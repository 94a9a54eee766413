"""A cell added as files alone: a configuration, a traffic mix, limits and
a per-layer metric, with their entries in BENCHMARK.json, in a temporary
copy of the benchmark.  The copy's harness finds them by name and runs the
cell (on the CPU, past the look for a card); its own command refuses to run
without a card and prints no result."""

import json
import os
import shutil
import subprocess
import sys

from benchmark.harness import common
from benchmark.tests.tiny import tiny_config

RUN = """
import sys, time, json, torch
sys.path.insert(0, {root!r})
sys.path.append({repo!r})
torch.set_num_threads(2)
from benchmark.harness import common
from benchmark.harness.cell import run_cell
cell = common.resolve_cell("tiny_srgan.train_toy")
result, checks = run_cell(cell, 7, 0.5, True, torch.device("cpu"),
                          time.perf_counter())
print(json.dumps({{"result": result, "checks": checks}}))
"""


def env():
    return dict(os.environ, OMP_NUM_THREADS="1")


def test_a_cell_added_as_files_runs(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(common.ROOT / "BENCHMARK.json", root)
    shutil.copytree(common.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = root / "benchmark"
    (b / "configs" / "tiny_srgan.json").write_text(json.dumps(
        tiny_config("srgan_full")))
    traffic = common.load_json(b / "traffic" / "train_b128.json")
    traffic.update(pool_batches=4, warmup_steps=1, trace_steps=1)
    (b / "traffic" / "train_toy.json").write_text(json.dumps(traffic))
    (b / "limits" / "tiny_srgan.train_toy.json").write_text(json.dumps(
        {"loss_gap": 1e-3}))
    (b / "metrics" / "steps.train.py").write_text(
        "def read(ctx):\n    return ctx.steps\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny_srgan", "source": "x",
                           "file": "benchmark/configs/tiny_srgan.json",
                           "reduced": [], "why": "toy"})
    man["workloads"].append({"name": "tiny_srgan.train_toy",
                             "config": "tiny_srgan", "traffic": "train_toy",
                             "chips": 1, "why": "toy"})
    for m in man["end_to_end"]:
        if m["name"] == "train_img_per_s":
            m["workloads"].append("tiny_srgan.train_toy")
    man["per_layer"].append({"name": "steps.train", "unit": "steps",
                             "better": "higher", "source": "host_clock",
                             "layer": "trainer", "moves": "train_img_per_s",
                             "workloads": ["tiny_srgan.train_toy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(root=str(root),
                                          repo=str(common.ROOT))],
        capture_output=True, text=True, timeout=600, env=env(), cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["result"]["correct"], got
    assert got["result"]["metrics"]["steps.train"]["value"] >= 1
    assert "mfu.train" not in got["result"]["metrics"]   # no card, no peak
    assert set(got["checks"]) == {"loss_gap"}


def test_the_command_refuses_without_a_card(tmp_path):
    root = tmp_path / "bare"
    root.mkdir()
    shutil.copy(common.ROOT / "BENCHMARK.json", root)
    shutil.copytree(common.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = common.manifest()
    cmd = man["command"] + ["--workload", man["workloads"][0]["name"],
                            "--seed", str(2 ** 33 + 5), "--seconds", "1",
                            "--trace", "0"]
    cmd[0] = sys.executable
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         env=env(), cwd=root)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
