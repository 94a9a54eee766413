"""What every cell shares: the manifest and the files a cell is made of,
the run's environment, the seeded inputs, the device record and the result
line."""

from __future__ import annotations

import json
import math
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "srgan_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def resolve_cell(workload: str, root: Path = ROOT) -> dict:
    """The cell named ``workload`` with its configuration (from the file
    the manifest names), its traffic (``traffic/<name>.json``), its limits
    (``limits/<workload>.json``) and the per-layer metrics it reports; the
    end-to-end metrics are the runner's own."""
    man = manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; "
                         f"there are {sorted(cells)}")
    w = cells[workload]
    conf = next(c for c in man["configs"] if c["name"] == w["config"])
    bench = root / BENCH_DIR.name
    per_layer = [m for m in man["per_layer"]
                 if workload in m.get("workloads", [workload])]
    return {"name": workload, "chips": w["chips"],
            "config": load_json(root / conf["file"]),
            "traffic": load_json(bench / "traffic" / f"{w['traffic']}.json"),
            "limits": load_json(bench / "limits" / f"{workload}.json"),
            "per_layer": per_layer, "metrics_dir": bench / "metrics"}


def prepare_env(root: Path = ROOT):
    """Every cache the program or torch keeps goes to a fixed directory
    inside the checkout; the program's chip-lock markers go under the run's
    own temporary directory; no library may load JAX.  Call before torch
    is imported: the children (client, ranks) inherit it."""
    cache = root / "build" / "bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["SRGAN_TPU_LOCK_DIR"] = os.path.join(tempfile.gettempdir(),
                                                    "srgan_bench_locks")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.pop("SRGAN_TPU_FUSED_DIV", None)


def forbidden_loaded() -> list:
    return sorted({name.split(".", 1)[0] for name in sys.modules}
                  & set(FORBIDDEN))


def subseed(seed: int, tag: int) -> int:
    """A 63-bit seed for one use (``tag``) of the run's seed."""
    state = np.random.SeedSequence([seed % 2 ** 64, tag]).generate_state(
        1, np.uint64)
    return int(state[0]) >> 1


def port_config(config: dict, seed: int):
    """The program's ``ExperimentConfig`` for a configuration file."""
    from srgan_tpu_torch.configs import (ExperimentConfig, LossWeights,
                                         ModelConfig, TrainConfig)

    return ExperimentConfig(
        name=config["preset"], model=ModelConfig(**config["model"]),
        train=TrainConfig(**config["train"], seed=seed),
        loss=LossWeights(**config["loss"]), trainer=config["trainer"],
        pretrained_encoder=config["pretrained_encoder"])


def make_weights(config: dict, seed: int, device):
    """(G, D, E) state dicts drawn on ``device`` from the seed, the same
    for the program and for the reference."""
    import torch

    from benchmark.reference.nets import build, init_weights

    gen = torch.Generator(device).manual_seed(subseed(seed, 1))
    return init_weights(build(config, "meta"), gen, device)


def device_record(device, chips: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def finite(x: float) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """correct iff every number is finite and at most its limit."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(finite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
    return ok, checks


def emit(result: dict, checks: dict):
    """The checks as the last lines of stderr, then the result line (its
    last key the checks) as the last line of stdout."""
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr, flush=True)
    result["checks"] = checks
    print(json.dumps(result), flush=True)
