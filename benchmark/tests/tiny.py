"""Toy-sized copies of the cells' configurations for the CPU tests."""

import copy

import torch

from benchmark.harness import common

torch.set_num_threads(2)


def tiny_config(name: str, dtype: str = "float32", batch: int = 8,
                k: int = 2) -> dict:
    cfg = common.load_json(common.BENCH_DIR / "configs" / f"{name}.json")
    cfg = copy.deepcopy(cfg)
    cfg["model"].update(image_size=64, g_nch=8, d_nch=8, e_nch=8,
                        g_res_num=1)
    cfg["train"].update(batch_size=batch, unrolled_k=k, compute_dtype=dtype)
    return cfg


def cell(workload: str, config: dict, **traffic) -> dict:
    """The cell ``workload`` (configuration.traffic) from its files, with
    ``config`` in place of its configuration and ``traffic`` over its
    traffic's values."""
    traffic_name = workload.split(".", 1)[1]
    bench = common.BENCH_DIR
    return {"name": workload, "chips": 1, "config": config,
            "traffic": dict(common.load_json(
                bench / "traffic" / f"{traffic_name}.json"), **traffic),
            "limits": common.load_json(bench / "limits" / f"{workload}.json"),
            "per_layer": [], "metrics_dir": bench / "metrics"}
