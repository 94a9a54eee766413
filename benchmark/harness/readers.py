"""The per-layer metrics: one file each under ``metrics/``, named as the
metric, with ``read(ctx)`` returning its value or None where the run holds
nothing for it to read.  A None leaves the metric out of the line."""

from __future__ import annotations

import importlib.util
from functools import cached_property


class Context:
    """What a traced run hands the readers: the configuration, the chips,
    the device, the trace
    (``harness.trace.Trace`` or None) and the spans and counts of the run;
    ``work`` is the reference's count of one step's work, worked out on
    first use."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def get(self, key, default=None):
        return self.__dict__.get(key, default)

    @cached_property
    def work(self) -> dict:
        from benchmark.reference.counts import train_step_work

        return train_step_work(self.config)

    @cached_property
    def card(self) -> str:
        import torch

        if self.device.type != "cuda":
            return "cpu"
        return torch.cuda.get_device_name(self.device)


def load_reader(metrics_dir, name: str):
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}", metrics_dir / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_all(cell: dict, ctx: Context) -> dict:
    out = {}
    for m in cell["per_layer"]:
        value = load_reader(cell["metrics_dir"], m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
