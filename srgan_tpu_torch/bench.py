"""Throughput benchmark: the full-size SRGAN train step on one card
(counterpart of ``bench.py``).

    python -m srgan_tpu_torch.bench [--all] [--arms-out runs/BENCH_ARMS.json]

Prints ONE JSON line last:
  {"metric": "srgan_train_images_per_sec_per_chip", "value": N,
   "unit": "images/sec", "vs_baseline": N, "mfu": M, "step_ms": T}
plus ``contended_with_pids`` and ``unstable_timing`` where they apply.

Config = the flagship notebook-05 arm at full width (nch 64, res 6, solo D
with d_num_cls 4, encoder 4 blocks, ndim 8), 128 px, batch 128, unrolled
k 5, in the card's production compute dtype: bf16 autocast over fp32
parameters.  As in ``bench.py`` the encoder's trunk is not frozen.

``mfu`` = FLOPs a step (``count_step_flops``) / step time / the card's
dense peak in the config's compute dtype (``chip_peak``); null on a card
whose peaks this module does not know.

The reference publishes no throughput: ``vs_baseline`` is measured against
``srgan_tpu_torch/bench_self.json``, the first number recorded on the card
(written by the bench where the file is absent, then 1.0), and is null
where that file names another card.  The JAX package's ``BENCH_SELF.json``
holds a TPU number and is neither read nor written.

``--all`` also benches the per-domain SingleGAN k 5 arm and the batch-256
flagship, written to ``--arms-out``; the stdout line stays the flagship's.
Without a working CUDA device it prints the line with ``value`` null and
an ``error`` and exits 1: there is no CPU fallback.

Environment: BENCH_PROBE_TIMEOUT (s, default 600), BENCH_PROBE_ONLY,
BENCH_BUSY_WAIT (s to wait for chip-lock holders, default 1800),
BENCH_GUARD_ONLY, BENCH_WARMUP (steps, default 25), BENCH_ITERS (steps a
trial, default 20), BENCH_SPREAD_BOUND (default 1.3), SRGAN_TPU_LOCK_DIR.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from srgan_tpu_torch.configs import PRESETS, conventional_singlegan
from srgan_tpu_torch.training import gan
from srgan_tpu_torch.utils.chiplock import wait_chip_free

METRIC = "srgan_train_images_per_sec_per_chip"
SELF_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "bench_self.json")
# dense FLOP/s by the exact torch.cuda.get_device_name(): NVIDIA's data
# sheet for the H100 SXM5 at its 700 W limit.  The PCIe part has other
# peaks and gets none, so its mfu is null.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989.4e12, "float32": 66.9e12},
}


def chip_peak(name: str, dtype: str) -> float | None:
    """The card's dense peak FLOP/s in ``dtype``, or None."""
    return PEAK_FLOPS.get(name, {}).get(dtype)


def _with(cfg, **train):
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                              **train))


def flagship_cfg():
    """05_srgan_full in bf16, the branch of ``bench.py:169-180`` that runs
    on the chip."""
    return _with(PRESETS["05_srgan_full"](), compute_dtype="bfloat16")


def arm_cfgs() -> dict:
    """The ``--all`` arms of ``bench.py:241-256``, by label."""
    return {
        "singlegan_perdomain_k5_b128": _with(
            conventional_singlegan(5, 0.5, "proposedKL"),
            compute_dtype="bfloat16"),
        "srgan_full_b256": _with(flagship_cfg(), batch_size=256),
    }


def bench_batch(cfg, device) -> dict:
    """The batch of ``bench.py:115-121`` (``np.random.default_rng(0)``,
    the same draws in the same order), placed on ``device`` once."""
    batch, hw = cfg.train.batch_size, cfg.model.image_size
    rng = np.random.default_rng(0)
    src = rng.integers(0, 4, batch)
    image = rng.uniform(-1, 1, (batch, hw, hw, 3)).astype(np.float32)
    tgt = (src + rng.integers(1, 4, batch)) % 4
    return {"image": torch.from_numpy(image).to(device),
            "source_label": torch.from_numpy(src).to(device),
            "target_label": torch.from_numpy(tgt).to(device)}


def eager_step(trainer, state, batch, epoch: int = 0):
    """``trainer.step`` with its CUDA graphs off for the call: the step's
    operations are dispatched one by one, where a FLOP counter or a
    profiler's op records see them (a replayed graph shows its kernels
    alone).  The graphs stay valid for the steps after it."""
    own = vars(trainer).get("_graphable")
    trainer._graphable = lambda: False
    try:
        return trainer.step(state, batch, epoch)
    finally:
        if own is None:
            del trainer._graphable
        else:
            trainer._graphable = own


def count_step_flops(trainer, state, batch) -> float:
    """FLOPs of one whole ``trainer.step`` (the forwards, the backwards and
    the optimiser), counted by ``torch.utils.flop_counter.FlopCounterMode``
    over the ATen operations the step dispatches (``eager_step``): the
    counterpart of XLA's count of the compiled step (``bench.py:50-100``).
    The step is real: it updates ``state``.  The norm and histogram kernels
    are ctypes calls, not ATen operations, and are not counted; their
    elementwise FLOPs are negligible beside the convolutions'."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        eager_step(trainer, state, batch)
    return float(counter.get_total_flops())


def card_info() -> tuple[str | None, str | None]:
    """(name, power limit) as nvidia-smi reports them, or (None, None)."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None, None
    name, _, limit = r.stdout.strip().splitlines()[0].partition(",")
    return name.strip(), limit.strip()


def measure(cfg, label: str, device="cuda", card=None) -> dict:
    """Images/s of ``cfg``'s train step (``bench.py:103-166``): one counted
    step, ``BENCH_WARMUP`` steps, then 3 trials of ``BENCH_ITERS`` steps on
    the host clock, each ended by syncing on ``errG``; the step time is the
    fastest trial's.  ``card`` is ``card_info()``'s pair, asked for here
    where the caller has none.  ``device="cpu"`` is for the tests; the CLI
    never passes it."""
    warmup = int(os.environ.get("BENCH_WARMUP", "25"))
    iters = int(os.environ.get("BENCH_ITERS", "20"))
    if warmup < 1 or iters < 1:
        raise ValueError(f"BENCH_WARMUP {warmup} and BENCH_ITERS {iters} "
                         "must be at least 1")
    dev = gan.resolve_device(device)
    trainer = gan.GANTrainer(cfg, dev)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    batch = bench_batch(cfg, dev)
    flops = count_step_flops(trainer, state, batch)

    def run(n):
        t0 = time.perf_counter()
        for _ in range(n):
            metrics = trainer.step(state, batch)
        float(metrics["errG"])   # waits for the card
        return time.perf_counter() - t0

    run(warmup)
    trials = [run(iters) for _ in range(3)]
    dt = min(trials) / iters

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peak = chip_peak(name, cfg.train.compute_dtype)
    out = {
        "label": label,
        "images_per_sec": round(cfg.train.batch_size / dt, 2),
        "step_ms": round(dt * 1e3, 2),
        "flops_per_step": flops,
        "mfu": round(flops / dt / peak, 4) if flops and peak else None,
    }
    # an exclusive card's trials agree to a few percent; a co-runner shows
    # up as spread between them
    spread = max(trials) / min(trials)
    if spread > float(os.environ.get("BENCH_SPREAD_BOUND", "1.3")):
        out["unstable_timing"] = round(spread, 3)
    smi_name, power_limit = card if card is not None else card_info()
    print(json.dumps({**out, "card": smi_name, "power_limit": power_limit}),
          file=sys.stderr, flush=True)
    return out


def probe_backend(timeout_s: float) -> str | None:
    """A bounded device probe in a subprocess (``bench.py:183-204``): CUDA
    is there and an 8x8 ones matmul on it sums to 512.  None on success,
    else the error."""
    code = ("import sys, torch\n"
            "if not torch.cuda.is_available():\n"
            "    sys.exit('CUDA is not available')\n"
            "x = torch.ones((8, 8), device='cuda')\n"
            "if float((x @ x).sum()) != 512.0:\n"
            "    sys.exit('the 8x8 ones matmul does not sum to 512')\n")
    try:
        proc = subprocess.run([sys.executable, "-c", code], text=True,
                              capture_output=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return f"backend unreachable (device probe hung > {timeout_s:.0f}s)"
    if proc.returncode != 0:
        return f"device probe failed: {proc.stderr[-300:]}"
    return None


def vs_baseline(images_per_sec: float, card: str, power_limit) -> float | None:
    """The ratio to ``bench_self.json`` where it names ``card``, None where
    it names another; where it is absent it is written from this run."""
    if os.path.exists(SELF_PATH):
        with open(SELF_PATH) as f:
            base = json.load(f)
        if base["card"] != card:
            return None
        return round(images_per_sec / base["images_per_sec"], 3)
    with open(SELF_PATH, "w") as f:
        json.dump({"images_per_sec": images_per_sec, "card": card,
                   "power_limit": power_limit,
                   "note": "first bench of the flagship on this card "
                           "(the reference publishes no throughput)"},
                  f, indent=1)
        f.write("\n")
    return 1.0


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--all", action="store_true",
                    help="also bench the per-domain SingleGAN k 5 arm and "
                         "the batch-256 flagship")
    ap.add_argument("--arms-out", default=os.path.join("runs",
                                                       "BENCH_ARMS.json"),
                    help="where --all writes the three arms' records")
    args = ap.parse_args(argv)

    err = probe_backend(float(os.environ.get("BENCH_PROBE_TIMEOUT", "600")))
    if err is not None:
        # one honest line instead of a hang; a nonzero exit so a failed
        # bench is not read as zero throughput
        print(json.dumps({"metric": METRIC, "value": None,
                          "unit": "images/sec", "vs_baseline": None,
                          "error": err}))
        sys.exit(1)
    if os.environ.get("BENCH_PROBE_ONLY"):
        print(json.dumps({"probe": "ok"}))
        return None

    # busy-card guard: wait for chip-lock holders (the loop and the CLIs
    # drop markers through utils.chiplock); if any survive the wait, the
    # line says so instead of recording a contended number silently
    holders = wait_chip_free(float(os.environ.get("BENCH_BUSY_WAIT",
                                                  "1800")))
    if holders:
        print(f"bench: the card is still held by pids {holders} after the "
              "wait; the result is annotated as contended", file=sys.stderr)
    if os.environ.get("BENCH_GUARD_ONLY"):
        print(json.dumps({"probe": "ok", "holders": holders}))
        return None

    smi = card_info()
    card, power_limit = smi
    flag = measure(flagship_cfg(), "srgan_full_b128", card=smi)
    if args.all:
        results = [flag] + [measure(cfg, label, card=smi)
                            for label, cfg in arm_cfgs().items()]
        os.makedirs(os.path.dirname(os.path.abspath(args.arms_out)),
                    exist_ok=True)
        with open(args.arms_out, "w") as f:
            json.dump({"results": results, "card": card,
                       "power_limit": power_limit,
                       "note": "3-arm bench; the flagship line is the "
                               "stdout line"}, f, indent=1)

    value = flag["images_per_sec"]
    line = {
        "metric": METRIC,
        "value": value,
        "unit": "images/sec",
        "vs_baseline": vs_baseline(value, torch.cuda.get_device_name(0),
                                   power_limit),
        "mfu": flag["mfu"],
        "step_ms": flag["step_ms"],
    }
    if holders:
        line["contended_with_pids"] = holders
    if "unstable_timing" in flag:
        line["unstable_timing"] = flag["unstable_timing"]
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
