"""Serving-path benchmark: ``Translator`` latency and throughput on one card
(counterpart of ``scripts/bench_serving.py``).

Measures the inference surface (``srgan_tpu_torch/serving.py``, the
deployment counterpart of the reference's ``get_output_and_plot`` /
``get_samples`` sampling path) as a client sees it: numpy in, translated
numpy out, the host-to-device copies and the chunking included.  The
weights are freshly initialised from seeded ``torch.Generator``s (serving
cost does not depend on their values) at the preset's full width.

For each batch size it times ``Translator.translate`` (--iters calls after
one warm call, host clock) and reports p50 and p95.  Then the device-only
number: 20 generator forwards chained on the card at the largest batch,
each fed ``x + 1e-6 * y`` of the one before so that none can be skipped,
timed with CUDA events (the host clock on the CPU).  Writes --out and
prints one JSON line per batch size.  Run:

    python -m srgan_tpu_torch.bench_serving [--compute-dtype bfloat16] \\
        [--out runs/BENCH_SERVING.json]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time

import numpy as np
import torch

from srgan_tpu_torch.configs import PRESETS
from srgan_tpu_torch.serving import Translator
from srgan_tpu_torch.training import gan

N_CHAIN = 20


def fresh_translator(cfg, device, sizes) -> Translator:
    """A Translator over seeded random weights, warmed at ``sizes``."""
    G = gan.build_generator(cfg, "cpu", torch.Generator().manual_seed(0))
    E = gan.build_encoder(cfg, "cpu", torch.Generator().manual_seed(1))
    return Translator.from_state_dicts(cfg, G.state_dict(), E.state_dict(),
                                       device=device,
                                       warm_batch_sizes=tuple(sizes))


def client_row(tr: Translator, cfg, b: int, iters: int,
               rng: np.random.Generator) -> dict:
    """p50 and p95 of ``translate`` at batch ``b``, host clock."""
    hw = cfg.model.image_size
    x = rng.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32)
    tgt = rng.integers(0, cfg.model.n_classes, b)
    lat = rng.normal(size=(b, cfg.model.ndim)).astype(np.float32)
    tr.translate(x, tgt, latent=lat)  # warm this exact path
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        tr.translate(x, tgt, latent=lat)
        times.append(time.perf_counter() - t0)
    times.sort()
    p50 = times[len(times) // 2] * 1e3
    p95 = times[int(len(times) * 0.95)] * 1e3
    return {"batch": b, "p50_ms": p50, "p95_ms": p95,
            "img_per_sec_p50": b / (p50 / 1e3)}


def device_only(tr: Translator, cfg, b: int, rng: np.random.Generator,
                n_chain: int = N_CHAIN) -> dict:
    """``n_chain`` generator forwards back to back at batch ``b``, each on
    ``x + 1e-6 * y`` of the one before; ms per forward."""
    dev = tr.device
    hw = cfg.model.image_size
    x = torch.from_numpy(rng.uniform(-1, 1, (b, 3, hw, hw))
                         .astype(np.float32)).to(dev)
    onehot = gan.onehot(rng.integers(0, cfg.model.n_classes, b),
                        cfg.model.n_classes)
    latent = torch.from_numpy(rng.normal(size=(b, cfg.model.ndim))
                              .astype(np.float32))
    cond = torch.cat([onehot, latent], 1).to(dev)
    autocast = torch.autocast(dev.type, dtype=torch.bfloat16) if tr.bf16 \
        else contextlib.nullcontext()

    def chained():
        y = x
        for _ in range(n_chain):
            y = x + 1e-6 * tr.G(y, cond).float()
        return y

    with torch.inference_mode(), autocast:
        chained()  # warm
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            r = chained()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            r = chained()
            ms = (time.perf_counter() - t0) * 1e3
    if not bool(torch.isfinite(r).all()):
        raise FloatingPointError("the chained forwards gave a non-finite "
                                 "value")
    per = ms / n_chain
    return {"batch": b, "ms_per_forward": per, "img_per_sec": b / per * 1e3,
            "chained_steps": n_chain}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="03_srgan_nopretraining",
                    choices=sorted(PRESETS))
    ap.add_argument("--batch-sizes", default="1,8,32,128")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--out", default=os.path.join("runs",
                                                  "BENCH_SERVING.json"))
    ap.add_argument("--compute-dtype", default=None,
                    choices=("float32", "bfloat16"),
                    help="override the preset's compute dtype (bfloat16 "
                         "for throughput serving)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "twins of the kernels)")
    args = ap.parse_args(argv)

    gan.resolve_device(args.device)
    sizes = [int(s) for s in args.batch_sizes.split(",")]
    cfg = PRESETS[args.preset]()
    if args.compute_dtype:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train,
                                           compute_dtype=args.compute_dtype))

    t0 = time.perf_counter()
    tr = fresh_translator(cfg, args.device, sizes)
    warm_s = time.perf_counter() - t0
    dev = tr.device
    rng = np.random.default_rng(0)
    results = {"preset": args.preset, "image_size": cfg.model.image_size,
               "compute_dtype": cfg.train.compute_dtype,
               "device": torch.cuda.get_device_name(dev)
               if dev.type == "cuda" else "cpu",
               "warmup_s": warm_s, "batches": []}
    for b in sizes:
        row = client_row(tr, cfg, b, args.iters, rng)
        results["batches"].append(row)
        print(json.dumps(row), flush=True)
    results["device_only"] = device_only(tr, cfg, max(sizes), rng)
    print(json.dumps(results["device_only"]), flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"-> {args.out}")
    return results


if __name__ == "__main__":
    main()
