"""Host input-pipeline benchmark: the native C++ decoder against PIL
(counterpart of ``scripts/bench_loader.py``).

Times whole-batch production (decode, centre-crop 178, resize 128, flip,
per-image min-max) through the port's ``DataLoader`` over a synthetic
CelebA fixture made in a temporary directory, once with
``decode="pil"`` and once with ``decode="native"``, and writes the rates
(images a second) to --out.  Where the native decoder cannot be built on
this host, ``native`` is null and ``native_error`` holds the compiler's
output; PIL is timed under ``pil`` only.  Run:

    python -m srgan_tpu_torch.bench_loader [--out runs/BENCH_LOADER.json]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

from srgan_tpu_torch.data import (
    DataLoader,
    FaceDataset,
    make_synthetic_celeba,
    native,
)


def run(loader, epochs):
    n = 0
    t0 = time.perf_counter()
    for _ in range(epochs):
        for batch in loader:
            n += batch["image"].shape[0]
    return n / (time.perf_counter() - t0)


def measure(ds, batch_size: int, epochs: int) -> dict:
    """The rates of both decoders over ``ds``; ``native`` null with its
    reason where the decoder cannot be had."""
    results = {"n_images": len(ds), "batch_size": batch_size,
               "epochs": epochs}
    for decode in ("pil", "native"):
        if decode == "native" and not native.available():
            results["native"] = None
            results["native_error"] = native.build_error()
            print("native decoder unavailable: "
                  + results["native_error"].splitlines()[0])
            continue
        dl = DataLoader(ds, batch_size=batch_size, drop_last=True, seed=0,
                        decode=decode)
        run(dl, 1)  # warm (file cache, lazy init)
        rate = run(dl, epochs)
        results[decode] = rate
        print(f"{decode}: {rate:.1f} img/s")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--per-class", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--out", default=os.path.join("runs",
                                                  "BENCH_LOADER.json"))
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as tmp:
        root, attrs = make_synthetic_celeba(os.path.join(tmp, "fixture"),
                                            n_per_class=args.per_class)
        ds = FaceDataset(root, attr_file=attrs, data_type="train",
                         train_num=args.per_class, val_num=0, test_num=1)
        results = measure(ds, args.batch_size, args.epochs)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"-> {args.out}")
    return results


if __name__ == "__main__":
    main()
