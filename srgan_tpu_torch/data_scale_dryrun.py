"""Reference-scale ingest dry run: the full 202,599-row CelebA data path
(counterpart of ``scripts/data_scale_dryrun.py``).

Proves the port's ingest path at the dataset scale the reference uses
(reference dataset.py:20-141 with train_num 10,000 a class, notebook A
cell 5's chunked label folder):

  1. synthesise a 202,599-row ``list_attr_celeba.txt`` (realistic
     attribute marginals, no pixels);
  2. time ``parse_attr_file``, ``build_label_folder`` (41 chunk pickles)
     and ``load_label_store``, the notebook-A path;
  3. build the train/val/test ``FaceDataset`` splits at the reference's
     scale (TRAIN_NUM, VAL_NUM, TEST_NUM a class) and check their sizes,
     their disjointness and their class-major order;
  4. hardlink a small pool of 178x218 PNGs over every selected path and
     time decode, crop, resize and min-max through the ``DataLoader``
     with the native decoder and with PIL.

Where the native decoder cannot be built on this host, ``loader.native``
is null and ``loader.native_error`` holds the compiler's output; PIL is
timed under ``loader.pil`` only.  The work directory is a temporary one
unless --workdir names one (which must not hold an earlier run's images).
Writes one JSON (--out) with every timing and rate and the host's CPU
count and load average.  Run:

    python -m srgan_tpu_torch.data_scale_dryrun \\
        [--out runs/data_scale_dryrun.json]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from srgan_tpu_torch.data import (
    DataLoader,
    FaceDataset,
    build_label_folder,
    load_label_store,
    make_scale_attr_file,
    make_synthetic_celeba,
    native,
    parse_attr_file,
)

TRAIN_NUM, VAL_NUM, TEST_NUM = 10_000, 500, 500   # the reference's nb01 scale


def _timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def _loader_throughput(ds, batch_size: int, n_batches: int, workers: int,
                       decode: str) -> dict:
    loader = DataLoader(ds, batch_size=batch_size, shuffle=True,
                        num_workers=workers, decode=decode, seed=0)
    it = iter(loader)
    first = next(it)                       # warm-up (thread pool, lib load)
    assert first["image"].shape == (batch_size, ds.image_size,
                                    ds.image_size, 3)
    n_img, t0 = 0, time.perf_counter()
    for _ in range(n_batches):
        batch = next(it)
        n_img += batch["image"].shape[0]
    dt = time.perf_counter() - t0
    return {"native": decode == "native", "images": n_img, "seconds": dt,
            "img_per_s": n_img / dt}


def dry_run(workdir: str, n_rows: int, pixel_pool: int, bench_batches: int,
            batch_size: int, workers: int) -> dict:
    os.makedirs(workdir, exist_ok=True)
    report = {"n_rows": n_rows, "train_num": TRAIN_NUM,
              "val_num": VAL_NUM, "test_num": TEST_NUM,
              "cpu_count": os.cpu_count(),
              "loadavg_start": os.getloadavg()}

    # -- 1. full-scale attribute file ------------------------------------
    attr_path = os.path.join(workdir, "list_attr_celeba.txt")
    _, t = _timed(make_scale_attr_file, attr_path, n_rows, 0)
    report["synthesize_attr_s"] = t
    report["attr_file_mb"] = round(os.path.getsize(attr_path) / 2**20, 1)

    # -- 2. notebook-A label-folder build ---------------------------------
    info, t = _timed(parse_attr_file, attr_path)
    report["parse_attr_s"] = t
    assert info.shape == (n_rows, 41), info.shape

    label_root = os.path.join(workdir, "label_folder")
    chunk_paths, t = _timed(build_label_folder, attr_path, label_root)
    report["build_label_folder_s"] = t
    report["label_chunks"] = len(chunk_paths)       # ceil(202599/5000) = 41

    chunks, t = _timed(load_label_store, label_root)
    report["load_label_store_s"] = t
    assert sum(len(c) for c in chunks) == n_rows

    # -- 3. FaceDataset splits at reference scale --------------------------
    img_root = os.path.join(workdir, "img")
    os.makedirs(img_root, exist_ok=True)
    splits, paths, datasets = {}, {}, {}
    for dtype in ("train", "val", "test"):
        ds, t = _timed(FaceDataset, img_root, label_root=label_root,
                       data_type=dtype, train_num=TRAIN_NUM,
                       val_num=VAL_NUM, test_num=TEST_NUM)
        counts = np.bincount(ds.labels, minlength=4).tolist()
        splits[dtype] = {"init_s": t, "size": len(ds), "per_class": counts}
        # class-major ordering (quirk #10): labels must be non-decreasing
        assert (np.diff(ds.labels) >= 0).all(), "not class-major"
        paths[dtype], datasets[dtype] = set(ds.images), ds
    # per-class split disjointness + exact sizes
    for dtype, want in (("train", TRAIN_NUM), ("val", VAL_NUM),
                        ("test", TEST_NUM)):
        per = splits[dtype]["per_class"]
        assert all(c == want for c in per), (dtype, per)
    assert not (paths["train"] & paths["val"])
    assert not (paths["train"] & paths["test"])
    assert not (paths["val"] & paths["test"])
    all_paths = sorted(set.union(*paths.values()))
    report["splits"] = splits
    report["selected_images"] = len(all_paths)      # 4*(10000+500+500)

    # -- 4. pixel pool + loader throughput --------------------------------
    pool_dir, t = _timed(make_synthetic_celeba,
                         os.path.join(workdir, "pool"),
                         pixel_pool // 4, seed=1, mode="structured")
    pool_pngs = sorted(os.path.join(pool_dir[0], f)
                       for f in os.listdir(pool_dir[0]))
    report["pixel_pool"] = {"distinct": len(pool_pngs), "generate_s": t}

    t0 = time.perf_counter()
    for i, path in enumerate(all_paths):
        os.link(pool_pngs[i % len(pool_pngs)], path)
    report["hardlink_s"] = time.perf_counter() - t0

    train_ds = datasets["train"]
    bench = {}
    if native.available():
        bench["native"] = _loader_throughput(
            train_ds, batch_size, bench_batches, workers, "native")
    else:
        bench["native"] = None
        bench["native_error"] = native.build_error()
    bench["pil"] = _loader_throughput(
        train_ds, batch_size, max(4, bench_batches // 4), workers, "pil")
    if bench["native"] is not None:
        bench["native_speedup"] = (bench["native"]["img_per_s"]
                                   / bench["pil"]["img_per_s"])
    report["loader"] = bench
    report["loadavg_end"] = os.getloadavg()
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workdir",
                    help="work directory (default: a temporary one, "
                         "removed at the end)")
    ap.add_argument("--out", default=os.path.join("runs",
                                                  "data_scale_dryrun.json"))
    ap.add_argument("--n-rows", type=int, default=202_599)
    ap.add_argument("--pixel-pool", type=int, default=256,
                    help="distinct PNGs; all dataset paths hardlink into it")
    ap.add_argument("--bench-batches", type=int, default=24)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--workers", type=int, default=8)
    args = ap.parse_args(argv)

    run = dict(n_rows=args.n_rows, pixel_pool=args.pixel_pool,
               bench_batches=args.bench_batches, batch_size=args.batch_size,
               workers=args.workers)
    if args.workdir:
        report = dry_run(args.workdir, **run)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            report = dry_run(tmp, **run)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
