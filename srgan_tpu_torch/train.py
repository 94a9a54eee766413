"""Train a preset with the port (counterpart of ``scripts/train.py``): the
SRGAN presets 03 and 05 and the SingleGAN baselines 01 (per-domain Ds) and
02 (solo D), with progress grids by default.

Examples:
  # full SRGAN on CelebA, on the GPU
  python -m srgan_tpu_torch.train --preset 05_srgan_full \\
      --data-root /data/celeba/img --attr-file /data/celeba/list_attr_celeba.txt \\
      --classifier-ckpt runs/clf/classifier_best.pth --out runs/srgan

  # smoke run on synthetic data, on the CPU, PIL decode
  python -m srgan_tpu_torch.train --preset 01_proposed_singlegan_k5 \\
      --synthetic --device cpu --decode pil --batch-size 16 --epochs 2 \\
      --unrolled-k 1 --out runs/singlegan_smoke

  # data parallel over N GPUs of one host (NCCL), one process a GPU
  torchrun --nproc_per_node N -m srgan_tpu_torch.train \
      --preset 05_srgan_full ... --mesh [--grad-sync manual]

The grids (progress_e*_i*.png in --out) need matplotlib; --no-sample-grids
turns them off.  --mesh joins the process group torchrun sets up (RANK,
WORLD_SIZE, LOCAL_RANK) and raises without one; --batch-size is the global
batch, split over the ranks; rank 0 alone writes --out.
"""

from __future__ import annotations

import argparse
import dataclasses

from srgan_tpu_torch.configs import PRESETS
from srgan_tpu_torch.training.loop import train_gan


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", required=True, choices=sorted(PRESETS))
    ap.add_argument("--out", required=True)
    ap.add_argument("--data-root")
    ap.add_argument("--attr-file")
    ap.add_argument("--label-root")
    ap.add_argument("--synthetic", action="store_true",
                    help="use a generated synthetic CelebA stand-in")
    ap.add_argument("--synthetic-per-class", type=int, default=16)
    ap.add_argument("--classifier-ckpt",
                    help=".pth of the nb04 classifier (Encoder_classifier "
                         "layout)")
    ap.add_argument("--mesh", action="store_true",
                    help="data parallel over the torchrun process group, "
                         "one device a rank")
    ap.add_argument("--grad-sync", choices=("auto", "manual"),
                    default="auto",
                    help="with --mesh: both run one gradient all-reduce per "
                         "update; auto also sums batch-norm moments over "
                         "the ranks, manual refuses batch norm")
    ap.add_argument("--epochs", type=int)
    ap.add_argument("--batch-size", type=int)
    ap.add_argument("--unrolled-k", type=int)
    ap.add_argument("--train-num", type=int)
    ap.add_argument("--test-num", type=int)
    ap.add_argument("--compute-dtype", choices=["float32", "bfloat16"])
    ap.add_argument("--seed", type=int,
                    help="training seed (init + shuffling + latents)")
    ap.add_argument("--lr-gamma", type=float,
                    help="ExponentialLR per-epoch decay (default: the "
                         "preset's 0.95, the reference's value)")
    # model-geometry overrides (kept in the run's config.json)
    ap.add_argument("--image-size", type=int)
    ap.add_argument("--g-nch", type=int)
    ap.add_argument("--d-nch", type=int)
    ap.add_argument("--e-nch", type=int)
    ap.add_argument("--g-res-num", type=int)
    ap.add_argument("--d-num-cls", type=int)
    ap.add_argument("--e-num-cls", type=int)
    ap.add_argument("--no-sample-grids", action="store_true",
                    help="draw no progress grids (they need matplotlib)")
    ap.add_argument("--grid-every-epochs", type=int, default=1,
                    help="draw the progress grids only every N epochs "
                         "(default 1: the reference's ~3 an epoch)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in --out")
    ap.add_argument("--profile-dir",
                    help="write a torch.profiler trace of the run here "
                         "(trace.json) and the program's spans beside it "
                         "(spans.json)")
    ap.add_argument("--debug-nans", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "twins of the kernels)")
    ap.add_argument("--decode", choices=("native", "pil"), default="native",
                    help="the C++ decoder (needs g++, libpng and libjpeg; "
                         "fails if it cannot build) or PIL")
    args = ap.parse_args(argv)

    cfg = PRESETS[args.preset]()
    if args.synthetic and args.test_num is None:
        # synthetic fixtures are small; the preset's test_num=100 would
        # swallow the whole dataset (new_train_num = N - val - test)
        args.test_num = 4
    train_over = {k: v for k, v in dict(
        batch_size=args.batch_size, unrolled_k=args.unrolled_k,
        train_num=args.train_num, compute_dtype=args.compute_dtype,
        test_num=args.test_num, seed=args.seed,
        lr_gamma=args.lr_gamma, epochs=args.epochs).items() if v is not None}
    if train_over:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, **train_over))
    model_over = {k: v for k, v in dict(
        image_size=args.image_size, g_nch=args.g_nch, d_nch=args.d_nch,
        e_nch=args.e_nch, g_res_num=args.g_res_num,
        d_num_cls=args.d_num_cls, e_num_cls=args.e_num_cls).items()
        if v is not None}
    if model_over:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, **model_over))
    if not (args.synthetic or args.data_root):
        ap.error("pass --data-root/--attr-file (or --label-root), "
                 "or --synthetic")
    mesh = None
    if args.mesh:
        from srgan_tpu_torch.parallel import make_mesh

        mesh = make_mesh(args.device)
    try:
        train_gan(cfg, args.out, data_root=args.data_root,
                  attr_file=args.attr_file, label_root=args.label_root,
                  epochs=args.epochs, classifier_ckpt=args.classifier_ckpt,
                  sample_grids=not args.no_sample_grids,
                  grid_every_epochs=args.grid_every_epochs,
                  synthetic_per_class=args.synthetic_per_class,
                  resume=args.resume, profile_dir=args.profile_dir,
                  debug_nans=args.debug_nans, device=args.device,
                  decode=args.decode, mesh=mesh, grad_sync=args.grad_sync)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()
    if mesh is None or mesh.rank == 0:
        print(f"done -> {args.out}")


if __name__ == "__main__":
    main()
