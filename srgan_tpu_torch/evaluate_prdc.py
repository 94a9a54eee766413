"""PRDC evaluation of a trained SRGAN with the port (counterpart of
``scripts/evaluate_prdc.py``; the reference's test notebooks and notebook
06).

For each (source, target) domain pair: takes the test images of the source
domain, translates them to the target domain with random latents
(``training/gan.py::transform``), embeds the real target-domain images and
the translated ones with each chosen VGG19-BN, computes precision, recall,
density and coverage, repeats, pickles the ``evaluation_init``-shaped dict
to --out and prints the nb06 tables.

--ckpt is a run's ``ckpt`` directory of ``step_N`` checkpoints (``python -m
srgan_tpu_torch.train`` writes it); its run's ``config.json`` gives the
model.  --init-baseline scores a fresh init of that config instead.
--vgg-celeba-ckpt takes ``python -m srgan_tpu_torch.finetune_vgg``'s
``vgg_celeba_best.pth``, --vgg-imagenet-pth a local torchvision
``vgg19_bn`` state dict.

Example:
  python -m srgan_tpu_torch.evaluate_prdc --ckpt runs/srgan/ckpt \\
      --data-root /data/celeba/img \\
      --attr-file /data/celeba/list_attr_celeba.txt \\
      --feature-extractors vgg-initialization vgg-CelebA \\
      --vgg-celeba-ckpt runs/vgg/vgg_celeba_best.pth --out runs/prdc.pkl
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import tempfile

import numpy as np
import torch

from srgan_tpu_torch.configs import PRESETS, PRDCConfig, load_config_for_ckpt
from srgan_tpu_torch.data import FaceDataset, make_synthetic_celeba
from srgan_tpu_torch.evaluation.harness import (
    GANEvaluation,
    comparison_table,
    evaluation_init,
)
from srgan_tpu_torch.training import gan
from srgan_tpu_torch.utils.checkpoint import (
    load_state_dict_file,
    restore_checkpoint,
)
from srgan_tpu_torch.utils.chiplock import cli_device, hold_chip


def main(argv=None):
    prdc = PRDCConfig()
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", choices=sorted(PRESETS),
                    help="fallback when the run dir has no config.json")
    ap.add_argument("--ckpt", required=True,
                    help="the run's ckpt directory (step_N checkpoints)")
    ap.add_argument("--ckpt-step", type=int)
    ap.add_argument("--out", required=True)
    ap.add_argument("--data-root")
    ap.add_argument("--attr-file")
    ap.add_argument("--label-root")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--feature-extractors", nargs="+",
                    choices=prdc.feature_extractors,
                    default=["vgg-initialization"])
    ap.add_argument("--vgg-imagenet-pth",
                    help="torchvision vgg19_bn .pth for vgg-ImageNet")
    ap.add_argument("--vgg-celeba-ckpt",
                    help="vgg_celeba_best.pth of finetune_vgg (vgg-CelebA)")
    ap.add_argument("--num-samples", type=int, default=100)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--nearest-k", type=int, default=prdc.nearest_k)
    ap.add_argument("--test-num", type=int, default=100)
    ap.add_argument("--init-baseline", action="store_true",
                    help="evaluate a FRESH-INIT model of the checkpoint's "
                         "config instead of restoring weights (the "
                         "untrained reference point of the nb06 tables)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "twins of the kernels)")
    args = ap.parse_args(argv)

    cfg = load_config_for_ckpt(args.ckpt, args.preset)
    trainer = gan.GANTrainer(cfg, args.device)
    device = trainer.device
    for fe in args.feature_extractors:
        if "ImageNet" in fe and not args.vgg_imagenet_pth:
            raise SystemExit(f"{fe} needs --vgg-imagenet-pth")
        if "CelebA" in fe and not args.vgg_celeba_ckpt:
            raise SystemExit(f"{fe} needs --vgg-celeba-ckpt")
    data_root, attr_file = args.data_root, args.attr_file
    if args.synthetic or not data_root:
        data_root, attr_file = make_synthetic_celeba(
            os.path.join(tempfile.gettempdir(), "srgan_tpu_torch_synthetic"),
            n_per_class=max(16, args.test_num))

    test_ds = FaceDataset(data_root, attr_file=attr_file,
                          label_root=args.label_root, data_type="test",
                          train_num=cfg.train.train_num, val_num=0,
                          test_num=args.test_num,
                          image_size=cfg.model.image_size)
    classes = tuple(range(cfg.model.n_classes))
    by_class = {c: np.stack([test_ds[i][0] for i in range(len(test_ds))
                             if test_ds.labels[i] == c]) for c in classes}

    state = trainer.init_state(torch.Generator().manual_seed(cfg.train.seed),
                               freeze_pretrained=cfg.pretrained_encoder)
    if not args.init_baseline:
        restore_checkpoint(args.ckpt, state, step=args.ckpt_step)

    evaluators = {}
    for fe in args.feature_extractors:
        sd = None
        if "ImageNet" in fe:
            sd = load_state_dict_file(args.vgg_imagenet_pth)
        elif "CelebA" in fe:
            sd = load_state_dict_file(args.vgg_celeba_ckpt)
        evaluators[fe] = GANEvaluation(fe, classes=classes, state_dict=sd,
                                       device=device)

    results = evaluation_init(args.feature_extractors, classes)
    latents = torch.Generator(device=device).manual_seed(0)
    for rep in range(args.repeats):
        for s in classes:
            src = torch.from_numpy(by_class[s][:args.num_samples]).to(device)
            for t in classes:
                z = torch.randn((len(src), cfg.model.ndim),
                                generator=latents, device=device)
                fake, _ = gan.transform(state.G, src,
                                        torch.full((len(src),), t), z)
                real = by_class[t][:args.num_samples]
                for fe, ev in evaluators.items():
                    m = ev.get_prdc(real, fake, nearest_k=args.nearest_k,
                                    batch=prdc.batch)
                    for k, v in m.items():
                        results[fe][s][t][k].append(v)
                print(f"rep {rep} s={s} t={t}: " + " ".join(
                    f"{fe}:{results[fe][s][t]['coverage'][-1]:.3f}"
                    for fe in evaluators))

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "wb") as f:
        pickle.dump(results, f)
    for fe in evaluators:
        for metric in prdc.metrics:
            mat = comparison_table(results, fe, metric, classes)
            print(f"\n{fe} / {metric} (source x target):")
            print(np.array_str(mat, precision=4))
    print(f"\nresults -> {args.out}")


if __name__ == "__main__":
    # the bench's contention guard, on the device the run uses
    with hold_chip("evaluate_prdc", device=cli_device(sys.argv[1:])):
        main()
