"""Fine-tune VGG19-BN on the 4 CelebA classes with the port (counterpart of
``scripts/finetune_vgg.py``, the missing notebook B).

Produces the "vgg-CelebA" PRDC feature extractor: --out gets
``vgg_celeba_best.pth`` (torchvision ``vgg19_bn`` layout, a 4-way head, the
best validation accuracy's parameters) and ``metrics.jsonl``.  lr 5e-5 is
the shipped checkpoint's (facial_recognizer_vgg_lr5e-05_epoch126.pth).
It starts from torchvision's random init or from --imagenet-pth, a local
torchvision ``vgg19_bn`` state dict whose 1000-way head is replaced by a
fresh 4-way one.

Examples:
  python -m srgan_tpu_torch.finetune_vgg --data-root /data/celeba/img \\
      --attr-file /data/celeba/list_attr_celeba.txt \\
      --imagenet-pth vgg19_bn.pth --out runs/vgg
  python -m srgan_tpu_torch.finetune_vgg --synthetic --device cpu \\
      --decode pil --train-num 2 --val-num 2 --batch-size 4 --epochs 1 \\
      --val-every 1 --out runs/vgg_smoke

Unlike the JAX script, --synthetic holds out 4 test images a class, not 100
(as ``pretrain_classifier`` does): 100 would leave its 24-a-class fixture
no training image.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch
from torch import nn

from srgan_tpu_torch.data import DataLoader, FaceDataset, make_synthetic_celeba
from srgan_tpu_torch.evaluation.features import torchvision_init_
from srgan_tpu_torch.training.vgg_finetune import VGGFinetuneTrainer
from srgan_tpu_torch.utils.checkpoint import load_state_dict_file
from srgan_tpu_torch.utils.chiplock import cli_device, hold_chip
from srgan_tpu_torch.utils.metrics import MetricLogger

N_CLASSES = 4
SYNTHETIC_PER_CLASS = 24


def imagenet_start(path: str, seed: int = 0):
    """The torchvision state dict at ``path`` with ``classifier.6`` replaced
    by a fresh ``N_CLASSES``-way head, torchvision's init drawn from a
    generator seeded with ``seed`` (evaluation.py:56)."""
    sd = load_state_dict_file(path)
    head = torchvision_init_(nn.Linear(4096, N_CLASSES),
                             torch.Generator().manual_seed(seed))
    sd["classifier.6.weight"] = head.weight.detach()
    sd["classifier.6.bias"] = head.bias.detach()
    return sd


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--data-root")
    ap.add_argument("--attr-file")
    ap.add_argument("--label-root")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--imagenet-pth")
    ap.add_argument("--epochs", type=int, default=127)
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--train-num", type=int, default=10000)
    ap.add_argument("--val-num", type=int, default=1000)
    ap.add_argument("--val-every", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    ap.add_argument("--decode", choices=("native", "pil"), default="native",
                    help="the C++ decoder (needs g++, libpng and libjpeg; "
                         "fails if it cannot build) or PIL")
    args = ap.parse_args(argv)

    trainer = VGGFinetuneTrainer(n_classes=N_CLASSES, lr=args.lr,
                                 device=args.device)
    data_root, attr_file = args.data_root, args.attr_file
    if args.synthetic or not data_root:
        data_root, attr_file = make_synthetic_celeba(
            os.path.join(tempfile.gettempdir(),
                         "srgan_tpu_torch_synthetic_vgg"),
            n_per_class=SYNTHETIC_PER_CLASS)
    common = dict(attr_file=attr_file, label_root=args.label_root,
                  train_num=args.train_num, val_num=args.val_num,
                  test_num=4 if args.synthetic else 100)
    train_ds = FaceDataset(data_root, data_type="train", **common)
    val_ds = FaceDataset(data_root, data_type="val", **common)

    state = trainer.init_state(
        state_dict=imagenet_start(args.imagenet_pth) if args.imagenet_pth
        else None)
    os.makedirs(args.out, exist_ok=True)
    logger = MetricLogger(os.path.join(args.out, "metrics.jsonl"), echo=True)
    best_acc, best = -1.0, None
    m = {}
    for epoch in range(args.epochs):
        dl = DataLoader(train_ds, batch_size=args.batch_size, drop_last=True,
                        sample_targets=False, seed=epoch, decode=args.decode)
        for b in dl:
            m = trainer.step(state, b["image"], b["source_label"])
        if len(val_ds) and epoch % args.val_every == 0:
            vl = DataLoader(val_ds, batch_size=args.batch_size, shuffle=False,
                            drop_last=False, sample_targets=False,
                            decode=args.decode)
            acc = trainer.evaluate(state, ((b["image"], b["source_label"])
                                           for b in vl))
            logger.log({"epoch": epoch, "val_accuracy": acc,
                        **{k: float(v) for k, v in m.items()}})
            if acc > best_acc:
                best_acc, best = acc, {
                    k: v.detach().to("cpu", copy=True)
                    for k, v in state.model.state_dict().items()}
    logger.close()
    if best is None:
        best = {k: v.detach().cpu() for k, v in
                state.model.state_dict().items()}
    torch.save(best, os.path.join(args.out, "vgg_celeba_best.pth"))
    print(f"best val accuracy {best_acc:.4f} -> "
          f"{args.out}/vgg_celeba_best.pth")


if __name__ == "__main__":
    # the bench's contention guard, on the device the run uses
    with hold_chip("finetune_vgg", device=cli_device(sys.argv[1:])):
        main()
