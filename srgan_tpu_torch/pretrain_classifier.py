"""Pretrain the encoder-classifier with the port (counterpart of
``scripts/pretrain_classifier.py``, reference notebook 04).

Trains ``EncoderClassifier`` on the 4-way facial-attribute task (CE over
softmax outputs, Adam 1e-4, ExponentialLR 0.99, validation every 3 epochs,
best-accuracy retention) and writes into --out:

  classifier_best.pth   the best parameters in the reference's
                        ``Encoder_classifier`` layout, which
                        ``python -m srgan_tpu_torch.train --classifier-ckpt``
                        loads into the 05_srgan_full encoder
  metrics.jsonl         one record a validation
  test_metrics.json     best val accuracy, test accuracy, test_n and the
                        4x4 confusion matrix of the best parameters
  confusion_matrix.png  that matrix drawn, row-normalised (matplotlib;
                        --no-confusion-plot skips it)

Examples:
  python -m srgan_tpu_torch.pretrain_classifier --data-root /data/celeba/img \\
      --attr-file /data/celeba/list_attr_celeba.txt --out runs/clf
  python -m srgan_tpu_torch.pretrain_classifier --synthetic --device cpu \\
      --decode pil --train-num 8 --val-num 2 --test-num 2 --batch-size 8 \\
      --epochs 2 --image-size 64 --e-nch 8 --e-num-cls 2 --out runs/clf_smoke

"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

import numpy as np
import torch

from srgan_tpu_torch.configs import ClassifierConfig
from srgan_tpu_torch.data import DataLoader, FaceDataset, make_synthetic_celeba
from srgan_tpu_torch.data.dataset import LABEL_DESCRIPTION
from srgan_tpu_torch.training.classifier import ClassifierTrainer
from srgan_tpu_torch.utils import viz
from srgan_tpu_torch.utils.metrics import MetricLogger


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--data-root")
    ap.add_argument("--attr-file")
    ap.add_argument("--label-root")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--synthetic-per-class", type=int, default=24)
    ap.add_argument("--epochs", type=int)
    ap.add_argument("--batch-size", type=int)
    ap.add_argument("--train-num", type=int)
    ap.add_argument("--val-num", type=int)
    ap.add_argument("--test-num", type=int)
    # the encoder geometry of the SRGAN run that will load this checkpoint
    ap.add_argument("--e-nch", type=int)
    ap.add_argument("--e-num-cls", type=int)
    ap.add_argument("--image-size", type=int)
    ap.add_argument("--seed", type=int)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "twins of the kernels)")
    ap.add_argument("--decode", choices=("native", "pil"), default="native",
                    help="the C++ decoder (needs g++, libpng and libjpeg; "
                         "fails if it cannot build) or PIL")
    ap.add_argument("--no-confusion-plot", action="store_true",
                    help="write no confusion_matrix.png (it needs "
                         "matplotlib)")
    args = ap.parse_args(argv)
    if not args.no_confusion_plot:
        viz.require_matplotlib("confusion_matrix.png (--no-confusion-plot "
                               "skips it)")

    cfg = ClassifierConfig()
    model_over = {k: v for k, v in dict(
        e_nch=args.e_nch, e_num_cls=args.e_num_cls,
        image_size=args.image_size).items() if v is not None}
    if model_over:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, **model_over))
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, seed=args.seed)
    if args.synthetic and args.test_num is None:
        args.test_num = 4   # test_num 100 would swallow a small fixture
    over = {k: v for k, v in dict(epochs=args.epochs,
                                  batch_size=args.batch_size,
                                  train_num=args.train_num,
                                  val_num=args.val_num,
                                  test_num=args.test_num).items()
            if v is not None}
    if over:
        cfg = dataclasses.replace(cfg, **over)

    trainer = ClassifierTrainer(cfg, args.device)
    data_root, attr_file = args.data_root, args.attr_file
    if args.synthetic or not data_root:
        data_root, attr_file = make_synthetic_celeba(
            os.path.join(tempfile.gettempdir(),
                         "srgan_tpu_torch_synthetic_clf"),
            n_per_class=args.synthetic_per_class)

    common = dict(attr_file=attr_file, label_root=args.label_root,
                  train_num=cfg.train_num, val_num=cfg.val_num,
                  test_num=cfg.test_num, image_size=cfg.model.image_size)
    train_ds = FaceDataset(data_root, data_type="train", **common)
    val_ds = FaceDataset(data_root, data_type="val", **common)
    if len(train_ds) < cfg.batch_size:
        raise SystemExit(
            f"train split has {len(train_ds)} images < batch "
            f"{cfg.batch_size}; check train/val/test_num vs dataset size")

    state = trainer.init_state()
    os.makedirs(args.out, exist_ok=True)
    logger = MetricLogger(os.path.join(args.out, "metrics.jsonl"), echo=True)

    def batches(ds, train):
        dl = DataLoader(ds, batch_size=cfg.batch_size, shuffle=train,
                        drop_last=train, sample_targets=False,
                        seed=cfg.seed, decode=args.decode)
        for b in dl:
            yield b["image"], b["source_label"]

    state, best, best_acc = trainer.fit(
        state, lambda: batches(train_ds, True),
        (lambda: batches(val_ds, False)) if len(val_ds) else None,
        log_fn=logger.log)
    logger.close()
    if best is None:
        best = {k: v.detach().cpu() for k, v in
                state.model.state_dict().items()}
    torch.save(best, os.path.join(args.out, "classifier_best.pth"))
    print(f"best val accuracy: {best_acc:.4f} -> "
          f"{args.out}/classifier_best.pth")

    # nb04 cells 28-33: test accuracy and confusion matrix of the BEST
    # parameters
    test_ds = FaceDataset(data_root, data_type="test", **common)
    if len(test_ds):
        state.model.load_state_dict(best)
        labels, preds, test_acc = trainer.evaluate(
            state, batches(test_ds, False))
        n = cfg.model.n_classes
        cm = np.zeros((n, n), np.int64)
        np.add.at(cm, (labels, preds), 1)
        with open(os.path.join(args.out, "test_metrics.json"), "w") as f:
            json.dump({"best_val_accuracy": best_acc,
                       "test_accuracy": test_acc,
                       "test_n": int(len(labels)),
                       "confusion_matrix": cm.tolist()}, f, indent=1)
        if not args.no_confusion_plot:
            viz.close(viz.plot_confusion_matrix(
                cm, [LABEL_DESCRIPTION[i] for i in range(n)],
                title="Encoder classifier (test)",
                save_path=os.path.join(args.out, "confusion_matrix.png")))
        print(f"test accuracy: {test_acc:.4f} (confusion matrix in "
              f"{args.out})")


if __name__ == "__main__":
    main()
