"""Latent sample sweep with the port (counterpart of
``scripts/sample_sweep.py``; the reference's test notebooks, get_samples
and save_gif, util_notebook.py:858 / util.py:356).

Loads a training run's checkpoint, sweeps latent codes per target class for
one test image and writes into --out:

  index{I}_class{C}.gif     the class's translations, one frame a latent
  latent_mu_class{C}.npy    the encoder's mu of each translation
  result_index{I}_grid.png  the progress grid of the image (matplotlib;
                            --no-grid skips it)

--ckpt is a run's ``ckpt`` directory of ``step_N`` checkpoints (``python -m
srgan_tpu_torch.train`` writes it; the latest unless --ckpt-step names
one); its run's ``config.json`` gives the model.  The latents are the JAX
script's: 24 standard-normal draws of numpy's default_rng(0), or with
--sweep-dim one dimension swept over -8..8.

Example:
  python -m srgan_tpu_torch.sample_sweep --ckpt runs/srgan/ckpt \\
      --data-root /data/celeba/img \\
      --attr-file /data/celeba/list_attr_celeba.txt --out runs/sweep
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from srgan_tpu_torch.configs import PRESETS, load_config_for_ckpt
from srgan_tpu_torch.data import FaceDataset, make_synthetic_celeba
from srgan_tpu_torch.data.dataset import LABEL_DESCRIPTION
from srgan_tpu_torch.training import gan
from srgan_tpu_torch.utils import viz
from srgan_tpu_torch.utils.checkpoint import restore_checkpoint
from srgan_tpu_torch.utils.chiplock import cli_device, hold_chip


def main(argv=None):
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
    ap.add_argument("--index", type=int, default=0)
    ap.add_argument("--num-latents", type=int, default=24)
    ap.add_argument("--sweep-dim", type=int, default=None,
                    help="sweep one latent dim -8..8 instead of random draws")
    ap.add_argument("--no-grid", action="store_true",
                    help="write no grid PNG (it needs matplotlib)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "twins of the kernels)")
    args = ap.parse_args(argv)

    if not args.no_grid:
        viz.require_matplotlib("the grid PNG (--no-grid skips it)")
    cfg = load_config_for_ckpt(args.ckpt, args.preset)
    trainer = gan.GANTrainer(cfg, args.device)
    data_root, attr_file = args.data_root, args.attr_file
    if args.synthetic or not data_root:
        data_root, attr_file = make_synthetic_celeba(
            os.path.join(tempfile.gettempdir(), "srgan_tpu_torch_synthetic"),
            n_per_class=16)
    test_ds = FaceDataset(data_root, attr_file=attr_file,
                          label_root=args.label_root, data_type="test",
                          train_num=cfg.train.train_num, val_num=0,
                          test_num=cfg.train.test_num,
                          image_size=cfg.model.image_size)

    state = trainer.init_state(torch.Generator().manual_seed(cfg.train.seed),
                               freeze_pretrained=cfg.pretrained_encoder)
    restore_checkpoint(args.ckpt, state, step=args.ckpt_step)

    if args.sweep_dim is not None:
        latent = np.zeros((args.num_latents, cfg.model.ndim), np.float32)
        latent[:, args.sweep_dim] = np.linspace(-8, 8, args.num_latents)
    else:
        latent = np.random.default_rng(0).standard_normal(
            (args.num_latents, cfg.model.ndim)).astype(np.float32)

    os.makedirs(args.out, exist_ok=True)
    data, label = viz.get_samples(trainer, state, test_ds, args.index, latent,
                                  classes=tuple(range(cfg.model.n_classes)))
    for cls, images in data["target"].items():
        viz.save_gif(images, os.path.join(
            args.out, f"index{args.index}_class{cls}.gif"))
        np.save(os.path.join(args.out, f"latent_mu_class{cls}.npy"),
                label["latent"][cls])
    if not args.no_grid:
        fig = viz.training_progress_grid(trainer, state, test_ds, args.index,
                                         LABEL_DESCRIPTION)
        fig.savefig(os.path.join(args.out,
                                 f"result_index{args.index}_grid.png"))
        viz.close(fig)
    print(f"GIFs{'' if args.no_grid else ' and grid'} -> {args.out}")


if __name__ == "__main__":
    # the bench's contention guard, on the device the run uses
    with hold_chip("sample_sweep", device=cli_device(sys.argv[1:])):
        main()
