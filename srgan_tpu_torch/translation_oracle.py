"""Distribution-level translation metric on the synthetic fixture
(counterpart of ``scripts/translation_oracle.py``).

The synthetic CelebA stand-in gives each of the 4 (Male x Smiling)
classes a mean-colour signature (``data/synthetic.py``).  An oracle
classifier, the nearest class signature by channel mean fitted on real
images, scores translated fakes by whether they land in the target class.
On this fixture it measures what PRDC over random VGG features cannot:
whether training learned the translation.

Writes a summary JSON with the keys of the JAX script's: ``real_acc``
(the oracle on the real images, which must be 1.0), then ``init`` and
``trained``, each with ``acc``, ``perfect_pairs`` and ``pairs`` (the
accuracy of every source -> target pair), for the checkpoint's generator
and for a fresh one of the same config.

By design the draws are torch's, not the JAX package's: the fresh
generator is ``build_generator`` from a ``torch.Generator`` seeded with 0,
and the latents come from a ``torch.Generator`` seeded with 0, one draw
per pair in sorted pair order, the same for both generators.  Run:

    python -m srgan_tpu_torch.translation_oracle --ckpt RUN/ckpt \\
        --data-root DATA/img --attr-file DATA/list_attr_celeba.txt \\
        --out runs/oracle.json

--ckpt is a training run's checkpoint directory (``python -m
srgan_tpu_torch.train`` writes RUN/ckpt/step_N); the latest step is scored
unless --ckpt-step names one, and the run's config.json names the model
(as ``serve --ckpt`` finds it).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from srgan_tpu_torch.configs import PRESETS, load_config_for_ckpt
from srgan_tpu_torch.data import FaceDataset
from srgan_tpu_torch.training import gan
from srgan_tpu_torch.utils.checkpoint import load_state_dict_file, step_dir


def class_means(images_by_class):
    return {c: np.asarray(imgs).mean(axis=(0, 1, 2))
            for c, imgs in images_by_class.items()}


def oracle_classify(images, sigs):
    """Nearest class-signature channel mean (L2)."""
    means = np.asarray(images).mean(axis=(1, 2))            # (N, 3)
    keys = sorted(sigs)
    d = np.stack([np.linalg.norm(means - sigs[c][None], axis=1)
                  for c in keys], axis=1)
    return np.array(keys)[np.argmin(d, axis=1)]


def ordered_pairs(classes) -> Iterator[Tuple[int, int]]:
    """Every (source, target) with source != target, in sorted order."""
    for s in sorted(classes):
        for t in sorted(classes):
            if t != s:
                yield s, t


def pair_latents(by_class, ndim: int, seed: int = 0
                 ) -> Dict[str, np.ndarray]:
    """One standard-normal draw of (n_source, ndim) per pair, in sorted
    pair order, from a ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return {f"{s}->{t}": torch.randn((len(by_class[s]), ndim),
                                     generator=gen).numpy()
            for s, t in ordered_pairs(by_class)}


def translate(G, images: np.ndarray, target: int, latent: np.ndarray,
              bf16: bool = False) -> np.ndarray:
    """G's fakes of ``images`` for class ``target`` with ``latent``, on
    G's device (bf16 autocast where the config computes in bf16)."""
    device = next(G.parameters()).device
    autocast = torch.autocast(device.type, dtype=torch.bfloat16) if bf16 \
        else contextlib.nullcontext()
    with autocast:
        fake, _ = gan.transform(
            G, torch.from_numpy(np.ascontiguousarray(images)).to(device),
            torch.full((len(images),), target),
            torch.from_numpy(np.array(latent, np.float32)).to(device))
    return fake.float().cpu().numpy()


def pair_accuracies(G, by_class, sigs, latents: Dict[str, np.ndarray],
                    bf16: bool = False):
    """The oracle's accuracy on G's fakes for every (source, target) pair
    (rounded to 3 places, as the JAX script does) and over all of them;
    ``latents`` maps each pair "s->t" to its (n_source, ndim) latents
    (``pair_latents``)."""
    pairs = {}
    total, hits = 0, 0
    for s, t in ordered_pairs(by_class):
        src = by_class[s]
        fake = translate(G, src, t, latents[f"{s}->{t}"], bf16)
        pred = oracle_classify(fake, sigs)
        acc = float((pred == t).mean())
        pairs[f"{s}->{t}"] = round(acc, 3)
        total += len(src)
        hits += int((pred == t).sum())
    return pairs, hits / total


def images_by_class(cfg, data_root: str, attr_file: str,
                    test_num: int) -> Dict[int, np.ndarray]:
    """The test split's images of each class, as the JAX script takes
    them."""
    test_ds = FaceDataset(data_root, attr_file=attr_file, data_type="test",
                          train_num=cfg.train.train_num, val_num=0,
                          test_num=test_num, image_size=cfg.model.image_size)
    return {c: np.stack([test_ds[i][0] for i in range(len(test_ds))
                         if test_ds.labels[i] == c])
            for c in range(cfg.model.n_classes)}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", choices=sorted(PRESETS),
                    help="fallback when the run has no config.json")
    ap.add_argument("--ckpt", required=True,
                    help="the run's ckpt directory (step_N checkpoints)")
    ap.add_argument("--ckpt-step", type=int)
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--attr-file", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--test-num", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "twins of the kernels)")
    args = ap.parse_args(argv)

    device = gan.resolve_device(args.device)
    weights = step_dir(args.ckpt, args.ckpt_step)
    cfg = load_config_for_ckpt(weights, args.preset)
    bf16 = cfg.train.compute_dtype == "bfloat16"
    by_class = images_by_class(cfg, args.data_root, args.attr_file,
                               args.test_num)
    sigs = class_means(by_class)

    # oracle sanity: it must be perfect on real images
    real_hits = real_total = 0
    for c, images in by_class.items():
        pred = oracle_classify(images, sigs)
        real_hits += int((pred == c).sum())
        real_total += len(pred)

    init_G = gan.build_generator(cfg, device,
                                 torch.Generator().manual_seed(0))
    G = gan.build_generator(cfg, device, state_dict=load_state_dict_file(
        os.path.join(weights, "generator.pth")))
    latents = pair_latents(by_class, cfg.model.ndim)
    init_pairs, init_acc = pair_accuracies(init_G, by_class, sigs, latents,
                                           bf16)
    trained_pairs, trained_acc = pair_accuracies(G, by_class, sigs, latents,
                                                 bf16)

    def perfect(pairs):
        return sum(v == 1.0 for v in pairs.values())

    summary = {
        "real_acc": real_hits / real_total,
        "init": {"acc": init_acc, "perfect_pairs": perfect(init_pairs),
                 "pairs": init_pairs},
        "trained": {"acc": trained_acc,
                    "perfect_pairs": perfect(trained_pairs),
                    "pairs": trained_pairs},
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)) or ".",
                exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
