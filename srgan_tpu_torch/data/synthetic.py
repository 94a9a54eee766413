"""Synthetic CelebA-like fixture: images and an attribute file (counterpart
of ``srgan_tpu/data/synthetic.py``; the same draws, so the same pixels and
the same attribute-file bytes).

It stands in for the CelebA download (notebook A cell 2) in tests, smoke
runs and measurements: 178x218 PNGs whose colour depends on the class
attributes, so that a classifier has signal, and a ``list_attr_celeba.txt``
with CelebA's 40-attribute header.  PIL is imported where the PNGs are
written, never when the module is imported.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

CELEBA_ATTRS = [
    "5_o_Clock_Shadow", "Arched_Eyebrows", "Attractive", "Bags_Under_Eyes",
    "Bald", "Bangs", "Big_Lips", "Big_Nose", "Black_Hair", "Blond_Hair",
    "Blurry", "Brown_Hair", "Bushy_Eyebrows", "Chubby", "Double_Chin",
    "Eyeglasses", "Goatee", "Gray_Hair", "Heavy_Makeup", "High_Cheekbones",
    "Male", "Mouth_Slightly_Open", "Mustache", "Narrow_Eyes", "No_Beard",
    "Oval_Face", "Pale_Skin", "Pointy_Nose", "Receding_Hairline",
    "Rosy_Cheeks", "Sideburns", "Smiling", "Straight_Hair", "Wavy_Hair",
    "Wearing_Earrings", "Wearing_Hat", "Wearing_Lipstick",
    "Wearing_Necklace", "Wearing_Necktie", "Young",
]
# 1-based column indices (col 0 = filename): Male=21, Smiling=32, No_Beard=25
MALE_COL, SMILING_COL, NO_BEARD_COL = 21, 32, 25


def _smooth_field(rng: np.random.Generator, h: int, w: int,
                  coarse: Tuple[int, int] = (5, 4),
                  sigma: float = 1.0) -> np.ndarray:
    """Low-frequency random field: N(0, sigma) on a coarse grid, bilinearly
    upsampled to (h, w, 3).  Pure numpy (no scipy dependency)."""
    ch, cw = coarse
    grid = rng.normal(0, sigma, (ch, cw, 3)).astype(np.float32)
    ys = np.linspace(0, ch - 1, h)
    xs = np.linspace(0, cw - 1, w)
    y0 = np.clip(ys.astype(np.int64), 0, ch - 2)
    x0 = np.clip(xs.astype(np.int64), 0, cw - 2)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    g00 = grid[y0][:, x0]
    g01 = grid[y0][:, x0 + 1]
    g10 = grid[y0 + 1][:, x0]
    g11 = grid[y0 + 1][:, x0 + 1]
    return ((1 - wy) * ((1 - wx) * g00 + wx * g01)
            + wy * ((1 - wx) * g10 + wx * g11))


# Approximate real-CelebA marginal frequencies (fraction of rows with +1)
# for every attribute the notebook filter touches (nb01 cell 6; quoted from
# the dataset's published attribute statistics).  Used by
# make_scale_attr_file so a synthetic 202,599-row file yields realistic
# filter survivor counts (~50% keep rate, >=20k per Male x Smiling class).
CELEBA_MARGINALS = {
    "5_o_Clock_Shadow": 0.111, "Blurry": 0.051, "Chubby": 0.058,
    "Double_Chin": 0.047, "Eyeglasses": 0.065, "Goatee": 0.063,
    "Male": 0.417, "Mustache": 0.042, "No_Beard": 0.835,
    "Sideburns": 0.057, "Smiling": 0.482, "Wearing_Hat": 0.049,
    "Young": 0.779,
}


def make_scale_attr_file(path: str, n_rows: int = 202_599,
                         seed: int = 0) -> str:
    """Write a full-scale synthetic ``list_attr_celeba.txt`` (no pixels).

    Mirrors the real file's shape exactly — count line, 40-name header,
    ``NNNNNN.jpg`` rows of +-1 — with attributes drawn i.i.d. from
    CELEBA_MARGINALS (0.5 for attrs the filter never reads).  Lets the
    ingest path (notebook A cell 5 + reference dataset.py:20-141) be
    exercised at the real 202,599-row scale without 2 GB of images.
    """
    rng = np.random.default_rng(seed)
    cols = [(rng.random(n_rows) <
             CELEBA_MARGINALS.get(a, 0.5)).astype(np.int8) * 2 - 1
            for a in CELEBA_ATTRS]
    mat = np.stack(cols, axis=1)          # (N, 40) of +-1
    names = [f"{i + 1:06d}.jpg" for i in range(n_rows)]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(f"{n_rows}\n")
        f.write(" ".join(CELEBA_ATTRS) + "\n")
        body = "\n".join(
            n + " " + " ".join("1" if v > 0 else "-1" for v in row)
            for n, row in zip(names, mat))
        f.write(body + "\n")
    return path


def make_synthetic_celeba(out_dir: str, n_per_class: int = 10,
                          size: Tuple[int, int] = (178, 218),
                          seed: int = 0,
                          noise_sigma: float = 40.0,
                          smiling_boost: float = 0.0,
                          mode: str = "noise") -> Tuple[str, str]:
    """Returns (image_root, attr_file_path).  Classes cycle through
    (male, smiling) in the reference's class order [( 1,1),(1,-1),(-1,1),
    (-1,-1)].  ``noise_sigma`` sets the per-pixel noise around the
    class-signature mean color (lower = stronger class signal).
    ``smiling_boost`` > 0 strengthens the Smiling axis: +boost on the G
    shift and a -boost/2 B shift, making it a 2-channel signature like the
    Male axis (0 = the plain fixture).

    ``mode`` selects the intra-class variation texture:

      - ``"noise"`` (default): i.i.d. per-pixel Gaussian noise.
        Learnable class signal, but PRDC over VGG features is degenerate on
        it — features are dominated by noise *texture*, which a generator
        cannot and should not reproduce.
      - ``"structured"``: smooth low-frequency content — a random
        coarse-grid bilinear field, a random soft radial blob, and a random
        linear shading gradient — whose class signal (the mean color) and
        style variation both survive VGG feature extraction, making PRDC
        informative: translated fakes can genuinely land on (or miss) the
        real target-class feature manifold.
    """
    from PIL import Image

    rng = np.random.default_rng(seed)
    img_dir = os.path.join(out_dir, "img")
    os.makedirs(img_dir, exist_ok=True)
    w, h = size
    class_sigs = [(1, 1), (1, -1), (-1, 1), (-1, -1)]
    rows = []
    idx = 0
    for cls, (male, smiling) in enumerate(class_sigs):
        for _ in range(n_per_class):
            idx += 1
            name = f"{idx:06d}.jpg"
            # class-dependent mean color + noise => learnable signal
            base = np.array(
                [60 + 60 * (male > 0),
                 80 + (60 + smiling_boost) * (smiling > 0),
                 120 - (smiling_boost / 2) * (smiling > 0)], np.float32)
            if mode == "structured":
                # class-independent smooth "style": low-frequency field
                # + soft radial blob + linear shading.  Amplitudes kept
                # below the class color separation (60) so the class
                # signal stays dominant in feature space.
                field = _smooth_field(rng, h, w, sigma=18.0)
                cy, cx = rng.uniform(0.25, 0.75) * h, rng.uniform(0.25, 0.75) * w
                sig = rng.uniform(25.0, 55.0)
                amp = rng.uniform(20.0, 45.0) * rng.choice([-1.0, 1.0])
                yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
                blob = amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                    / (2 * sig ** 2))
                gdir = rng.uniform(0, 2 * np.pi)
                gamp = rng.uniform(0.0, 15.0)
                grad = gamp * ((yy / h - 0.5) * np.sin(gdir)
                               + (xx / w - 0.5) * np.cos(gdir))
                arr = np.clip(base + field + (blob + grad)[:, :, None],
                              0, 255).astype(np.uint8)
            else:
                arr = np.clip(
                    base + rng.normal(0, noise_sigma, (h, w, 3)),
                    0, 255).astype(np.uint8)
            Image.fromarray(arr).save(
                os.path.join(img_dir, name.replace(".jpg", ".png")))
            attrs = {a: -1 for a in CELEBA_ATTRS}
            attrs["Male"] = male
            attrs["Smiling"] = smiling
            attrs["No_Beard"] = 1      # required by the "existed" filter
            attrs["Young"] = int(rng.choice([-1, 1]))
            rows.append((name, [attrs[a] for a in CELEBA_ATTRS]))

    attr_path = os.path.join(out_dir, "list_attr_celeba.txt")
    with open(attr_path, "w") as f:
        f.write(f"{len(rows)}\n")
        f.write(" ".join(CELEBA_ATTRS) + "\n")
        for name, vals in rows:
            f.write(name + " " + " ".join(f"{v:d}" for v in vals) + "\n")
    return img_dir, attr_path
