"""Generate a synthetic CelebA fixture with a recorded recipe (counterpart
of ``scripts/make_fixture.py``; the same recipes, so the same PNGs, the
same ``list_attr_celeba.txt`` and the same ``fixture.json``).

Writes the images, ``list_attr_celeba.txt`` and a ``fixture.json`` that
records every generation parameter.  Named recipes:

  structured   structured low-frequency content, 300 a class, boost 40
  boost        noise mode, sigma 15, 116 a class, boost 40
  strong       noise mode, sigma 15, 200 a class

Run:

    python -m srgan_tpu_torch.make_fixture --recipe boost --out DIR
"""

from __future__ import annotations

import argparse
import json
import os

from srgan_tpu_torch.data import make_synthetic_celeba

RECIPES = {
    "structured": dict(n_per_class=300, seed=0, smiling_boost=40.0,
                       mode="structured"),
    "boost": dict(n_per_class=116, seed=0, noise_sigma=15.0,
                  smiling_boost=40.0, mode="noise"),
    "strong": dict(n_per_class=200, seed=0, noise_sigma=15.0, mode="noise"),
}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True, help="fixture directory")
    ap.add_argument("--recipe", choices=sorted(RECIPES), default=None)
    ap.add_argument("--n-per-class", type=int)
    ap.add_argument("--seed", type=int)
    ap.add_argument("--noise-sigma", type=float)
    ap.add_argument("--smiling-boost", type=float)
    ap.add_argument("--mode", choices=["noise", "structured"])
    args = ap.parse_args(argv)

    params = dict(RECIPES[args.recipe]) if args.recipe else {}
    for k, v in (("n_per_class", args.n_per_class), ("seed", args.seed),
                 ("noise_sigma", args.noise_sigma),
                 ("smiling_boost", args.smiling_boost), ("mode", args.mode)):
        if v is not None:
            params[k] = v

    img_root, attr_file = make_synthetic_celeba(args.out, **params)
    with open(os.path.join(args.out, "fixture.json"), "w") as f:
        json.dump({"recipe": args.recipe, "params": params}, f, indent=1)
    print(f"{img_root}\n{attr_file}")
    return img_root, attr_file


if __name__ == "__main__":
    main()
