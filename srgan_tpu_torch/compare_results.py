"""Aggregate PRDC result pickles into comparison tables (counterpart of
``scripts/compare_results.py``; notebook 06).

Given one pickle per model (``python -m srgan_tpu_torch.evaluate_prdc``
writes them), prints:

  - per-model (metric) means for a chosen (source, target) pair
  - the source x target matrix of the first model for the first metric
  - the all-pairs model x metric mean table

with the numbers rounded to 4 places, as the JAX script's pandas tables
show them; --json-out writes the JAX script's JSON.  It needs numpy only:
no pandas.  Run:

    python -m srgan_tpu_torch.compare_results A.pkl B.pkl --names a b \\
        [--json-out runs/tables.json]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
from typing import Sequence

import numpy as np

METRICS = ("precision", "recall", "density", "coverage")


def format_table(rows, index: Sequence, columns: Sequence,
                 decimals: int = 4) -> str:
    """A table of ``rows`` (one list of floats per index entry), each value
    rounded to ``decimals`` places, the columns right-aligned under their
    names."""
    cells = [[f"{round(float(v), decimals):.{decimals}f}" for v in row]
             for row in rows]
    index = [str(i) for i in index]
    columns = [str(c) for c in columns]
    iw = max([len(i) for i in index] + [0])
    widths = [max([len(c)] + [len(r[j]) for r in cells])
              for j, c in enumerate(columns)]
    lines = [" " * iw + "".join(f"  {c:>{w}}"
                                for c, w in zip(columns, widths))]
    for i, row in zip(index, cells):
        lines.append(f"{i:<{iw}}" + "".join(f"  {v:>{w}}"
                                            for v, w in zip(row, widths)))
    return "\n".join(lines)


def report(results, names, classes) -> dict:
    """The --json-out structure: each model's every extractor and metric as
    a source x target matrix of means with its two averages."""
    out = {}
    for name, r in zip(names, results):
        out[name] = {}
        for fe_name in r:
            fes = {}
            for metric in METRICS:
                mat = [[float(np.mean(r[fe_name][s][t][metric]))
                        for t in classes] for s in classes]
                off_diag = [mat[s][t] for s in range(len(classes))
                            for t in range(len(classes)) if s != t]
                fes[metric] = {
                    "source_x_target": mat,
                    "mean_all_pairs": float(np.mean(
                        [v for row in mat for v in row])),
                    "mean_translation_pairs": float(np.mean(off_diag)),
                }
            out[name][fe_name] = fes
    return {"classes": classes, "models": out}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("pickles", nargs="+",
                    help="result pickles from evaluate_prdc")
    ap.add_argument("--names", nargs="+", help="model names (default: paths)")
    ap.add_argument("--fe", default=None,
                    help="feature extractor (default: first in each pickle)")
    ap.add_argument("--source", type=int, default=3)
    ap.add_argument("--target", type=int, default=2)
    ap.add_argument("--json-out",
                    help="also write the full (model x fe x metric) "
                         "source x target tables as a JSON file")
    args = ap.parse_args(argv)

    names = args.names or args.pickles
    results = []
    for path in args.pickles:
        with open(path, "rb") as f:
            results.append(pickle.load(f))

    fe = args.fe or next(iter(results[0]))
    classes = sorted(results[0][fe])

    # nb06 cell 12: per-model metric means at one (source, target) pair
    rows = [[np.mean(r[fe][args.source][args.target][m]) for m in METRICS]
            for r in results]
    print(f"\n{fe}  s={args.source} t={args.target}:")
    print(format_table(rows, names, METRICS))

    # nb06 cell 10: source x target matrix of the first model, first metric
    metric = METRICS[0]
    mat = [[np.mean(results[0][fe][s][t][metric]) for t in classes]
           for s in classes]
    print(f"\n{names[0]} / {fe} / {metric} (source x target):")
    print(format_table(mat, classes, classes))

    # nb06 cell 14: mean over all (source, target) pairs, model x metric
    rows = [[np.mean([np.mean(r[fe][s][t][m])
                      for s in classes for t in classes]) for m in METRICS]
            for r in results]
    print(f"\nall-pairs mean / {fe}:")
    print(format_table(rows, names, METRICS))

    if args.json_out:
        tables = report(results, names, classes)
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)) or ".",
                    exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(tables, f, indent=1)
        print(f"\nJSON tables -> {args.json_out}")
        return tables
    return None


if __name__ == "__main__":
    main()
