"""Render training loss curves from a run's metrics.jsonl with the port
(counterpart of ``scripts/plot_losses.py``): the reference's loss panel
(nb01 cell 22: Discriminator / Generator / Encoder) and, where the log has
them, the loss_* components.  Needs matplotlib.

  python -m srgan_tpu_torch.plot_losses --metrics runs/srgan/metrics.jsonl \\
      --out runs/srgan/losses.png
"""

from __future__ import annotations

import argparse

from srgan_tpu_torch.utils import viz


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--metrics", required=True,
                    help="metrics.jsonl written by a training run")
    ap.add_argument("--out", required=True, help="output PNG path")
    ap.add_argument("--x-key", default="step",
                    help="x axis field (default: step)")
    ap.add_argument("--keys", nargs="+", default=["errD", "errG", "errE"],
                    help="model-loss fields for the left panel")
    args = ap.parse_args(argv)

    viz.require_matplotlib("plot_losses")
    fig = viz.plot_loss_curves(args.metrics, model_keys=tuple(args.keys),
                               x_key=args.x_key, save_path=args.out)
    viz.close(fig)
    print(f"loss curves -> {args.out}")


if __name__ == "__main__":
    main()
