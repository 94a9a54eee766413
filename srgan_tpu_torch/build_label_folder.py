"""Build the CelebA label folder (counterpart of
``scripts/build_label_folder.py``; reference notebook A cell 5).

Parses ``list_attr_celeba.txt`` into the 5,000-row chunked pickle layout
the reference's FaceDataset reads (``FaceDataset(label_root=...)``; it
also reads the attribute file itself through ``attr_file=``).  Run:

    python -m srgan_tpu_torch.build_label_folder --attr-file FILE --out DIR
"""

from __future__ import annotations

import argparse

from srgan_tpu_torch.data import build_label_folder


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--attr-file", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    paths = build_label_folder(args.attr_file, args.out)
    print(f"wrote {len(paths)} chunks -> {args.out}")
    return paths


if __name__ == "__main__":
    main()
