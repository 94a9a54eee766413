"""CelebA attribute file and the label-folder store (counterpart of
``srgan_tpu/data/attributes.py``).

``list_attr_celeba.txt`` (a count line, 40 attribute names, then a filename
and 40 "+-1" values per row) is parsed into (N, 41) ``<U15`` string arrays
and pickled in 5,000-row chunks as ``label_folder/000000_to_004999.pkl``
(notebook A cell 5), the layout whose 1-based columns ``dataset_label``
indexes (column 0 is the filename).  The pickles are the JAX package's.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import List

import numpy as np

CHUNK = 5000


def parse_attr_file(attr_path: str) -> np.ndarray:
    """list_attr_celeba.txt -> (N, 41) <U15 array: [filename, 40 x "+-1"].
    Rows that do not hold 41 fields are skipped."""
    with open(attr_path) as f:
        lines = f.read().splitlines()
    rows = [parts for parts in (line.split() for line in lines[2:])
            if len(parts) == 41]
    return np.asarray(rows, dtype="<U15")


def attr_names(attr_path: str) -> List[str]:
    with open(attr_path) as f:
        f.readline()
        return f.readline().split()


def build_label_folder(attr_path: str, out_dir: str) -> List[str]:
    """Write the chunked pickles of ``attr_path`` into ``out_dir``; returns
    their paths."""
    os.makedirs(out_dir, exist_ok=True)
    info = parse_attr_file(attr_path)
    paths = []
    for start in range(0, len(info), CHUNK):
        end = min(start + CHUNK, len(info)) - 1
        path = os.path.join(out_dir, f"{start:06d}_to_{end:06d}.pkl")
        with open(path, "wb") as f:
            pickle.dump(info[start:start + CHUNK], f)
        paths.append(path)
    return paths


def load_label_store(label_root: str) -> List[np.ndarray]:
    """Every chunk pickle under ``label_root``, in name order (the
    FaceDataset glob, reference dataset.py:89).  Unpickles: read only a
    folder this package or the JAX package wrote."""
    chunks = []
    for path in sorted(glob.glob(os.path.join(label_root, "*"))):
        with open(path, "rb") as f:
            chunks.append(np.asarray(pickle.load(f)))
    return chunks
