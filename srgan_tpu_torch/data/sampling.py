"""Label helpers: class enumeration, one-hot encoding, target sampling
(counterpart of ``srgan_tpu/data/sampling.py``).

  - get_class_label   reference dataset.py:11-18
  - class_encode      reference util.py:205-234
  - get_target        reference util.py:268-319

Every draw comes from the ``np.random.Generator`` passed in, in the JAX
package's order, so the loader's batches are the same bits on both sides.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence

import numpy as np


def get_class_label(n_class_type: int):
    """Every +-1 combination of the class attributes, sorted descending:
    [(1, 1), (1, -1), (-1, 1), (-1, -1)] for two attributes (male-smiling,
    male-not, female-smiling, female-not)."""
    combos = set()
    for com in itertools.combinations_with_replacement([-1, 1], n_class_type):
        for per in itertools.permutations(com):
            combos.add(per)
    return sorted(combos, reverse=True)


def class_encode(labels, ref_class: np.ndarray) -> np.ndarray:
    """Rows of the reference label matrix (one-hot by default):
    (B,) int -> (B, dim) float32."""
    labels = np.asarray(labels)
    return np.asarray(ref_class, np.float32)[labels].reshape(
        -1, np.asarray(ref_class).shape[1])


def get_target(labels, classes: Sequence[int], whole: bool = False,
               shuffle: bool = True,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """The possible target labels of each sample: every class but the
    source (``whole=False``; training takes column 0, nb01 cell 22) or every
    class (``whole=True``), each row shuffled on its own."""
    labels = np.asarray(labels)
    n = len(classes)
    target = np.tile(np.arange(n), (labels.shape[0], 1))
    if not whole:
        keep = ~np.eye(n, dtype=bool)[labels]
        target = target[keep].reshape(-1, n - 1)
    if shuffle:
        rng = rng or np.random.default_rng()
        # one independent shuffle per row (the reference's row loop)
        perm = np.argsort(rng.random(target.shape), axis=1)
        target = np.take_along_axis(target, perm, axis=1)
    return target


def get_random_dataset(dataset, num: int, random: bool = True,
                       random_seed: int = 0) -> np.ndarray:
    """``num`` transformed images of ``dataset`` at indices drawn without
    replacement, stacked (util.py:321-334, reading the drawn indices, not
    items 0..num-1 as the reference does)."""
    rng = np.random.default_rng(None if random else random_seed)
    index = rng.choice(np.arange(len(dataset)), num, replace=False)
    return np.stack([dataset[int(i)][0] for i in index])
