"""CelebA face dataset with the reference's filtering and split semantics
(counterpart of ``srgan_tpu/data/dataset.py``; reference dataset.py:20-141).

  - filtering spec ``dataset_label = {"existed": [...], "delete": [...],
    "class": [...]}`` with 1-based attribute columns (column 0 = filename);
    the notebook spec requires attr 25 (No_Beard), deletes rows with any of
    [1,11,14,15,16,17,23,31,36] set, classes on [21, 32] (Male x Smiling)
  - per class: collect matching paths per label chunk, sort, then
    train = [:min(train_num, N-val-test)], val = next val_num, test = last
    test_num (the exact slicing of reference dataset.py:110-117)
  - items assembled class-major with paths sorted

Transforms (nb01 cell 9): CenterCrop(178) -> Resize(128) bilinear ->
RandomHorizontalFlip(0.5, train only) -> per-image min-max to [-1, 1]
(the ``MinMax`` transform, util.py:148-155, not a fixed mean/std).  Items
are NHWC float32 numpy arrays, as in the JAX package; the device feed
(``data/loader.py``) makes tensors of them.  PIL is imported where an image
is opened or transformed, never when the module is imported.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from srgan_tpu_torch.data.attributes import load_label_store, parse_attr_file
from srgan_tpu_torch.data.sampling import get_class_label
from srgan_tpu_torch.ops.image import minmax_transform

# nb01 cell 6: No_Beard required; beard/blurry/hat/glasses/etc. excluded;
# class attrs Male(21) x Smiling(32).  1-based into the 41-column label rows.
DEFAULT_DATASET_LABEL: Dict[str, List[int]] = {
    "existed": [25],
    "delete": [1, 11, 14, 15, 16, 17, 23, 31, 36],
    "class": [21, 32],
}

LABEL_DESCRIPTION = {
    0: "male-smiling", 1: "male-non-smiling",
    2: "female-smiling", 3: "female-non-smiling",
}


class FaceDataset:
    def __init__(self, root: str, label_root: Optional[str] = None,
                 attr_file: Optional[str] = None,
                 dataset_label: Dict[str, List[int]] = None,
                 classes: Sequence[int] = (0, 1, 2, 3),
                 data_type: str = "train",
                 train_num: int = 2000, val_num: int = 500,
                 test_num: int = 500,
                 image_size: int = 128, crop: int = 178,
                 flip: Optional[bool] = None,
                 image_ext: str = ".png",
                 seed: int = 0):
        dataset_label = dataset_label or DEFAULT_DATASET_LABEL
        self.image_size = image_size
        self.crop = crop
        self.flip = (data_type == "train") if flip is None else flip
        self._rng = np.random.default_rng(seed)

        if label_root is not None:
            chunks = load_label_store(label_root)
        elif attr_file is not None:
            chunks = [parse_attr_file(attr_file)]
        else:
            raise ValueError("need label_root or attr_file")

        cl = get_class_label(len(dataset_label["class"]))

        def make_path(name: str) -> str:
            stem = name.split(".")[0]
            return os.path.join(root, stem + image_ext)

        self.images: List[str] = []
        self.labels: List[int] = []
        images_dir: Dict[int, List[str]] = {}
        for i in range(len(classes)):
            images_dir[i] = []
            for info in chunks:
                if len(dataset_label["delete"]) == 0:
                    idx_del = np.ones(info.shape[0], bool)
                else:
                    idx_del = np.sum(
                        1 - (info[:, np.asarray(dataset_label["delete"])]
                             == "-1").astype(int), axis=1) == 0
                if len(dataset_label["existed"]) == 0:
                    idx_exist = np.ones(info.shape[0], bool)
                else:
                    idx_exist = np.sum(
                        1 - (info[:, np.asarray(dataset_label["existed"])]
                             == "1").astype(int), axis=1) == 0
                info_con = info[idx_del & idx_exist]
                mask = np.ones(info_con.shape[0], bool)
                for j, col in enumerate(dataset_label["class"]):
                    mask &= info_con[:, col] == str(cl[i][j])
                paths = sorted(make_path(n) for n in info_con[mask, 0])
                images_dir[i] += paths
            images_dir[i].sort()
            new_train_num = min(train_num,
                                len(images_dir[i]) - val_num - test_num)
            if data_type == "train":
                images_dir[i] = images_dir[i][:new_train_num]
            elif data_type == "val":
                images_dir[i] = images_dir[i][new_train_num:
                                              new_train_num + val_num]
            elif data_type == "test":
                images_dir[i] = images_dir[i][-test_num:]
            for path in images_dir[i]:
                self.images.append(path)
                self.labels.append(i)

    def __len__(self) -> int:
        return len(self.images)

    def load_raw(self, index: int):
        """The image file of item ``index`` as an RGB PIL image."""
        from PIL import Image

        with open(self.images[index], "rb") as f:
            return Image.open(f).convert("RGB")

    def transform(self, img, flip: Optional[bool] = None) -> np.ndarray:
        """Crop, resize, flip (where the dataset flips: from the dataset's
        own generator unless ``flip`` is given) and min-max a PIL image."""
        from PIL import Image

        w, h = img.size
        c = self.crop
        # torchvision CenterCrop semantics (round half toward the top-left)
        left = int(round((w - c) / 2.0))
        top = int(round((h - c) / 2.0))
        img = img.crop((left, top, left + c, top + c))
        img = img.resize((self.image_size, self.image_size), Image.BILINEAR)
        do_flip = (self._rng.random() < 0.5) if flip is None else flip
        if self.flip and do_flip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        arr = np.asarray(img, np.float32) / 255.0       # HWC [0,1]
        return minmax_transform(arr, mean0=True)        # per-image [-1,1]

    def draw_flips(self, n: int) -> np.ndarray:
        """The next ``n`` flip coins of the dataset's own generator, as ``n``
        calls of ``transform`` without ``flip`` would draw them."""
        return self._rng.random(n) < 0.5

    def __getitem__(self, index: int):
        return self.transform(self.load_raw(index)), self.labels[index]
