"""The port's data feed (``srgan_tpu_torch/data``, ``ops/image.py``,
``utils/metrics.py``, the config record) against ``srgan_tpu`` on the CPU,
on the synthetic fixture at 10 images a class.

Tolerances: everything here is bit-equal to the JAX package (the same
numpy arithmetic on the same draws, the same PIL calls, the same C++
decoder built with the same flags), except the native decoder against the
PIL transform, which keeps ``tests/test_native.py``'s 0.04 (PIL's 8-bit
fixed-point filter against the decoder's float filter).
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)

import filecmp
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from srgan_tpu import configs as jconfigs
from srgan_tpu import native as jnative
from srgan_tpu.data import attributes as jattributes
from srgan_tpu.data import dataset as jdataset
from srgan_tpu.data import loader as jloader
from srgan_tpu.data import sampling as jsampling
from srgan_tpu.data import synthetic as jsynthetic
from srgan_tpu.ops import image as jimage
from srgan_tpu.utils import metrics as jmetrics
from srgan_tpu_torch import configs
from srgan_tpu_torch.data import (
    attributes,
    dataset,
    loader,
    native,
    sampling,
    synthetic,
)
from srgan_tpu_torch.ops import image
from srgan_tpu_torch.utils import metrics

PER_CLASS = 10
SPLIT = dict(train_num=6, val_num=2, test_num=2)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """The fixture written by each package, in both modes."""
    out = {}
    for mode in ("noise", "structured"):
        for name, mod in (("jax", jsynthetic), ("port", synthetic)):
            root = tmp_path_factory.mktemp(f"{name}_{mode}")
            out[name, mode] = mod.make_synthetic_celeba(
                str(root), n_per_class=PER_CLASS, mode=mode)
    return out


@pytest.fixture(scope="module")
def celeba(fixtures):
    return fixtures["port", "noise"]


def _pixels(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


# ---------------------------------------------------------------- image ops

def test_image_ops_bit_equal():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 9, 7, 3)).astype(np.float32)
    for kw in (dict(), dict(mean0=True), dict(axis=(1, 2, 3)),
               dict(axis=0, mean0=True)):
        want = jimage.min_max(x, **kw)
        np.testing.assert_array_equal(image.min_max(x, **kw), want)
        got_t = image.min_max(torch.from_numpy(x), **kw)
        np.testing.assert_allclose(got_t.numpy(), want, rtol=0, atol=1e-6)
    r, mn, mx = image.min_max(x, axis=1, get_param=True)
    jr, jmn, jmx = jimage.min_max(x, axis=1, get_param=True)
    for a, b in ((r, jr), (mn, jmn), (mx, jmx)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(image.minmax_transform(x[0]),
                                  jimage.minmax_transform(x[0]))
    np.testing.assert_array_equal(image.to_uint8_images(x),
                                  jimage.to_uint8_images(x))
    np.testing.assert_array_equal(image.to_uint8_images(x[0, ..., :1]),
                                  jimage.to_uint8_images(x[0, ..., :1]))
    np.testing.assert_array_equal(
        image.to_uint8_images(torch.from_numpy(x)), jimage.to_uint8_images(x))
    chw = np.transpose(x[1], (2, 0, 1))
    np.testing.assert_array_equal(np.asarray(image.to_pil(chw)),
                                  np.asarray(jimage.to_pil(chw)))
    np.testing.assert_array_equal(np.asarray(image.to_pil(x[2])),
                                  np.asarray(jimage.to_pil(x[2])))


# ---------------------------------------------------------------- sampling

def test_sampling_bit_equal():
    for n in (1, 2, 3):
        assert sampling.get_class_label(n) == jsampling.get_class_label(n)
    labels = np.random.default_rng(1).integers(0, 4, 37)
    np.testing.assert_array_equal(sampling.class_encode(labels, np.eye(4)),
                                  jsampling.class_encode(labels, np.eye(4)))
    for whole in (False, True):
        for shuffle in (False, True):
            got = sampling.get_target(labels, (0, 1, 2, 3), whole, shuffle,
                                      rng=np.random.default_rng(7))
            want = jsampling.get_target(labels, (0, 1, 2, 3), whole, shuffle,
                                        rng=np.random.default_rng(7))
            np.testing.assert_array_equal(got, want)
    items = [(np.full((2, 2, 3), i, np.float32), i % 4) for i in range(20)]
    np.testing.assert_array_equal(
        sampling.get_random_dataset(items, 6, random=False, random_seed=3),
        jsampling.get_random_dataset(items, 6, random=False, random_seed=3))


# ---------------------------------------------------------------- attributes

def test_attributes_parse_and_label_folders_interchange(tmp_path):
    attr = jsynthetic.make_scale_attr_file(str(tmp_path / "attr.txt"),
                                           n_rows=12_345, seed=2)
    info = attributes.parse_attr_file(attr)
    want = jattributes.parse_attr_file(attr)
    assert info.dtype == want.dtype and info.shape == (12_345, 41)
    np.testing.assert_array_equal(info, want)
    assert attributes.attr_names(attr) == jattributes.attr_names(attr)
    ours = attributes.build_label_folder(attr, str(tmp_path / "port"))
    theirs = jattributes.build_label_folder(attr, str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in ours] == \
        [os.path.basename(p) for p in theirs] == \
        ["000000_to_004999.pkl", "005000_to_009999.pkl",
         "010000_to_012344.pkl"]
    # a folder written by one package loads in the other, the same chunks
    for folder in ("port", "jax"):
        a = attributes.load_label_store(str(tmp_path / folder))
        b = jattributes.load_label_store(str(tmp_path / folder))
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(np.concatenate(a), want)


# ---------------------------------------------------------------- fixture

@pytest.mark.parametrize("mode", ["noise", "structured"])
def test_synthetic_fixture_matches(fixtures, mode):
    (img, attr), (jimg, jattr) = fixtures["port", mode], \
        fixtures["jax", mode]
    assert filecmp.cmp(attr, jattr, shallow=False)
    names = sorted(os.listdir(jimg))
    assert sorted(os.listdir(img)) == names and len(names) == 4 * PER_CLASS
    for name in names:
        np.testing.assert_array_equal(_pixels(os.path.join(img, name)),
                                      _pixels(os.path.join(jimg, name)))


def test_scale_attr_file_bytes(tmp_path):
    a = synthetic.make_scale_attr_file(str(tmp_path / "a.txt"), 3_000, 5)
    b = jsynthetic.make_scale_attr_file(str(tmp_path / "b.txt"), 3_000, 5)
    assert filecmp.cmp(a, b, shallow=False)


# ---------------------------------------------------------------- dataset

def test_face_dataset_splits_and_items(fixtures, tmp_path):
    """Each package on its own fixture: the same files, labels and items."""
    img_root, attr_file = fixtures["port", "noise"]
    jimg_root, jattr_file = fixtures["jax", "noise"]
    labels_dir = str(tmp_path / "labels")
    attributes.build_label_folder(attr_file, labels_dir)
    for source, jsource in ((dict(attr_file=attr_file),
                             dict(attr_file=jattr_file)),
                            (dict(label_root=labels_dir),
                             dict(label_root=labels_dir))):
        for split in ("train", "val", "test"):
            ds = dataset.FaceDataset(img_root, data_type=split, seed=3,
                                     **source, **SPLIT)
            jds = jdataset.FaceDataset(jimg_root, data_type=split, seed=3,
                                       **jsource, **SPLIT)
            assert [os.path.relpath(p, img_root) for p in ds.images] == \
                [os.path.relpath(p, jimg_root) for p in jds.images]
            assert ds.labels == jds.labels and len(ds) > 0
            # the PIL path, flips drawn from each dataset's own generator
            for i in range(len(ds)):
                im, lb = ds[i]
                jim, jlb = jds[i]
                assert im.dtype == np.float32 and lb == jlb
                np.testing.assert_array_equal(im, jim)
    assert dataset.DEFAULT_DATASET_LABEL == jdataset.DEFAULT_DATASET_LABEL
    assert dataset.LABEL_DESCRIPTION == jdataset.LABEL_DESCRIPTION


# ---------------------------------------------------------------- native

def test_native_decode_matches_jax_and_pil(celeba):
    assert native.available(), native.build_error()
    assert jnative.available(), jnative.build_error()
    img_root, attr_file = celeba
    ds = dataset.FaceDataset(img_root, attr_file=attr_file, **SPLIT)
    assert ds.flip
    paths = ds.images[:9]
    for i, flip in ((0, False), (4, True), (8, False)):
        got = native.load_image(paths[i], ds.crop, ds.image_size, flip)
        np.testing.assert_array_equal(
            got, jnative.load_image(paths[i], ds.crop, ds.image_size, flip))
        pil = ds.transform(ds.load_raw(i), flip=flip)
        assert np.abs(got - pil).max() < 0.04
    flips = np.arange(9) % 2
    got = native.load_batch(paths, ds.crop, 64, flips, num_threads=4)
    np.testing.assert_array_equal(
        got, jnative.load_batch(paths, ds.crop, 64, flips, num_threads=4))
    with pytest.raises(IOError):
        native.load_image("/nonexistent/nope.png", 178, 128, False)
    with pytest.raises(IOError):
        native.load_batch([paths[0], "/nonexistent/nope.png"], 178, 64)


def test_native_build_failure_raises_and_never_falls_back(celeba,
                                                           monkeypatch):
    img_root, attr_file = celeba
    ds = dataset.FaceDataset(img_root, attr_file=attr_file, **SPLIT)
    monkeypatch.setattr(native, "CXX", "/nonexistent/g++")
    assert not native.available()
    assert "/nonexistent/g++" in native.build_error()
    with pytest.raises(RuntimeError, match="nonexistent"):
        native.load_image(ds.images[0], 178, 64)
    with pytest.raises(RuntimeError, match="decode='pil'"):
        loader.DataLoader(ds, batch_size=4)
    with pytest.raises(ValueError, match="file-backed"):
        loader.DataLoader([ds[0]], batch_size=1, decode="native")
    with pytest.raises(ValueError, match="decode"):
        loader.DataLoader(ds, batch_size=4, decode="cv2")
    # PIL, when asked for by name
    assert len(loader.DataLoader(ds, batch_size=4, decode="pil")) == 6


# ---------------------------------------------------------------- loader

@pytest.mark.parametrize("decode,workers", [("native", 8), ("pil", 1)])
def test_loader_batches_bit_equal_to_jax(celeba, decode, workers):
    img_root, attr_file = celeba
    kw = dict(attr_file=attr_file, image_size=64, **SPLIT)
    ds = dataset.FaceDataset(img_root, **kw)
    jds = jdataset.FaceDataset(img_root, **kw)
    dl = loader.DataLoader(ds, batch_size=5, num_workers=workers, seed=11,
                           decode=decode)
    jdl = jloader.DataLoader(jds, batch_size=5, num_workers=workers, seed=11,
                             use_native=decode == "native")
    assert jdl.use_native == (decode == "native")
    assert len(dl) == len(jdl) == 4
    n = 0
    for _ in range(2):
        for b, jb in zip(dl, jdl, strict=True):
            assert set(b) == set(jb) == {"image", "source_label",
                                         "target_label"}
            for k in b:
                assert b[k].dtype == jb[k].dtype, k
                np.testing.assert_array_equal(b[k], jb[k], err_msg=k)
            assert (b["target_label"] != b["source_label"]).all()
            n += 1
    assert n == 8


def test_prefetch_to_device_cpu_yields_tensors_in_order(celeba):
    img_root, attr_file = celeba
    ds = dataset.FaceDataset(img_root, attr_file=attr_file, image_size=32,
                             **SPLIT)
    batches = list(loader.DataLoader(ds, batch_size=4, seed=1))
    for size in (1, 2, 9):
        got = list(loader.prefetch_to_device(iter(batches), "cpu", size))
        assert len(got) == len(batches)
        for b, host in zip(got, batches):
            assert b["image"].dtype == torch.float32
            assert b["image"].shape == (4, 32, 32, 3)
            for k in host:
                assert b[k].device.type == "cpu"
                np.testing.assert_array_equal(b[k].numpy(), host[k])
            assert b["source_label"].dtype == torch.int64
            assert b["target_label"].dtype == torch.int64
    with pytest.raises(ValueError):
        next(loader.prefetch_to_device(iter(batches), "cpu", 0))


# ---------------------------------------------------------------- records

def test_config_record_is_the_jax_one(tmp_path):
    for name in sorted(configs.PRESETS):
        cfg = configs.PRESETS[name]()
        ours = configs.save_config(cfg, str(tmp_path / "port" / name))
        theirs = jconfigs.save_config(jconfigs.PRESETS[name](),
                                      str(tmp_path / "jax" / name))
        assert filecmp.cmp(ours, theirs, shallow=False), name
        with open(theirs) as f:
            assert configs.config_from_dict(json.load(f)) == cfg
        assert configs.config_to_dict(cfg) == \
            jconfigs.config_to_dict(jconfigs.PRESETS[name]())
    a = configs.get_adjustable_parameters(1)
    assert a.equals(jconfigs.get_adjustable_parameters(1))
    assert configs.get_adjustable_parameters(3) is None


def test_metric_logger_record_and_pickles(tmp_path):
    vals = {"errD": torch.tensor(0.25), "errG": np.float32(1.5), "tag": "x"}
    ours = metrics.MetricLogger(str(tmp_path / "port.jsonl"))
    theirs = jmetrics.MetricLogger(str(tmp_path / "jax.jsonl"))
    for logger in (ours, theirs):
        logger.log(vals, epoch=0, step=3, images_per_sec=12.5, time=7.0)
        logger.close()
    assert filecmp.cmp(tmp_path / "port.jsonl", tmp_path / "jax.jsonl",
                       shallow=False)
    timer = metrics.StepTimer()
    timer.update(8)
    assert timer.images_per_sec > 0
    data = {"a": np.arange(3), "b": [1, "x"]}
    metrics.pickle_save(data, str(tmp_path / "d.pkl"))
    back = jmetrics.pickle_load(str(tmp_path / "d.pkl"))
    np.testing.assert_array_equal(back["a"], data["a"])
    assert metrics.pickle_load(str(tmp_path / "d.pkl"))["b"] == [1, "x"]
