"""Host batching and the device feed (counterpart of
``srgan_tpu/data/loader.py``).

The reference drives training with ``torch.utils.data.DataLoader(batch_size=
128, shuffle=True)`` and samples the target labels per batch on the host
(nb01 cell 22: ``get_target(...)[:, 0]``).  ``DataLoader`` here:

  - shuffles per epoch and assembles NHWC float32 batches, decoding with
    the native decoder (``decode="native"``) or item by item through the
    dataset in worker threads (``decode="pil"``), the choice the caller's;
  - folds the target sampling (``get_target``, column 0) in;
  - drops the last partial batch by default (the reference kept it; pass
    ``drop_last=False``).

Its batches are the JAX package's bits for the same seed.
``prefetch_to_device`` copies them to the device on a side stream ahead of
the step that reads them.

Data parallel (``mesh``, a ``parallel.Mesh``; counterpart of
``srgan_tpu/data/loader.py:92-121`` with a mesh): ``DataLoader(mesh=...)``
yields this rank's rows of every global batch (row-major, as
``shard_batch``) and decodes only those, while it draws the whole batch's
flips and targets so that each rank's rows are the single-process
loader's; ``prefetch_to_device(mesh=...)`` cuts global host batches to
this rank's rows before the copy.  Give the mesh to one of the two.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, Sequence

import numpy as np
import torch

from srgan_tpu_torch.data import native
from srgan_tpu_torch.data.sampling import get_target

DECODES = ("native", "pil")
# what the native decoder needs of a dataset: a file-backed FaceDataset
_FILE_BACKED = ("images", "labels", "crop", "image_size", "flip")


class DataLoader:
    """Batches of ``dataset`` as dicts of numpy arrays: ``image``
    (B, H, W, 3) float32, ``source_label`` (B,) int32 and, with
    ``sample_targets``, ``target_label`` (B,) int32.

    ``decode="native"`` decodes a whole batch in the C++ decoder on
    ``num_workers`` threads; the flips are drawn from the loader's own
    generator, then the targets, both on the calling thread.  It needs a
    file-backed ``FaceDataset`` and a decoder that builds, and raises
    otherwise.  ``decode="pil"`` takes ``dataset[i]`` for each item in
    ``num_workers`` threads (a ``FaceDataset`` decodes with PIL and draws
    each flip from its own generator, inside the worker; with flips on and
    more than one worker the order of those draws follows the threads, as
    in the JAX package).

    With a ``mesh``, the batches hold this rank's rows of each global batch
    of ``batch_size``, which the ranks must divide.  The flips of the whole
    global batch are drawn in order on the calling thread (``native``: the
    loader's generator, as one process does; ``pil``: the dataset's
    ``draw_flips``, as one process with one worker does), then the targets
    from all its labels, so every rank keeps the same generators."""

    def __init__(self, dataset, batch_size: int = 128, shuffle: bool = True,
                 drop_last: bool = True, classes: Sequence[int] = (0, 1, 2, 3),
                 sample_targets: bool = True, num_workers: int = 8,
                 seed: int = 0, decode: str = "native", mesh=None):
        if decode not in DECODES:
            raise ValueError(f"decode {decode!r}: one of {DECODES}")
        if mesh is not None:
            if batch_size % mesh.size:
                raise ValueError(f"batch {batch_size} does not split over "
                                 f"{mesh.size} ranks")
            if decode == "pil" and not hasattr(dataset, "draw_flips"):
                raise ValueError(
                    f"a sharded PIL decode needs a FaceDataset; "
                    f"{type(dataset).__name__} has no draw_flips")
        if decode == "native":
            missing = [a for a in _FILE_BACKED if not hasattr(dataset, a)]
            if missing:
                raise ValueError(
                    f"decode='native' needs a file-backed FaceDataset; "
                    f"{type(dataset).__name__} lacks {missing}: pass "
                    "decode='pil'")
            if not native.available():
                raise RuntimeError(
                    "decode='native': the native decoder is not available "
                    f"here ({native.build_error()}); pass decode='pil' to "
                    "decode with PIL")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.classes = classes
        self.sample_targets = sample_targets
        self.num_workers = num_workers
        self.decode = decode
        self.mesh = mesh
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def _images_native(self, idx, rows=slice(None)) -> np.ndarray:
        ds = self.dataset
        flips = (self._rng.random(len(idx)) < 0.5).astype(np.uint8) \
            if ds.flip else np.zeros(len(idx), np.uint8)
        paths = [ds.images[int(i)] for i in idx[rows]]
        return native.load_batch(paths, ds.crop, ds.image_size, flips[rows],
                                 self.num_workers)

    def _rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        if self.mesh is None:
            return slice(None)
        if n % self.mesh.size:
            raise ValueError(f"a global batch of {n} does not split over "
                             f"{self.mesh.size} ranks (drop_last=False "
                             "left a partial batch)")
        b = n // self.mesh.size
        return slice(self.mesh.rank * b, (self.mesh.rank + 1) * b)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        order = order[:len(self) * self.batch_size if self.drop_last else n]

        def fetch(i):
            return self.dataset[int(i)]

        def make_batch(pool, idx):
            rows = self._rows(len(idx))
            if self.decode == "native":
                images = self._images_native(idx, rows)
                labels = np.asarray([self.dataset.labels[int(i)]
                                     for i in idx], np.int32)
            elif self.mesh is not None:
                ds = self.dataset
                flips = ds.draw_flips(len(idx))[rows]
                images = np.stack(list(pool.map(
                    lambda i, f: ds.transform(ds.load_raw(int(i)), flip=f),
                    idx[rows], flips)))
                labels = np.asarray([ds.labels[int(i)] for i in idx],
                                    np.int32)
            else:
                items = list(pool.map(fetch, idx))
                images = np.stack([im for im, _ in items])
                labels = np.asarray([lb for _, lb in items], np.int32)
            batch = {"image": images, "source_label": labels[rows]}
            if self.sample_targets:
                tgt = get_target(labels, self.classes, whole=False,
                                 shuffle=True, rng=self._rng)
                batch["target_label"] = tgt[rows, 0].astype(np.int32)
            return batch

        with ThreadPoolExecutor(self.num_workers) as pool:
            for start in range(0, len(order), self.batch_size):
                yield make_batch(pool, order[start:start + self.batch_size])


def _as_tensor(key: str, value) -> torch.Tensor:
    """A host batch entry as a CPU tensor: labels int64, the rest float32."""
    if isinstance(value, torch.Tensor):
        t = value
    else:
        t = torch.from_numpy(np.ascontiguousarray(value))
    return t.long() if key.endswith("label") else t.float()


def prefetch_to_device(iterator: Iterable[Dict], device="cuda",
                       size: int = 2, mesh=None
                       ) -> Iterator[Dict[str, torch.Tensor]]:
    """The batches of ``iterator`` as dicts of tensors on ``device``
    (``image`` float32 NHWC, labels int64), copied ``size`` batches ahead;
    with a ``mesh``, only this rank's rows of each (global) batch.

    On a CUDA device each host batch is pinned and copied ``non_blocking``
    on a side stream, so the copy of batch N+1 overlaps the step on batch
    N.  The consuming stream waits on the copy's event before it is handed
    the batch, each tensor is recorded on that stream (the caching allocator
    does not give its memory to a later copy while the step may still read
    it), and the pinned host buffers are held until their copy has
    completed.  On the CPU the batches are only converted."""
    if size < 1:
        raise ValueError(f"size {size}: at least 1")
    if mesh is not None:
        from srgan_tpu_torch.parallel.mesh import shard_batch

        iterator = (shard_batch(b, mesh) for b in iterator)
    device = torch.device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield {k: _as_tensor(k, v) for k, v in batch.items()}
        return

    copy_stream = torch.cuda.Stream(device)

    def put(batch):
        host = {k: _as_tensor(k, v).pin_memory() for k, v in batch.items()}
        with torch.cuda.stream(copy_stream):
            out = {k: v.to(device, non_blocking=True)
                   for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, host, done

    queue = collections.deque()
    it = iter(iterator)
    for batch in it:
        queue.append(put(batch))
        if len(queue) == size:
            break
    while queue:
        out, host, done = queue.popleft()
        nxt = next(it, None)
        if nxt is not None:
            queue.append(put(nxt))
        stream = torch.cuda.current_stream(device)
        stream.wait_event(done)
        for t in out.values():
            t.record_stream(stream)
        yield out
        done.synchronize()     # the pinned buffers outlive their copy
        del host
