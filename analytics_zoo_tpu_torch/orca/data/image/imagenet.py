"""Streaming ImageNet-style input pipeline (counterpart of
``analytics_zoo_tpu/orca/data/image/imagenet.py``).

The host does the byte-level work (crop windows, flips, batch assembly)
over memory-mapped uint8 shards and ships uint8 batches; the float math
(cast, mean/std normalisation) runs inside the model on the device, so the
wire carries a quarter of the f32 bytes.

Disk format, as in the JAX package: a directory of paired shards
    shard-00000-images.npy   (N, H, W, 3) uint8
    shard-00000-labels.npy   (N,) int32
memory-mapped at iteration time, so an epoch never loads the dataset.

The batch stream is the JAX package's, bit for bit, for each seed: epoch
``e`` (the pipeline's ``_epoch_idx``, advanced once per planned epoch)
visits rows in ``native.shuffled_indices(n, seed + e)`` order (or in order
unshuffled) and draws each training batch's crop offsets and flips from
``RandomState(seed + e)``: ``ys``, then ``xs``, then ``flips``, batch after
batch; evaluation takes the center crop. The draws are made when a batch's
assembly task is planned, in batch order, and the task only copies, so the
infeed pump may run tasks in any order and deliver the same batches.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Callable, Iterator, Optional

import numpy as np

from ....common.context import resolve_device
from ....native import runtime
from ...learn.utils import Batch, DeviceFeed

# f32 channel stats in 0-255 scale (torchvision/reference constants)
IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


def write_synthetic_imagenet(data_dir: str, num_images: int,
                             image_size: int = 232, num_classes: int = 1000,
                             shard_size: int = 1024, seed: int = 0) -> str:
    """Write a seeded synthetic uint8 dataset in the shard format above
    (the same bytes for the same arguments as the JAX package's)."""
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    written = 0
    shard = 0
    while written < num_images:
        n = min(shard_size, num_images - written)
        imgs = rng.randint(0, 256, (n, image_size, image_size, 3), np.uint8)
        labels = rng.randint(0, num_classes, n).astype(np.int32)
        np.save(os.path.join(data_dir, f"shard-{shard:05d}-images.npy"), imgs)
        np.save(os.path.join(data_dir, f"shard-{shard:05d}-labels.npy"),
                labels)
        written += n
        shard += 1
    return data_dir


class ImageNetPipeline(DeviceFeed):
    """Streaming train/eval iterator over uint8 image shards.

    It has the ``BatchIterator`` contract (``epoch()``,
    ``steps_per_epoch``), so ``TPUEstimator.fit`` and ``evaluate`` take it
    directly. ``epoch(prefetch=True)`` runs the tasks through the infeed
    pump into the pinned staging ring and copies on a side stream;
    ``prefetch=False`` assembles and copies inline. Batches go to
    ``device``: the estimator's when it is fed through ``data_to_iterator``,
    else the card unless ``device="cpu"``. ``mesh`` is kept so callers of
    the JAX package read the same; with one device it is ignored.
    ``num_workers`` threads crop the images of one batch.
    """

    def __init__(self, data_dir: str, batch_size: int, mesh=None,
                 crop_size: int = 224, train: bool = True, seed: int = 0,
                 num_workers: int = 8, drop_remainder: bool = True,
                 device=None):
        super().__init__(None if device is None else resolve_device(device))
        self.data_dir = data_dir
        self.mesh = mesh
        self.crop = crop_size
        self.train = train
        self.seed = seed
        self.num_workers = num_workers
        names = sorted(f for f in os.listdir(data_dir)
                       if f.endswith("-images.npy"))
        if not names:
            raise FileNotFoundError(f"no image shards under {data_dir}")
        self._img_files = [os.path.join(data_dir, f) for f in names]
        self._label_files = [f.replace("-images.npy", "-labels.npy")
                             for f in self._img_files]
        self._shard_rows = [int(np.load(f, mmap_mode="r").shape[0])
                            for f in self._img_files]
        self.n = sum(self._shard_rows)
        self.local_bs = self.global_bs = max(int(batch_size), 1)
        self.steps_per_epoch = (self.n // self.local_bs if drop_remainder
                                else math.ceil(self.n / self.local_bs))
        if self.steps_per_epoch == 0:
            raise ValueError(f"{self.n} images < local batch {self.local_bs}")
        self._epoch_idx = 0
        self._pool: Optional[ThreadPoolExecutor] = None

    # --- host-side assembly --------------------------------------------------
    def _flat_index(self) -> np.ndarray:
        """(row -> (shard, offset)) table."""
        pairs = np.empty((self.n, 2), np.int64)
        row = 0
        for s, cnt in enumerate(self._shard_rows):
            pairs[row:row + cnt, 0] = s
            pairs[row:row + cnt, 1] = np.arange(cnt)
            row += cnt
        return pairs

    def _out(self, shape, dtype, tag: str, staged: bool):
        """A pinned staging slot (the pump's path on the card) or a fresh
        array, and the array to write."""
        pool = self._staging_pool() if staged else None
        if pool is None:
            a = np.empty(shape, dtype)
            return a, a
        slot = pool.acquire(shape, dtype, tag=tag)
        return slot, slot.array

    def _assemble(self, pool, mmaps, pairs, ys, xs, flips, labels,
                  staged: bool = False) -> Batch:
        """Copy a batch's crops (flipped where ``flips``) out of the
        memory-mapped shards on the crop threads ``pool``; the offsets were
        drawn when it was planned."""
        c = self.crop
        leaf, out = self._out((len(pairs), c, c, 3), np.uint8, "images",
                              staged)
        label_leaf, label_out = self._out(labels.shape, labels.dtype,
                                          "labels", staged)
        label_out[...] = labels

        def one(i):
            s, r = pairs[i]
            img = mmaps[s][r, ys[i]:ys[i] + c, xs[i]:xs[i] + c]
            out[i] = img[:, ::-1] if flips[i] else img

        list(pool.map(one, range(len(pairs)),
                      chunksize=max(len(pairs) // self.num_workers, 1)))
        return Batch(x=(leaf,), y=(label_leaf,), w=None)

    def _host_batch_tasks(self, shuffle: bool, staged: bool = False
                          ) -> Iterator[Callable[[], Batch]]:
        """Plan an epoch: the order, then per batch its crop offsets and
        flips, drawn in batch order; yields one assembly task per full
        batch (a ragged tail is never yielded, as in the JAX package). The
        crop threads start here, once an epoch, not in the tasks, which
        the pump runs on several threads at once."""
        if self._pool is None:
            self._pool = ThreadPoolExecutor(self.num_workers,
                                            thread_name_prefix="zoo-imagenet")
        mmaps = [np.load(f, mmap_mode="r") for f in self._img_files]
        labels = np.concatenate([np.load(f) for f in self._label_files])
        table = self._flat_index()
        rng = np.random.RandomState(self.seed + self._epoch_idx)
        if shuffle:
            order = runtime.shuffled_indices(
                self.n, seed=self.seed + self._epoch_idx)
        else:
            order = np.arange(self.n, dtype=np.int64)
        self._epoch_idx += 1
        c, bs = self.crop, self.local_bs
        h, w = mmaps[0].shape[1], mmaps[0].shape[2]
        for s in range(self.steps_per_epoch):
            idx = order[s * bs:(s + 1) * bs]
            if len(idx) < bs:
                break
            if self.train:
                ys = rng.randint(0, h - c + 1, bs)
                xs = rng.randint(0, w - c + 1, bs)
                flips = rng.rand(bs) < 0.5
            else:
                ys = np.full(bs, (h - c) // 2)
                xs = np.full(bs, (w - c) // 2)
                flips = np.zeros(bs, bool)
            yield partial(self._assemble, self._pool, mmaps, table[idx], ys,
                          xs, flips, labels[idx], staged)

    def _host_batches(self, shuffle: bool) -> Iterator[Batch]:
        """Assembled host batches, inline (numpy leaves)."""
        for task in self._host_batch_tasks(shuffle):
            yield task()

    # --- device side ---------------------------------------------------------
    def epoch(self, shuffle: Optional[bool] = None,
              prefetch: bool = True) -> Iterator[Batch]:
        """One epoch's batches on the device (shuffled when training,
        unless ``shuffle`` says otherwise)."""
        shuffle = self.train if shuffle is None else shuffle
        if self.device is None:
            self.device = resolve_device(None)
        return self._device_epoch(shuffle, prefetch)

    def close(self):
        """Stop the crop threads (a later epoch starts them again)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

