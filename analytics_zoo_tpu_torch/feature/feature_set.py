"""FeatureSet cache tiers: training epochs bigger than RAM (counterpart of
``analytics_zoo_tpu/feature/feature_set.py``; the reference's FeatureSet
hierarchy, FeatureSet.scala:556-647, DRAM and DISK_n tiers).

* ``FeatureSet.from_arrays(..., tier="dram")`` is the in-memory
  ``BatchIterator`` path (``orca/learn/utils.py``), shuffled.
* ``tier="disk"``, ``from_xshards`` and ``from_tfrecords`` spool the
  columns once into npy shards under a cache dir (the same files, byte for
  byte, as the JAX package's: either package reads the other's cache).
  Each epoch then streams full batches out of the memory-mapped shards
  with block shuffling: the shard order, then the rows within each shard.

:class:`DiskFeatureSet` is a ``DeviceFeed``: its batches reach the card
through the port's infeed pump, pinned staging ring and side-stream
copies, and its ``stats`` are the estimator's ``data_pipeline_stats()``
when ``fit`` takes it. The JAX stream is one sequential generator with
carry buffers across shard boundaries; here the epoch is planned up front
from the same ``RandomState(seed + epoch)`` draws, and each batch's task
gathers exactly the (shard, rows) pieces that the JAX stream would emit in
that batch, so the two streams are the same for each seed.

There is no mesh: the stream is process ``_pid`` of ``_nproc`` (0 of 1
unless given; the multi-process striping modes are kept for the tests and
for ROADMAP A10), and a ``mesh`` raises, naming A10.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from functools import partial
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..common.context import resolve_device
from ..native import transfer as xfer
from ..orca.data.shard import HostXShards
from ..orca.learn.utils import Batch, DeviceFeed, _as_tuple

_NO_MESH = ("a FeatureSet over a device mesh is not ported yet: it needs "
            "the port's process groups (ROADMAP A10)")


class DiskFeatureSet(DeviceFeed):
    """Disk-backed column store with the ``BatchIterator`` contract
    (``epoch()``, ``steps_per_epoch``, ``_host_batches``) that
    ``TPUEstimator.fit`` and ``evaluate`` take.

    Two striping modes over processes (``stripe``), as in the JAX
    package:

    * ``"row"`` (default): process p takes global rows p, p + nproc, ...;
      every process touches every shard file.
    * ``"shard"``: whole shard files go to processes, balanced on row
      counts (greedy longest-first, the same on every process), so each
      opens only its own stripe; every process emits the smallest
      stripe's batch count.

    Every batch is full (``w=None``); the tail rows are dropped.
    """

    supports_fused = False      # fit runs unfused, as in the JAX package

    def __init__(self, cache_dir: str, mesh, batch_size: int,
                 seed: int = 0, _owns_dir: bool = False,
                 stripe: str = "row",
                 _pid: Optional[int] = None, _nproc: Optional[int] = None):
        if stripe not in ("row", "shard"):
            raise ValueError(f"unknown stripe mode {stripe!r} "
                             "(row | shard)")
        if mesh is not None:
            raise NotImplementedError(_NO_MESH)
        super().__init__()
        self.cache_dir = cache_dir
        self.seed = seed
        self.stripe = stripe
        self._owns_dir = _owns_dir
        meta = np.load(os.path.join(cache_dir, "meta.npy"),
                       allow_pickle=True).item()
        self.n: int = meta["n"]
        self.n_x: int = meta["n_x"]
        self.n_y: int = meta["n_y"]
        self.shard_rows: List[int] = meta["shard_rows"]
        self.pid = 0 if _pid is None else int(_pid)
        self.nproc = max(1 if _nproc is None else int(_nproc), 1)
        self.local_bs = max(batch_size // self.nproc, 1)
        self.global_bs = self.local_bs * self.nproc
        if stripe == "shard":
            self.shard_assignment = self._balanced_assignment(
                self.shard_rows, self.nproc)
            stripe_rows = [sum(self.shard_rows[s] for s in shards)
                           for shards in self.shard_assignment]
            self.steps_per_epoch = min(stripe_rows) // self.local_bs
            if self.steps_per_epoch == 0:
                raise ValueError(
                    f"shard striping: the smallest of {self.nproc} "
                    f"stripes holds {min(stripe_rows)} rows (< local "
                    f"batch {self.local_bs}) from "
                    f"{len(self.shard_rows)} shard file(s) — rewrite "
                    f"the cache with a smaller shard_size (or use "
                    f"stripe='row')")
        else:
            self.shard_assignment = None
            self.steps_per_epoch = self.n // self.global_bs
            if self.steps_per_epoch == 0:
                raise ValueError(
                    f"{self.n} rows < global batch {self.global_bs}")
        self._epoch_idx = 0

    @staticmethod
    def _balanced_assignment(shard_rows: Sequence[int], nproc: int
                             ) -> List[List[int]]:
        """Whole shards -> processes, balanced on row counts: greedy
        longest-first onto the lightest stripe (ties by pid)."""
        order = sorted(range(len(shard_rows)),
                       key=lambda s: (-shard_rows[s], s))
        loads = [0] * nproc
        out: List[List[int]] = [[] for _ in range(nproc)]
        for s in order:
            p = min(range(nproc), key=lambda q: (loads[q], q))
            out[p].append(s)
            loads[p] += shard_rows[s]
        for stripe in out:
            stripe.sort()
        return out

    # --- construction -------------------------------------------------------
    @staticmethod
    def write(data: Dict[str, Any], cache_dir: str,
              shard_size: int = 65536) -> str:
        """Spool {'x': arr|tuple, 'y': arr|tuple} into npy column shards
        (the JAX package's files)."""
        os.makedirs(cache_dir, exist_ok=True)
        xs = _as_tuple(data.get("x"))
        ys = _as_tuple(data.get("y"))
        n = len(xs[0])
        shard_rows = []
        for s, start in enumerate(range(0, n, shard_size)):
            end = min(start + shard_size, n)
            for i, a in enumerate(xs):
                np.save(os.path.join(cache_dir, f"shard-{s:05d}-x{i}.npy"),
                        np.asarray(a[start:end]))
            for i, a in enumerate(ys):
                np.save(os.path.join(cache_dir, f"shard-{s:05d}-y{i}.npy"),
                        np.asarray(a[start:end]))
            shard_rows.append(end - start)
        np.save(os.path.join(cache_dir, "meta.npy"),
                {"n": n, "n_x": len(xs), "n_y": len(ys),
                 "shard_rows": shard_rows})
        return cache_dir

    # --- iteration ----------------------------------------------------------
    def _mmap(self, s: int, kind: str, i: int) -> np.ndarray:
        return np.load(os.path.join(self.cache_dir,
                                    f"shard-{s:05d}-{kind}{i}.npy"),
                       mmap_mode="r")

    def _epoch_pieces(self, shuffle: bool):
        """This process's rows of one epoch in stream order, as (shard,
        local row indices) pieces, from the JAX stream's draws: the shard
        order, then each visited shard's rows."""
        rng = np.random.RandomState(self.seed + self._epoch_idx)
        self._epoch_idx += 1
        shard_order = np.arange(len(self.shard_rows))
        if shuffle:
            # the stripe filter comes after the shuffle, so every process
            # advances the one rng the same way
            rng.shuffle(shard_order)
        pid, nproc = self.pid, self.nproc
        own = (set(self.shard_assignment[pid])
               if self.shard_assignment is not None else None)
        pieces = []
        global_offset = 0
        for s in shard_order:
            rows = self.shard_rows[s]
            if own is not None:
                if s not in own:
                    global_offset += rows
                    continue
                local = np.arange(rows)
            else:
                start = (pid - global_offset) % nproc
                local = np.arange(start, rows, nproc)
            global_offset += rows
            if shuffle:
                rng.shuffle(local)
            pieces.append((int(s), local))
        return pieces

    def _host_batch_tasks(self, shuffle: bool, staged: bool = False
                          ) -> Iterator[Callable[[], Batch]]:
        """Plan an epoch: batch b is rows [b * bs, (b + 1) * bs) of the
        pieces' concatenation, which is what the JAX stream's carry
        buffers emit; yields one gather task per full batch."""
        pieces = self._epoch_pieces(shuffle)
        bs = self.local_bs
        p, off = 0, 0
        for _ in range(self.steps_per_epoch):
            parts, need = [], bs
            while need:
                s, local = pieces[p]
                take = min(need, len(local) - off)
                if take:
                    parts.append((s, local[off:off + take]))
                off += take
                need -= take
                if off == len(local):
                    p, off = p + 1, 0
            yield partial(self._assemble, parts, staged)

    def _assemble(self, parts, staged: bool = False) -> Batch:
        return Batch(
            x=tuple(self._gather("x", i, parts, staged)
                    for i in range(self.n_x)),
            y=tuple(self._gather("y", i, parts, staged)
                    for i in range(self.n_y)) or None,
            w=None)

    def _gather(self, kind: str, i: int, parts, staged: bool):
        """One leaf of a batch, narrowed to its wire dtype: into a pinned
        ring slot when ``staged`` on the card, else a host array."""
        srcs = [(self._mmap(s, kind, i), idx) for s, idx in parts]
        first = srcs[0][0]
        shape = (self.local_bs,) + first.shape[1:]
        dtype = xfer.narrows_to(first.dtype) or first.dtype
        pool = self._staging_pool() if staged else None
        slot = (pool.acquire(shape, dtype, tag=(kind, i))
                if pool is not None else None)
        out = slot.array if slot is not None else np.empty(shape, dtype)
        row = 0
        for src, idx in srcs:
            out[row:row + len(idx)] = src[idx]
            row += len(idx)
        return slot if slot is not None else out

    def _host_batches(self, shuffle: bool) -> Iterator[Batch]:
        """Assembled host batches, inline."""
        for task in self._host_batch_tasks(shuffle):
            yield task()

    def epoch(self, shuffle: bool = True, prefetch: bool = True
              ) -> Iterator[Batch]:
        """One epoch's batches on the device (the estimator's when fed
        through ``data_to_iterator``, else the card): through the infeed
        pump, or gathered and copied inline."""
        if self.device is None:
            self.device = resolve_device(None)
        return self._device_epoch(shuffle, prefetch)

    def cleanup(self):
        if self._owns_dir:
            shutil.rmtree(self.cache_dir, ignore_errors=True)


class FeatureSet:
    """Tier selector mirroring the reference's
    ``FeatureSet.rdd(memoryType=...)`` entry points (FeatureSet.scala:556:
    DRAM / PMEM / DISK_n)."""

    @staticmethod
    def from_arrays(data: Dict[str, Any], tier: str = "dram",
                    mesh=None, batch_size: int = 32,
                    cache_dir: Optional[str] = None,
                    shard_size: int = 65536, seed: int = 0,
                    stripe: str = "row"):
        tier = tier.lower()
        if mesh is not None:
            raise NotImplementedError(_NO_MESH)
        if tier == "dram":
            from ..orca.learn import utils as learn_utils
            return learn_utils.data_to_iterator(data, batch_size,
                                                shuffle=True, seed=seed)
        if tier.startswith("disk"):
            owns = cache_dir is None
            cache_dir = cache_dir or tempfile.mkdtemp(prefix="zoo_diskfs_")
            DiskFeatureSet.write(data, cache_dir, shard_size=shard_size)
            return DiskFeatureSet(cache_dir, None, batch_size, seed=seed,
                                  _owns_dir=owns, stripe=stripe)
        raise ValueError(f"unknown tier {tier!r} (dram | disk); the "
                         "reference's PMEM tier has no TPU-host analogue — "
                         "use disk")

    @staticmethod
    def from_xshards(shards: HostXShards, tier: str = "disk", **kw):
        """XShards of ``{"x", "y"}`` partitions, in partition order (their
        leaves are read per shard file, not merged first)."""
        from ..orca.learn.utils import chunk_shards
        return FeatureSet.from_arrays(chunk_shards(shards), tier=tier, **kw)

    @staticmethod
    def from_tfrecords(paths, feature_cols=None, label_cols=None,
                       tier: str = "disk", **kw):
        from ..orca.data.tfrecord import read_tfrecords_as_xshards
        shards = read_tfrecords_as_xshards(paths, feature_cols=feature_cols,
                                           label_cols=label_cols)
        return FeatureSet.from_xshards(shards, tier=tier, **kw)
