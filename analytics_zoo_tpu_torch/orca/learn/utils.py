"""Input pipeline (counterpart of ``analytics_zoo_tpu/orca/learn/utils.py``)
for one process and one device: user data (a dict ``{"x", "y"}``, an
``(x, y)`` tuple, bare features, XShards of numpy dicts or of pandas
DataFrames with ``feature_cols``/``label_cols``, or a creator function)
becomes a :class:`BatchIterator` of padded global batches.

As in the JAX package, every input is first normalised to XShards of
``{"x": tuple, "y": tuple}`` partitions (:func:`xshards_from_arrays`), and
each leaf becomes a :class:`~..data.chunked.ChunkedArray` over the
partitions (:func:`chunk_shards`): batches are gathered straight out of the
partitions, and the dataset is never merged into one copy. Row order is
the partitions' concatenation order, so the batch stream over XShards is
bit-identical to the stream over the concatenated arrays.

The batch stream follows the JAX package's: ``batch_size`` is the global
batch, the ragged tail is padded with row 0 and masked by a per-row weight
(1.0 real, 0.0 padding) when ``pad_tail``, a full batch carries ``w=None``,
and wide leaves are narrowed on the wire (``native.transfer.narrow_wire``).
A shuffled epoch takes its order from ``native.shuffled_indices(n, seed +
epoch)``, the same call the JAX package makes: the native xoshiro shuffle
when the runtime builds, numpy's permutation when it does not, so the two
packages visit the rows in the same order in the same environment.

``epoch(prefetch=True)`` runs the host-to-device plane: the epoch's
gathers fan out over the infeed pump's worker threads into pinned staging
buffers, and its transfer lanes copy each batch to the card on a side
stream ahead of the step (``native/infeed.py``, ``native/transfer.py``).
``prefetch=False`` gathers and copies inline. Both deliver the same
batches in the same order.

pandas is imported by none of this: a DataFrame can only reach these
functions once its caller has imported pandas. Not ported yet: fused
(stacked) superbatches.
"""

from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ...native import runtime
from ...native import transfer as xfer
from ...native.infeed import (_MAX_DEPTH, InfeedPump, PipelineStats,
                              _default_workers)
from ...utils import nest
from ..data.chunked import ChunkedArray, as_chunked
from ..data.shard import HostXShards


@dataclass
class Batch:
    """One global batch: tuples of feature/label leaves plus a mask weight
    (``None`` when every row is real). Leaves are host numpy arrays, or
    device tensors whose copies ``ready`` (a CUDA event) follows."""
    x: Tuple[Any, ...]
    y: Optional[Tuple[Any, ...]]
    w: Optional[Any]
    ready: Optional[Any] = None

    def leaves(self):
        return list(self.x) + list(self.y or ()) + (
            [self.w] if self.w is not None else [])

    def rebuild(self, leaves, ready=None) -> "Batch":
        nx, ny = len(self.x), len(self.y or ())
        return Batch(x=tuple(leaves[:nx]),
                     y=tuple(leaves[nx:nx + ny]) if self.y is not None
                     else None,
                     w=leaves[nx + ny] if self.w is not None else None,
                     ready=ready)

    def to(self, device: torch.device) -> "Batch":
        """The batch as tensors on ``device``, ready for the current
        stream. A batch the transfer plane already put there is waited on
        (the current stream waits on its copies' event, and each tensor is
        marked as used by that stream); a host batch is copied now."""
        leaves = self.leaves()
        if all(isinstance(a, torch.Tensor) and a.device.type == device.type
               for a in leaves):
            if self.ready is not None:
                cur = torch.cuda.current_stream(leaves[0].device)
                cur.wait_event(self.ready)
                for t in leaves:
                    t.record_stream(cur)
                self.ready = None
            return self
        out, _ = xfer.put_tree(leaves, device)
        return self.rebuild(out)


def _as_tuple(v) -> Tuple:
    if v is None:
        return ()
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return (v,)


def _is_dataframe(obj) -> bool:
    """Whether ``obj`` is a pandas DataFrame, without importing pandas: an
    object can only be one once its caller has imported pandas."""
    pd = sys.modules.get("pandas")
    return pd is not None and isinstance(obj, pd.DataFrame)


def xshards_from_arrays(data: Any, feature_cols=None, label_cols=None,
                        num_shards: Optional[int] = None) -> HostXShards:
    """Normalise any supported input into XShards of ``{"x": tuple, "y":
    tuple}`` partitions: XShards and DataFrames through
    :func:`normalize_xshards`, a dict ``{"x", "y"}``, an ``(x, y)`` tuple
    or bare features into one partition (or ``num_shards`` even ones)."""
    if isinstance(data, HostXShards):
        return normalize_xshards(data, feature_cols, label_cols)
    if _is_dataframe(data):
        return normalize_xshards(HostXShards([data]), feature_cols,
                                 label_cols)
    if isinstance(data, dict):
        x, y = data.get("x"), data.get("y")
    elif isinstance(data, tuple) and len(data) == 2:
        x, y = data
    else:
        x, y = data, None
    shard = {"x": _as_tuple(x)}
    if y is not None:
        shard["y"] = _as_tuple(y)
    n = num_shards or 1
    flat_len = len(nest.flatten(shard)[0])
    n = min(n, max(flat_len, 1))
    if n == 1:
        # one partition: the caller's arrays as they are, no index copy
        return HostXShards([{k: tuple(np.asarray(a) for a in v)
                             for k, v in shard.items()}])
    return HostXShards([{k: tuple(np.asarray(a)[idx] for a in v)
                         for k, v in shard.items()}
                        for idx in np.array_split(np.arange(flat_len), n)])


def normalize_xshards(shards: HostXShards, feature_cols=None,
                      label_cols=None) -> HostXShards:
    """Map pandas-DataFrame or column-dict partitions to ``{"x": tuple,
    "y": tuple}`` ones, selecting ``feature_cols`` (and ``label_cols``);
    partitions that already hold ``"x"`` keep it."""
    first = shards.collect()[0] if shards.num_partitions() else None

    def from_df(df):
        out = {"x": tuple(df[c].to_numpy() for c in feature_cols)}
        if label_cols:
            out["y"] = tuple(df[c].to_numpy() for c in label_cols)
        return out

    def from_dict(d):
        if "x" in d:
            out = {"x": _as_tuple(d["x"])}
            if "y" in d and d["y"] is not None:
                out["y"] = _as_tuple(d["y"])
            return out
        if not feature_cols:
            raise ValueError(
                "shards are column dicts; pass feature_cols (and label_cols)"
                f" — available keys: {sorted(d.keys())}")
        out = {"x": tuple(np.asarray(d[c]) for c in feature_cols)}
        if label_cols:
            out["y"] = tuple(np.asarray(d[c]) for c in label_cols)
        return out

    if _is_dataframe(first):
        if not feature_cols:
            raise ValueError(
                "feature_cols is required for pandas-DataFrame XShards")
        return shards.transform_shard(from_df)
    if isinstance(first, dict):
        return shards.transform_shard(from_dict)
    raise ValueError(f"unsupported shard element type {type(first)}")


def chunk_shards(shards: HostXShards
                 ) -> Dict[str, Tuple[ChunkedArray, ...]]:
    """Each leaf of the ``{"x", "y"}`` partitions as a
    :class:`ChunkedArray` over the partitions' arrays, in partition order:
    no merged copy of the dataset is built."""
    parts = shards.collect()
    if not parts:
        raise ValueError("empty XShards")
    return {k: tuple(ChunkedArray([p[k][i] for p in parts])
                     for i in range(len(parts[0][k])))
            for k in parts[0]}


def update_predict_xshards(xshards: HostXShards,
                           pred_shards: HostXShards) -> HostXShards:
    """Each partition of ``xshards`` with its predictions under
    ``"prediction"``."""
    def merge(pair):
        d, pred = pair
        out = dict(d) if isinstance(d, dict) else {"x": d}
        out["prediction"] = pred
        return out
    return xshards.zip(pred_shards).transform_shard(merge)


class DeviceFeed:
    """The device side of an epoch iterator, shared by
    :class:`BatchIterator` and ``orca.data.image.ImageNetPipeline``. A
    subclass plans an epoch with ``_host_batch_tasks(shuffle, staged)``,
    an iterator of zero-argument assembly tasks in batch order (``staged``:
    assemble into the pinned ``StagingPool``); this class runs them inline
    or through the infeed pump and copies their batches to ``device``.

    ``stats`` (a :class:`PipelineStats`) records the ``assemble`` and
    ``h2d`` stages; ``prefetch_depth``/``prefetch_workers`` size the pump.
    """

    def __init__(self, device: Optional[torch.device] = None,
                 stats: Optional[PipelineStats] = None,
                 prefetch_depth: int = 2,
                 prefetch_workers: Optional[int] = None):
        self.device = device
        self.stats = stats if stats is not None else PipelineStats()
        self.prefetch_depth = prefetch_depth
        self.prefetch_workers = prefetch_workers
        self._staging = None        # StagingPool, built on the first epoch
        self._stream = None         # the transfer lanes' CUDA stream

    def _host_batch_tasks(self, shuffle: bool, staged: bool = False
                          ) -> Iterator[Callable[[], Batch]]:
        raise NotImplementedError

    def _staging_pool(self) -> Optional[xfer.StagingPool]:
        """Pinned gather buffers for the prefetch path on the card, in a
        ring sized above the pump's worst-case in-flight window (assembly
        workers, lane ceiling, depth ceiling, the consumer's batch and a
        margin), as in the JAX package. None off the card."""
        if self.device is None or self.device.type != "cuda":
            return None
        if self._staging is None:
            workers = self.prefetch_workers or _default_workers()
            self._staging = xfer.StagingPool(
                ring=workers + xfer.MAX_H2D_LANES
                + max(_MAX_DEPTH, self.prefetch_depth) + 4)
        return self._staging

    def _put_batch(self, b: Batch, lane: bool = False) -> Batch:
        """Copy a host batch to the device. From a transfer lane the copies
        go on the side stream and the lane waits for them, so the ``h2d``
        stage times the copy itself and a delivered batch is complete;
        inline they go on the current stream, ahead of the step."""
        stream = None
        if lane and self.device.type == "cuda":
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            stream = self._stream
        out, ev = xfer.put_tree(b.leaves(), self.device, stream)
        if lane and ev is not None:
            ev.synchronize()
        return b.rebuild(out, ready=ev)

    def _device_epoch(self, shuffle: bool, prefetch: bool
                      ) -> Iterator[Batch]:
        """One epoch's batches on ``device``: through the infeed pump
        (``prefetch``) or assembled and copied inline; both deliver the
        same batches in the same order."""
        if not prefetch:
            return self._inline_epoch(shuffle)
        return iter(InfeedPump(
            lambda: self._host_batch_tasks(shuffle, staged=True),
            device_put=partial(self._put_batch, lane=True),
            depth=self.prefetch_depth, workers=self.prefetch_workers,
            stats=self.stats))

    def _inline_epoch(self, shuffle: bool) -> Iterator[Batch]:
        for task in self._host_batch_tasks(shuffle):
            t0 = time.perf_counter()
            b = task()
            t1 = time.perf_counter()
            out = self._put_batch(b)
            t2 = time.perf_counter()
            nbytes = xfer.wire_nbytes(b.leaves())
            self.stats.add("assemble", t1 - t0, nbytes=nbytes)
            self.stats.add("h2d", t2 - t1, nbytes=nbytes)
            yield out


class BatchIterator(DeviceFeed):
    """Epoch iterator over host data producing padded global batches on
    ``device`` (host numpy batches when ``device`` is None). ``data`` is
    ``{"x": tuple, "y": tuple}`` of arrays or :class:`ChunkedArray` leaves,
    or XShards of such partitions (chunked here)."""

    def __init__(self, data, batch_size: int, shuffle: bool = False,
                 seed: int = 0, pad_tail: bool = True,
                 device: Optional[torch.device] = None,
                 stats: Optional[PipelineStats] = None,
                 prefetch_depth: int = 2,
                 prefetch_workers: Optional[int] = None):
        super().__init__(device, stats, prefetch_depth, prefetch_workers)
        if isinstance(data, HostXShards):
            data = chunk_shards(data)
        self.x = tuple(as_chunked(a) for a in data["x"])
        self.y = (tuple(as_chunked(a) for a in data["y"])
                  if data.get("y") is not None else None)
        self.n = len(self.x[0])
        self.local_bs = self.global_bs = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.pad_tail = pad_tail
        self.steps_per_epoch = (math.ceil(self.n / self.local_bs) if pad_tail
                                else self.n // self.local_bs)
        if self.steps_per_epoch == 0:
            raise ValueError(
                f"dataset has {self.n} rows < local batch {self.local_bs}")
        self._epoch = 0

    # --- assembly -----------------------------------------------------------
    def _gather_leaf(self, a: ChunkedArray, idx: np.ndarray, staged: bool):
        """The rows ``idx`` of a leaf, narrowed to its wire dtype: into a
        pinned ring slot when ``staged`` on the card, else a host array.
        A contiguous run comes back from the chunks as a view, and a wide
        leaf gathers before it narrows: both are copied into the slot."""
        pool = self._staging_pool() if staged else None
        if pool is None:
            return xfer.narrow_wire(a.gather(idx))
        wire = xfer.narrows_to(a.dtype) or a.dtype
        slot = pool.acquire((len(idx),) + a.shape[1:], wire, tag=id(a))
        got = a.gather(idx, out=slot.array if wire == a.dtype else None)
        if got is not slot.array:
            np.copyto(slot.array, got, casting="unsafe")
        return slot

    def _assemble_batch(self, idx: np.ndarray, w: Optional[np.ndarray],
                        staged: bool = False) -> Batch:
        return Batch(x=tuple(self._gather_leaf(a, idx, staged)
                             for a in self.x),
                     y=(tuple(self._gather_leaf(a, idx, staged)
                              for a in self.y)
                        if self.y is not None else None),
                     w=w)

    def _host_batch_tasks(self, shuffle: bool, staged: bool = False
                          ) -> Iterator[Callable[[], Batch]]:
        """Plan an epoch: yield zero-arg assembly tasks in batch order. The
        order is fixed here, so running the tasks inline or on the pump's
        workers gives the same batches."""
        if shuffle:
            order = runtime.shuffled_indices(self.n,
                                             seed=self.seed + self._epoch)
        else:
            order = np.arange(self.n, dtype=np.int64)
        self._epoch += 1
        for s in range(self.steps_per_epoch):
            idx = order[s * self.local_bs:(s + 1) * self.local_bs]
            real = len(idx)
            w = None
            if real < self.local_bs:
                idx = np.concatenate(
                    [idx, np.zeros(self.local_bs - real, dtype=idx.dtype)])
                w = np.zeros(self.local_bs, dtype=np.float32)
                w[:real] = 1.0
            yield partial(self._assemble_batch, idx, w, staged)

    def _host_batches(self, shuffle: bool) -> Iterator[Batch]:
        """Assembled host batches, inline."""
        for task in self._host_batch_tasks(shuffle):
            yield task()

    def epoch(self, shuffle: Optional[bool] = None,
              prefetch: bool = True) -> Iterator[Batch]:
        """Yield the batches of one epoch: on ``device`` through the
        infeed pump (``prefetch``) or inline; host batches without a
        device."""
        shuffle = self.shuffle if shuffle is None else shuffle
        if self.device is None:
            return self._host_batches(shuffle)
        return self._device_epoch(shuffle, prefetch)


def data_to_iterator(data: Any, batch_size: int, feature_cols=None,
                     label_cols=None, shuffle=False, seed: int = 0,
                     pad_tail: bool = True, config: Optional[dict] = None,
                     device: Optional[torch.device] = None,
                     stats: Optional[PipelineStats] = None) -> BatchIterator:
    """Front door: any supported data form -> BatchIterator. An iterator
    already (a :class:`DeviceFeed`: a ``BatchIterator``, an
    ``ImageNetPipeline`` streaming from disk) passes through, given the
    device it lacks and ``stats``; a callable is a
    ``data_creator(config, batch_size)``; anything else goes through
    :func:`xshards_from_arrays` into a ``BatchIterator`` that gathers
    straight out of the partitions. Config keys ``infeed_depth`` and
    ``infeed_workers`` size the pump."""
    if isinstance(data, DeviceFeed):
        if data.device is None:
            data.device = device
        if stats is not None:
            data.stats = stats
        return data
    if callable(data):
        return data_to_iterator(data(config or {}, batch_size), batch_size,
                                feature_cols, label_cols, shuffle, seed,
                                pad_tail, config=config, device=device,
                                stats=stats)
    cfg = config or {}
    return BatchIterator(xshards_from_arrays(data, feature_cols, label_cols),
                         batch_size, shuffle=shuffle, seed=seed,
                         pad_tail=pad_tail, device=device, stats=stats,
                         prefetch_depth=int(cfg.get("infeed_depth", 2)),
                         prefetch_workers=cfg.get("infeed_workers"))


def find_latest_checkpoint(model_dir: str, model_type: str = "tpu"):
    """The newest checkpoint dir under ``model_dir`` and its step, or
    ``(None, None)``. One scanner, ``ckpt.format.loadable_step_dirs``,
    decides candidacy for this and the plane: a plane dir counts only when
    committed; bare step dirs of pre-plane layouts count too."""
    from ...ckpt.format import loadable_step_dirs
    dirs = loadable_step_dirs(model_dir, bare_ok=True)
    if not dirs:
        return None, None
    step, path = dirs[-1]
    return path, step
