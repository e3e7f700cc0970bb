"""Input pipeline (counterpart of ``analytics_zoo_tpu/orca/learn/utils.py``)
for one process and one device: user data (a dict ``{"x", "y"}``, an
``(x, y)`` tuple, bare features or a creator function) becomes a
:class:`BatchIterator` of padded global batches.

The batch stream follows the JAX package's: ``batch_size`` is the global
batch, the ragged tail is padded with row 0 and masked by a per-row weight
(1.0 real, 0.0 padding) when ``pad_tail``, a full batch carries ``w=None``,
and wide leaves are narrowed on the wire (f64 -> f32, i64 -> i32, the
device form JAX canonicalises to). A shuffled epoch takes the order
``np.random.RandomState(seed + epoch).permutation(n)``, the JAX package's
own shuffle when its native runtime is not built.

Not ported yet: XShards and pandas inputs, the native shuffle and gather,
the infeed pump's prefetch, and fused (stacked) superbatches.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}


@dataclass
class Batch:
    """One global batch: tuples of feature/label arrays plus a mask weight
    (``None`` when every row is real)."""
    x: Tuple[Any, ...]
    y: Optional[Tuple[Any, ...]]
    w: Optional[Any]

    def to(self, device: torch.device) -> "Batch":
        """The same batch as tensors on ``device`` (pinned, non-blocking
        copies to a GPU)."""
        def put(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            if device.type == "cuda":
                return t.pin_memory().to(device, non_blocking=True)
            return t.to(device)

        return Batch(x=tuple(put(a) for a in self.x),
                     y=(tuple(put(a) for a in self.y)
                        if self.y is not None else None),
                     w=None if self.w is None else put(self.w))


def _as_tuple(v) -> Tuple:
    if v is None:
        return ()
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return (v,)


def xshards_from_arrays(data: Any, feature_cols=None, label_cols=None
                        ) -> Dict[str, Tuple[np.ndarray, ...]]:
    """Normalise a dict ``{"x", "y"}``, an ``(x, y)`` tuple or bare
    features into one shard ``{"x": tuple, "y": tuple}`` of numpy arrays
    (the JAX package returns XShards of such dicts; with one process there
    is one shard)."""
    if feature_cols is not None or label_cols is not None:
        raise NotImplementedError("feature_cols/label_cols select columns "
                                  "of XShards or DataFrames, which are not "
                                  "ported yet")
    if isinstance(data, dict):
        x, y = data.get("x"), data.get("y")
    elif isinstance(data, tuple) and len(data) == 2:
        x, y = data
    elif isinstance(data, np.ndarray) or (
            isinstance(data, (list, tuple))
            and all(isinstance(a, np.ndarray) for a in data)):
        x, y = data, None
    else:
        raise NotImplementedError(
            f"input of type {type(data).__name__} is not ported yet (dicts, "
            "(x, y) tuples and arrays are)")
    shard = {"x": tuple(np.asarray(a) for a in _as_tuple(x))}
    if y is not None:
        shard["y"] = tuple(np.asarray(a) for a in _as_tuple(y))
    return shard


class BatchIterator:
    """Epoch iterator over host arrays producing padded global batches
    (host numpy; ``Batch.to`` moves one to the device)."""

    def __init__(self, data: Dict[str, Tuple[np.ndarray, ...]],
                 batch_size: int, shuffle: bool = False, seed: int = 0,
                 pad_tail: bool = True):
        self.x = tuple(np.asarray(a) for a in data["x"])
        self.y = (tuple(np.asarray(a) for a in data["y"])
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

    @staticmethod
    def _gather(a: np.ndarray, idx: np.ndarray) -> np.ndarray:
        out = a[idx]
        narrow = _NARROW.get(out.dtype)
        return out.astype(narrow) if narrow is not None else out

    def _host_batches(self, shuffle: bool) -> Iterator[Batch]:
        """Plan and assemble one epoch of host batches, in batch order."""
        if shuffle:
            order = np.random.RandomState(self.seed + self._epoch
                                          ).permutation(self.n)
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
            yield Batch(x=tuple(self._gather(a, idx) for a in self.x),
                        y=(tuple(self._gather(a, idx) for a in self.y)
                           if self.y is not None else None),
                        w=w)

    def epoch(self, shuffle: Optional[bool] = None) -> Iterator[Batch]:
        """Yield the host batches of one epoch."""
        return self._host_batches(self.shuffle if shuffle is None
                                  else shuffle)


def data_to_iterator(data: Any, batch_size: int, feature_cols=None,
                     label_cols=None, shuffle=False, seed: int = 0,
                     pad_tail: bool = True,
                     config: Optional[dict] = None) -> BatchIterator:
    """Front door: any supported data form -> BatchIterator. A
    ``BatchIterator`` passes through; a callable is a
    ``data_creator(config, batch_size)``."""
    if isinstance(data, BatchIterator):
        return data
    if callable(data):
        return data_to_iterator(data(config or {}, batch_size), batch_size,
                                feature_cols, label_cols, shuffle, seed,
                                pad_tail, config=config)
    return BatchIterator(xshards_from_arrays(data, feature_cols, label_cols),
                         batch_size, shuffle=shuffle, seed=seed,
                         pad_tail=pad_tail)
