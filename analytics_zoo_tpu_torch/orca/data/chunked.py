"""Chunked column views (counterpart of ``analytics_zoo_tpu/orca/data/
chunked.py``): the zero-copy backbone of the XShards data plane.

A :class:`ChunkedArray` keeps the per-shard arrays as an ordered chunk
list plus a cumulative row offset table, so batches are gathered straight
out of the chunks and the dataset is never merged into one copy:

* a contiguous in-chunk range is a **zero-copy numpy view**;
* a contiguous range crossing a seam concatenates only the few chunk
  views it touches (O(batch), not O(dataset));
* an arbitrary (shuffled) index set is gathered per chunk, with the
  native threaded row gather (``native.gather_rows``) for one chunk.

Row order is the concatenation order of the chunks, so every gather is
bit-identical to indexing the ``np.concatenate`` of the chunks.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

__all__ = ["ChunkedArray", "as_chunked"]


class ChunkedArray:
    """A logical row-wise concatenation of numpy chunks, without the copy.

    Mirrors the read-only subset of the ndarray surface the input pipeline
    needs (``len``/``shape``/``dtype``/``nbytes``/``__getitem__``), plus
    :meth:`gather` and :meth:`slice` for batch assembly.
    ``materializations`` counts full copies forced through ``__array__`` —
    the training path must keep it at zero.
    """

    def __init__(self, chunks: Sequence[np.ndarray]):
        # contiguity is normalized ONCE here (a no-op for the common
        # already-contiguous case): the native row-gather would otherwise
        # re-copy a strided chunk on every batch it assembles
        chunks = [np.ascontiguousarray(c) for c in chunks]
        if not chunks:
            raise ValueError("ChunkedArray needs at least one chunk")
        tails = {c.shape[1:] for c in chunks}
        if len(tails) != 1:
            raise ValueError(
                f"chunks must share trailing dims, got {sorted(tails)}")
        dtypes = {c.dtype for c in chunks}
        if len(dtypes) != 1:
            # match np.concatenate's promotion so chunked and merged
            # streams stay bit-identical
            dt = np.result_type(*[c.dtype for c in chunks])
            chunks = [c.astype(dt) for c in chunks]
        self.chunks: List[np.ndarray] = chunks
        self.offsets = np.zeros(len(chunks) + 1, np.int64)
        np.cumsum([len(c) for c in chunks], out=self.offsets[1:])
        self.materializations = 0

    # --- ndarray-ish surface -------------------------------------------------
    def __len__(self) -> int:
        return int(self.offsets[-1])

    @property
    def shape(self):
        return (len(self),) + self.chunks[0].shape[1:]

    @property
    def ndim(self) -> int:
        return self.chunks[0].ndim

    @property
    def dtype(self):
        return self.chunks[0].dtype

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.chunks)

    @property
    def num_chunks(self) -> int:
        return len(self.chunks)

    def __getitem__(self, key) -> np.ndarray:
        if isinstance(key, (int, np.integer)):
            i = int(key) + (len(self) if key < 0 else 0)
            if not 0 <= i < len(self):
                raise IndexError(
                    f"index {key} out of range for {len(self)} rows")
            c = int(np.searchsorted(self.offsets, i, side="right")) - 1
            return self.chunks[c][i - int(self.offsets[c])]
        if isinstance(key, slice):
            start, stop, step = key.indices(len(self))
            if step != 1:
                return self.gather(np.arange(start, stop, step))
            return self.slice(start, stop)
        return self.gather(np.asarray(key))

    def __array__(self, dtype=None, copy=None):
        self.materializations += 1
        out = self.slice(0, len(self))
        return out.astype(dtype) if dtype is not None else out

    def __repr__(self):
        return (f"ChunkedArray(shape={self.shape}, dtype={self.dtype}, "
                f"chunks={self.num_chunks})")

    # --- gathers -------------------------------------------------------------
    def slice(self, start: int, stop: int) -> np.ndarray:
        """Rows [start, stop): a zero-copy view inside one chunk, a small
        seam concatenation across chunks."""
        start = max(int(start), 0)
        stop = min(int(stop), len(self))
        if stop <= start:
            return np.empty((0,) + self.chunks[0].shape[1:], self.dtype)
        c0 = int(np.searchsorted(self.offsets, start, side="right")) - 1
        c1 = int(np.searchsorted(self.offsets, stop - 1, side="right")) - 1
        if c0 == c1:
            o = int(self.offsets[c0])
            return self.chunks[c0][start - o:stop - o]
        pieces = []
        for c in range(c0, c1 + 1):
            o = int(self.offsets[c])
            lo = max(start - o, 0)
            hi = min(stop - o, len(self.chunks[c]))
            if hi > lo:
                pieces.append(self.chunks[c][lo:hi])
        return np.concatenate(pieces)

    def gather(self, idx: np.ndarray,
               out: Optional[np.ndarray] = None) -> np.ndarray:
        """``out[i] = self[idx[i]]`` without materializing the dataset.
        Matches ndarray fancy-indexing semantics: boolean masks select,
        negative indices wrap, out-of-range indices raise IndexError
        (never an OOB native read).

        ``out`` is a destination *hint* for the allocating gather paths
        (a reusable staging buffer — C-contiguous, gather shape/dtype);
        the contiguous-run fast path still returns a zero-copy view, so
        callers must use the RETURN value, which may or may not be
        ``out``."""
        idx = np.asarray(idx)
        if idx.dtype == np.bool_:
            if idx.shape != (len(self),):
                raise IndexError(
                    f"boolean mask of shape {idx.shape} does not match "
                    f"ChunkedArray of {len(self)} rows")
            idx = np.nonzero(idx)[0]
        idx = np.asarray(idx, np.int64)
        n = len(idx)
        total = len(self)
        if n == 0:
            return np.empty((0,) + self.chunks[0].shape[1:], self.dtype)
        if idx.min() < 0:
            idx = np.where(idx < 0, idx + total, idx)
        if idx.min() < 0 or idx.max() >= total:
            raise IndexError(
                f"index out of range for ChunkedArray of {total} rows: "
                f"[{np.asarray(idx).min()}, {np.asarray(idx).max()}]")
        # contiguous ascending run -> the view/seam path
        if int(idx[-1]) - int(idx[0]) == n - 1 and (
                n == 1 or bool((np.diff(idx) == 1).all())):
            return self.slice(int(idx[0]), int(idx[-1]) + 1)
        if out is not None and (
                out.shape != (n,) + self.chunks[0].shape[1:]
                or out.dtype != self.dtype
                or not out.flags.c_contiguous):
            out = None              # unusable hint: fall back to allocating
        if len(self.chunks) == 1:
            from ...native.runtime import gather_rows
            return gather_rows(self.chunks[0], idx, out=out)
        pos = np.searchsorted(self.offsets, idx, side="right") - 1
        local = idx - self.offsets[pos]
        if out is None:
            out = np.empty((n,) + self.chunks[0].shape[1:], self.dtype)
        for c in np.unique(pos):
            sel = pos == c
            out[sel] = self.chunks[int(c)][local[sel]]
        return out


def as_chunked(a: Union[np.ndarray, ChunkedArray, Sequence[np.ndarray]]
               ) -> ChunkedArray:
    """Wrap an ndarray (one chunk, zero copy) or pass a ChunkedArray
    through."""
    if isinstance(a, ChunkedArray):
        return a
    if isinstance(a, (list, tuple)):
        return ChunkedArray(a)
    return ChunkedArray([np.asarray(a)])
