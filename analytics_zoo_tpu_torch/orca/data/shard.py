"""XShards (counterpart of ``analytics_zoo_tpu/orca/data/shard.py``): the
data-shard abstraction over host-local partitions.

Each process owns its partitions as host-local numpy dicts, pandas
DataFrames or other objects; transforms run on a thread pool (numpy
releases the GIL), and the estimator gathers batches straight out of the
partitions (``orca/learn/utils.chunk_shards``) and copies them to the card.
The API keeps the reference's shard semantics (``transform_shard``,
``collect``, ``repartition``, ``partition_by``, ``unique``, ``split``,
``zip``, ``save_pickle``/``load_pickle``, ``__getitem__``). pandas is
imported only inside the functions that take DataFrames.
"""

from __future__ import annotations

import glob as _glob
import os
import pickle
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from ...common.context import get_context
from ...utils import nest

_POOL: Optional[ThreadPoolExecutor] = None


def _pool() -> ThreadPoolExecutor:
    global _POOL
    if _POOL is None:
        _POOL = ThreadPoolExecutor(max_workers=min(32, (os.cpu_count() or 4)))
    return _POOL


def _pmap(fn, items):
    if len(items) <= 1:
        return [fn(x) for x in items]
    return list(_pool().map(fn, items))


class XShards:
    """Abstract shard collection (reference: orca/data/shard.py:25)."""

    def transform_shard(self, func: Callable, *args) -> "XShards":
        raise NotImplementedError

    def collect(self) -> List[Any]:
        raise NotImplementedError

    def num_partitions(self) -> int:
        raise NotImplementedError

    @classmethod
    def load_pickle(cls, path: str, minPartitions: Optional[int] = None
                    ) -> "HostXShards":
        """Load shards saved by :meth:`HostXShards.save_pickle`
        (reference: shard.py:60)."""
        paths = sorted(_glob.glob(os.path.join(path, "part-*.pkl")))
        if not paths:
            raise FileNotFoundError(f"no part-*.pkl under {path}")
        parts = []
        for p in paths:
            with open(p, "rb") as f:
                parts.extend(pickle.load(f))
        shards = HostXShards(parts)
        if minPartitions and shards.num_partitions() < minPartitions:
            shards = shards.repartition(minPartitions)
        return shards

    @staticmethod
    def partition(data: Any, num_shards: Optional[int] = None) -> "HostXShards":
        """Partition an in-memory ndarray/list/dict-of-ndarray into shards by
        splitting along the first dimension of every leaf (reference
        semantics: orca/data/shard.py:73-126). Without ``num_shards``, one
        shard per device of the context."""
        n = num_shards or max(len(get_context().local_devices), 1)
        flat = nest.flatten(data)
        if not flat:
            raise ValueError("empty data")
        lengths = {len(a) for a in flat}
        if len(lengths) != 1:
            raise ValueError(
                f"leaves must share first-dim length, got {sorted(lengths)}")
        total = lengths.pop()
        if n > total:
            raise ValueError(
                f"number of shards {n} exceeds first-dim length {total}")
        parts = []
        for i in range(n):
            idx = np.arange(i, total, n)  # round-robin like the reference
            part_flat = [a[idx] if isinstance(a, np.ndarray)
                         else [a[j] for j in idx] for a in flat]
            parts.append(nest.pack_sequence_as(data, part_flat))
        return HostXShards(parts)


class HostXShards(XShards):
    """Host-local shard collection: a list of partitions, each one element
    (numpy dict, pandas DataFrame, or arbitrary object) — the stand-in
    for both SparkXShards and RayXShards.

    ``transform_shard`` is **lazy with stage fusion**: a chain of k
    transforms defers until the data is first read (collect / repartition /
    len / ...), then runs as ONE pool pass per partition — the composed
    stages execute back-to-back on each partition (one pool dispatch and
    one pass of cache traffic instead of k). Every stage still runs
    **exactly once** per partition: each node in the chain memoizes its
    result during the fused pass, so reading an intermediate shards object
    later never re-applies earlier stages (in-place transform functions
    behave exactly as under the old eager implementation).
    """

    def __init__(self, partitions: Sequence[Any], transient: bool = False):
        self._parent: Optional["HostXShards"] = None
        self._stage: Optional[tuple] = None
        self._materialized: Optional[List[Any]] = list(partitions)
        self.transient = transient

    @classmethod
    def _lazy(cls, parent: "HostXShards", stage: tuple,
              transient: bool = False) -> "HostXShards":
        out = cls.__new__(cls)
        out._parent = parent
        out._stage = stage
        out._materialized = None
        out.transient = transient
        return out

    @property
    def _parts(self) -> List[Any]:
        """Materialized partitions. Walks up to the nearest already-
        materialized ancestor, then runs the pending stages as ONE fused
        pool pass per partition, memoizing every node on the way so each
        stage executes exactly once no matter which nodes are read later."""
        if self._materialized is not None:
            return self._materialized
        chain: List["HostXShards"] = []
        node = self
        while node._materialized is None:
            chain.append(node)
            node = node._parent
        base = node._materialized
        chain.reverse()
        stages = [n._stage for n in chain]

        def run(p):
            outs = []
            for fn, args in stages:
                p = fn(p, *args)
                outs.append(p)
            return outs

        results = _pmap(run, base)
        for i, n in enumerate(chain):
            n._materialized = [r[i] for r in results]
        return self._materialized

    # --- core ---------------------------------------------------------------
    def transform_shard(self, func: Callable, *args) -> "HostXShards":
        """Apply ``func(shard, *args)`` to every partition (reference:
        shard.py:146-163). Lazy: the call is recorded and fused with any
        further ``transform_shard`` calls into one pool pass per partition,
        executed (exactly once per stage) on first read."""
        return HostXShards._lazy(self, (func, args))

    def collect(self) -> List[Any]:
        return list(self._parts)

    def num_partitions(self) -> int:
        # transforms are 1:1 per partition — no need to materialize
        node = self
        while node._materialized is None:
            node = node._parent
        return len(node._materialized)

    def cache(self) -> "HostXShards":
        self.transient = False
        return self

    def uncache(self) -> "HostXShards":
        self.transient = True
        return self

    def is_cached(self) -> bool:
        return not self.transient

    def compute(self) -> "HostXShards":
        return self

    # --- reshaping ----------------------------------------------------------
    @staticmethod
    def _split_bounds(total: int, n: int) -> List[tuple]:
        """[start, stop) ranges identical to ``np.array_split(arange(total),
        n)`` — the reference's even re-split, expressed as chunk indices."""
        base, extra = divmod(total, n)
        bounds, start = [], 0
        for i in range(n):
            stop = start + base + (1 if i < extra else 0)
            bounds.append((start, stop))
            start = stop
        return bounds

    def repartition(self, num_partitions: int) -> "HostXShards":
        """Coalesce/split partitions into even contiguous row ranges (same
        row sets as the reference's merge-then-split, shard.py:219-293) —
        but computed on chunk indices: no merged full-dataset copy is ever
        built. Each output partition is its own copy (one copy of each row
        total, vs the old merge+split's two), so mutating an output never
        writes through to the source shards."""
        from .chunked import ChunkedArray
        parts = self._parts
        if not parts:
            return HostXShards([])
        first = parts[0]
        if isinstance(first, dict) and all(
                isinstance(v, np.ndarray) or
                (isinstance(v, tuple) and
                 all(isinstance(a, np.ndarray) for a in v))
                for v in first.values()):
            cols = {}
            for k, v in first.items():
                if isinstance(v, tuple):
                    cols[k] = tuple(ChunkedArray([p[k][i] for p in parts])
                                    for i in range(len(v)))
                else:
                    cols[k] = ChunkedArray([p[k] for p in parts])
            lead = next(iter(cols.values()))
            total = len(lead[0] if isinstance(lead, tuple) else lead)

            def cut(c: ChunkedArray, start: int, stop: int) -> np.ndarray:
                piece = c.slice(start, stop)
                # in-chunk slices come back as views — copy at this API
                # boundary so partitions never alias the inputs (seam
                # slices are already fresh concatenations)
                return piece.copy() if piece.base is not None else piece

            out = []
            for start, stop in self._split_bounds(total, num_partitions):
                out.append({
                    k: (tuple(cut(c, start, stop) for c in v)
                        if isinstance(v, tuple) else cut(v, start, stop))
                    for k, v in cols.items()})
            return HostXShards(out)
        if isinstance(first, dict):
            # dict shards with non-array leaves (lists, scalars): coerce and
            # merge like the reference did
            merged = {
                k: np.concatenate([np.asarray(p[k]) for p in parts])
                for k in first}
            total = len(nest.flatten(merged)[0])
            splits = np.array_split(np.arange(total), num_partitions)
            return HostXShards([
                {k: v[idx] for k, v in merged.items()} for idx in splits])
        try:
            import pandas as pd
            if isinstance(first, pd.DataFrame):
                sizes = [len(p) for p in parts]
                offs = np.zeros(len(sizes) + 1, np.int64)
                np.cumsum(sizes, out=offs[1:])
                out = []
                for start, stop in self._split_bounds(
                        int(offs[-1]), num_partitions):
                    pieces = []
                    for i, p in enumerate(parts):
                        lo = max(start - int(offs[i]), 0)
                        hi = min(stop - int(offs[i]), sizes[i])
                        if hi > lo:
                            pieces.append(p.iloc[lo:hi])
                    if not pieces:
                        out.append(first.iloc[0:0].reset_index(drop=True))
                    elif len(pieces) == 1:
                        out.append(pieces[0].reset_index(drop=True))
                    else:
                        out.append(pd.concat(pieces, ignore_index=True))
                return HostXShards(out)
        except ImportError:
            pass
        if isinstance(first, (list, np.ndarray)):
            flat = [x for p in parts for x in p]
            chunks = np.array_split(np.arange(len(flat)), num_partitions)
            return HostXShards([[flat[i] for i in idx] for idx in chunks])
        # opaque elements: round-robin regroup
        groups: List[List[Any]] = [[] for _ in range(num_partitions)]
        for i, p in enumerate(parts):
            groups[i % num_partitions].append(p)
        return HostXShards([g if len(g) != 1 else g[0] for g in groups])

    def partition_by(self, cols, num_partitions: Optional[int] = None
                     ) -> "HostXShards":
        """Hash-partition pandas-DataFrame shards by column values
        (reference: shard.py:295-340). Hashes and filters per input shard
        (row hashes are position-independent), so no merged full copy is
        built; output rows appear in the same order as the reference's
        merge-then-mask."""
        import pandas as pd
        dfs = [p for p in self._parts if isinstance(p, pd.DataFrame)]
        if len(dfs) != len(self._parts):
            raise ValueError("partition_by requires pandas DataFrame shards")
        if isinstance(cols, str):
            cols = [cols]
        n = num_partitions or self.num_partitions()
        assignments = _pmap(
            lambda df: pd.util.hash_pandas_object(
                df[cols], index=False).to_numpy() % n, dfs)
        out = []
        for i in range(n):
            pieces = [df[a == i] for df, a in zip(dfs, assignments)]
            out.append(pd.concat(pieces, ignore_index=True))
        return HostXShards(out)

    def unique(self) -> np.ndarray:
        """Distinct elements across all partitions (reference: shard.py:341;
        shards must be 1-D arrays/Series). Deduplicates per partition first
        so the cross-partition merge is over distinct values, not rows."""
        vals = _pmap(lambda p: np.unique(np.asarray(p)), self._parts)
        return np.unique(np.concatenate(vals))

    def split(self) -> List["HostXShards"]:
        """Split shards whose elements are tuples/lists of N parts into N
        XShards (reference: shard.py:360-388)."""
        lens = {len(p) for p in self._parts}
        if len(lens) != 1:
            raise ValueError("each shard must have the same number of elements")
        n = lens.pop()
        return [HostXShards([p[i] for p in self._parts]) for i in range(n)]

    def zip(self, other: "HostXShards") -> "HostXShards":
        """Pair partitions elementwise (reference: shard.py:389-412)."""
        if not isinstance(other, HostXShards):
            raise ValueError("zip requires another HostXShards")
        if self.num_partitions() != other.num_partitions():
            raise ValueError("XShards should have the same number of partitions")
        def _n(p):
            flat = nest.flatten(p)
            return len(flat[0]) if flat else 0
        for a, b in zip(self._parts, other._parts):
            if _n(a) != _n(b):
                raise ValueError(
                    "elements in corresponding partitions must count equal rows")
        return HostXShards(list(zip(self._parts, other._parts)))

    # --- persistence --------------------------------------------------------
    def save_pickle(self, path: str, batchSize: int = 10) -> "HostXShards":
        os.makedirs(path, exist_ok=True)
        for i in range(0, len(self._parts), batchSize):
            fname = os.path.join(path, f"part-{i // batchSize:05d}.pkl")
            with open(fname, "wb") as f:
                pickle.dump(self._parts[i:i + batchSize], f)
        return self

    # --- accessors ----------------------------------------------------------
    def __len__(self) -> int:
        def _count(p):
            flat = nest.flatten(p)
            leaf = flat[0] if flat else []
            try:
                return len(leaf)
            except TypeError:
                return 1
        return sum(_count(p) for p in self._parts)

    def __getitem__(self, key: str) -> "HostXShards":
        """Column/key selection on dict or DataFrame shards
        (reference: shard.py:432-442). Lazy like transform_shard — fused
        with any downstream transforms."""
        def get_data(p):
            return p[key]  # dict key or pandas column
        return HostXShards._lazy(self, (get_data, ()), transient=True)

    def _get_class_name(self) -> str:
        return type(self._parts[0]).__name__ if self._parts else "empty"

    def to_local(self) -> "HostXShards":
        return self

    def __repr__(self):
        return (f"HostXShards(num_partitions={self.num_partitions()}, "
                f"element={self._get_class_name()})")


# Source-compat alias: the reference exposes SparkXShards; existing user code
# that type-checks against the name keeps working.
SparkXShards = HostXShards


class SharedValue:
    """Broadcast-variable stand-in (reference: shard.py:472-485). On a single
    controller per host there is nothing to broadcast; kept for API parity."""

    def __init__(self, data):
        self._data = data
        self.id = uuid.uuid4().hex

    @property
    def value(self):
        return self._data

    def unpersist(self):
        self._data = None
