"""The port's XShards plane (analytics_zoo_tpu_torch/orca/data/{shard,
chunked}.py and the XShards paths of orca/learn/utils.py) against the JAX
package's, on the same numpy data. Everything here is host code, compared
exactly: gathers and slices are ``array_equal`` to indexing
``np.concatenate`` of the chunks, and batch streams are bit-identical to
the JAX package's ``BatchIterator._host_batches`` and to the stream over
the concatenated arrays. Predictions are compared at 1e-6 (f32 forward,
the same weights on both sides).
"""

import pickle

import numpy as np
import pandas as pd
import pytest
import torch
from torch import nn

from analytics_zoo_tpu.orca.data import HostXShards as JShards
from analytics_zoo_tpu.orca.data import XShards as JXShards
from analytics_zoo_tpu.orca.data.chunked import ChunkedArray as JChunked
from analytics_zoo_tpu.orca.learn import utils as jutils
from analytics_zoo_tpu_torch.common import context as tctx
from analytics_zoo_tpu_torch.orca.data import (HostXShards, SharedValue,
                                               SparkXShards, XShards)
from analytics_zoo_tpu_torch.orca.data.chunked import (ChunkedArray,
                                                       as_chunked)
from analytics_zoo_tpu_torch.orca.learn import utils as tutils
from analytics_zoo_tpu_torch.orca.learn.pytorch import Estimator
from analytics_zoo_tpu_torch.utils import nest


def _chunks(seed=0, sizes=(7, 1, 12, 5), tail=(3,), dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, *tail).astype(dtype) for n in sizes]


# --- ChunkedArray ----------------------------------------------------------------

GATHERS = {
    "shuffled": np.random.RandomState(1).permutation(25),
    "contiguous_in_chunk": np.arange(8, 14),
    "across_seams": np.arange(5, 22),
    "repeats_and_order": np.array([24, 0, 0, 7, 8, 7, 19]),
    "negative": np.array([-1, -25, -8, 3]),
    "bool_mask": np.random.RandomState(2).rand(25) > 0.5,
    "empty": np.array([], np.int64),
    "single": np.array([13]),
}


@pytest.mark.parametrize("case", sorted(GATHERS))
def test_chunked_gather_is_concatenate_indexing(case):
    """Each gather equals indexing the concatenation, and the JAX
    package's ChunkedArray, exactly; ``[]`` takes the same path."""
    chunks = _chunks()
    idx = GATHERS[case]
    want = np.concatenate(chunks)[idx]
    got = ChunkedArray(chunks).gather(idx)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, JChunked(chunks).gather(idx))
    np.testing.assert_array_equal(ChunkedArray(chunks)[idx], want)


@pytest.mark.parametrize("bounds", [(0, 25), (8, 14), (5, 22), (24, 30),
                                    (-3, 2), (10, 10), (0, 7)])
def test_chunked_slice_is_concatenate_slicing(bounds):
    chunks = _chunks(3)
    start, stop = bounds
    got = ChunkedArray(chunks).slice(start, stop)
    np.testing.assert_array_equal(
        got, np.concatenate(chunks)[max(start, 0):stop])
    np.testing.assert_array_equal(got, JChunked(chunks).slice(start, stop))


def test_chunked_views_scalars_and_errors():
    chunks = _chunks(4)
    ca = ChunkedArray(chunks)
    cat = np.concatenate(chunks)
    # an in-chunk range is a view of the chunk, not a copy
    assert ca.slice(9, 12).base is ca.chunks[2] or \
        np.shares_memory(ca.slice(9, 12), ca.chunks[2])
    np.testing.assert_array_equal(ca[::3], cat[::3])
    for i in (0, 7, 8, 24, -1, -25):
        np.testing.assert_array_equal(ca[i], cat[i])
    for bad in (25, -26):
        with pytest.raises(IndexError):
            ca[bad]
    for bad in (np.array([0, 25]), np.array([-26]), np.ones(24, bool)):
        with pytest.raises(IndexError):
            ca.gather(bad)
    assert (ca.shape, ca.ndim, ca.dtype, ca.nbytes, ca.num_chunks,
            len(ca)) == ((25, 3), 2, np.float32, cat.nbytes, 4, 25)
    mixed = ChunkedArray([np.arange(3, dtype=np.int32),
                          np.arange(2, dtype=np.float64)])
    np.testing.assert_array_equal(
        mixed.gather([4, 0]), np.concatenate(
            [np.arange(3, dtype=np.int32), np.arange(2.0)])[[4, 0]])
    assert as_chunked(ca) is ca and as_chunked(cat).num_chunks == 1
    assert ca.materializations == 0
    np.testing.assert_array_equal(np.asarray(ca), cat)
    assert ca.materializations == 1


def test_single_chunk_gather_uses_the_native_gather(monkeypatch):
    """One chunk: the shuffled gather goes through native.gather_rows (into
    the caller's buffer when it fits)."""
    from analytics_zoo_tpu_torch.native import runtime
    calls = []
    inner = runtime.gather_rows

    def spy(src, idx, *args, **kwargs):
        calls.append(len(idx))
        return inner(src, idx, *args, **kwargs)
    monkeypatch.setattr(runtime, "gather_rows", spy)
    a = np.random.RandomState(5).randn(40, 2).astype(np.float32)
    idx = np.random.RandomState(6).permutation(40)[:16]
    out = np.empty((16, 2), np.float32)
    got = ChunkedArray([a]).gather(idx, out=out)
    assert calls == [16] and got is out
    np.testing.assert_array_equal(got, a[idx])


# --- HostXShards --------------------------------------------------------------

def _cols(n=23, seed=7):
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(n, 2).astype(np.float32),
            "b": rng.randint(0, 9, n).astype(np.int32),
            "y": rng.randint(0, 2, n).astype(np.int64)}


def _assert_parts_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gl, wl = nest.flatten(g), nest.flatten(w)
        assert len(gl) == len(wl)
        for u, v in zip(gl, wl):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def test_partition_round_robin_matches_jax():
    data = _cols()
    got = XShards.partition(data, num_shards=4)
    want = JXShards.partition(data, num_shards=4)
    assert got.num_partitions() == 4
    _assert_parts_equal(got.collect(), want.collect())
    np.testing.assert_array_equal(got.collect()[1]["b"], data["b"][1::4])
    with pytest.raises(ValueError, match="exceeds"):
        XShards.partition(data, num_shards=24)


def test_partition_defaults_to_the_context_devices(monkeypatch):
    monkeypatch.setattr(tctx, "_current", None)
    ctx = tctx.init_orca_context(device="cpu")
    try:
        assert XShards.partition(_cols()).num_partitions() == \
            len(ctx.local_devices) == 1
    finally:
        tctx.stop_orca_context()


def test_lazy_transforms_fuse_and_run_each_stage_once():
    """Two chained transforms run once per partition in one fused pass,
    however many of the chain's nodes are read, as in the JAX package."""
    runs = {"double": 0, "shift": 0}

    def double(d):
        runs["double"] += 1
        return {k: v * 2 for k, v in d.items()}

    def shift(d):
        runs["shift"] += 1
        return {k: v + 1 for k, v in d.items()}
    for cls in (HostXShards, JShards):
        runs.update(double=0, shift=0)
        base = cls([{"v": np.arange(3)}, {"v": np.arange(3, 5)}])
        a = base.transform_shard(double)
        b = a.transform_shard(shift)
        assert runs == {"double": 0, "shift": 0}
        assert b.num_partitions() == 2 and runs["double"] == 0
        np.testing.assert_array_equal(b.collect()[1]["v"], [7, 9])
        a.collect()
        b.collect()
        assert runs == {"double": 2, "shift": 2}


@pytest.mark.parametrize("n", [1, 3, 5])
def test_repartition_matches_jax(n):
    data = _cols(29)
    got = XShards.partition(data, num_shards=4).repartition(n)
    want = JXShards.partition(data, num_shards=4).repartition(n)
    _assert_parts_equal(got.collect(), want.collect())
    assert len(got) == 29
    # each output partition is its own copy
    got.collect()[0]["a"][:] = 0
    assert XShards.partition(data, num_shards=4).collect()[0]["a"].any()


def test_split_zip_getitem_len_match_jax():
    parts = [(np.arange(4), np.arange(4) * 10), (np.arange(2), np.ones(2))]
    got = HostXShards(parts).split()
    want = JShards(parts).split()
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_parts_equal(g.collect(), w.collect())
    z = got[0].zip(got[1])
    _assert_parts_equal(z.collect(), want[0].zip(want[1]).collect())
    with pytest.raises(ValueError, match="equal rows"):
        got[0].zip(HostXShards([np.arange(4), np.arange(3)]))
    shards = XShards.partition(_cols(), num_shards=3)
    col = shards["b"]
    assert col.transient and not shards.transient
    _assert_parts_equal(col.collect(),
                        JXShards.partition(_cols(), num_shards=3)["b"]
                        .collect())
    assert len(shards) == len(col) == 23
    assert col.cache().is_cached() and not col.uncache().is_cached()
    assert shards.to_local() is shards and SparkXShards is HostXShards
    assert "num_partitions=3" in repr(shards)
    sv = SharedValue({"k": 1})
    assert sv.value == {"k": 1} and len(sv.id) == 32
    sv.unpersist()
    assert sv.value is None


def test_pickle_round_trip_both_ways(tmp_path):
    """save_pickle/load_pickle keep the partitions; each package reads the
    other's files; ``minPartitions`` repartitions."""
    shards = XShards.partition(_cols(), num_shards=4)
    shards.save_pickle(str(tmp_path / "port"), batchSize=3)
    JXShards.partition(_cols(), num_shards=4).save_pickle(
        str(tmp_path / "jax"), batchSize=3)
    for d in ("port", "jax"):
        back = XShards.load_pickle(str(tmp_path / d))
        _assert_parts_equal(back.collect(), shards.collect())
        _assert_parts_equal(JXShards.load_pickle(str(tmp_path / d))
                            .collect(), shards.collect())
    with open(tmp_path / "port" / "part-00000.pkl", "rb") as f:
        assert len(pickle.load(f)) == 3
    assert XShards.load_pickle(str(tmp_path / "port"),
                               minPartitions=6).num_partitions() == 6
    with pytest.raises(FileNotFoundError):
        XShards.load_pickle(str(tmp_path / "none"))


def _frames(n=20, seed=8):
    rng = np.random.RandomState(seed)
    df = pd.DataFrame({"f1": rng.randn(n).astype(np.float32),
                       "f2": rng.randint(0, 5, n).astype(np.int32),
                       "label": rng.randint(0, 3, n).astype(np.int64)})
    return [df.iloc[:7].reset_index(drop=True),
            df.iloc[7:].reset_index(drop=True)]


def test_pandas_partition_by_unique_and_repartition_match_jax():
    got = HostXShards(_frames())
    want = JShards(_frames())
    for g, w in zip(got.partition_by("f2", 3).collect(),
                    want.partition_by("f2", 3).collect()):
        pd.testing.assert_frame_equal(g, w)
    for g, w in zip(got.repartition(3).collect(),
                    want.repartition(3).collect()):
        pd.testing.assert_frame_equal(g, w)
    np.testing.assert_array_equal(got["f2"].unique(), want["f2"].unique())
    with pytest.raises(ValueError, match="DataFrame"):
        HostXShards([{"a": np.arange(2)}]).partition_by("a")


# --- normalize_xshards and the batch stream ----------------------------------

NORMALIZE = {
    "xy_dicts": (lambda: XShards.partition(
        {"x": _cols()["a"], "y": _cols()["y"]}, num_shards=3), None, None),
    "column_dicts": (lambda: XShards.partition(_cols(), num_shards=3),
                     ["a", "b"], ["y"]),
    "dataframes": (lambda: HostXShards(_frames()), ["f1", "f2"], ["label"]),
}


@pytest.mark.parametrize("case", sorted(NORMALIZE))
def test_normalize_xshards_matches_jax(case):
    make, feature_cols, label_cols = NORMALIZE[case]
    got = tutils.normalize_xshards(make(), feature_cols, label_cols)
    shards = make()
    want = jutils.normalize_xshards(
        JShards(shards.collect()), feature_cols, label_cols)
    _assert_parts_equal(got.collect(), want.collect())
    assert set(got.collect()[0]) == {"x", "y"}


def test_column_dicts_need_feature_cols():
    with pytest.raises(ValueError, match="feature_cols"):     # on read
        tutils.normalize_xshards(XShards.partition(_cols(), num_shards=2)
                                 ).collect()
    with pytest.raises(ValueError, match="feature_cols"):
        tutils.normalize_xshards(HostXShards(_frames()))


def _stream(batches):
    return [(tuple(np.asarray(a) for a in b.x),
             tuple(np.asarray(a) for a in b.y),
             None if b.w is None else np.asarray(b.w)) for b in batches]


def _assert_streams_equal(got, want):
    assert len(got) == len(want)
    for (gx, gy, gw), (wx, wy, ww) in zip(got, want):
        for u, v in zip(gx + gy, wx + wy):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)
        assert (gw is None) == (ww is None)
        if gw is not None:
            np.testing.assert_array_equal(gw, ww)


def test_four_partition_stream_matches_jax_and_the_concatenation(
        orca_context):
    """Two shuffled epochs at batch 16 over 4 round-robin partitions of 53
    rows (a padded tail): bit-identical to JAX's ``data_to_iterator``
    stream and to the stream over the partitions' concatenation; no
    leaf is ever materialised."""
    data = _cols(53, seed=9)
    shards = XShards.partition(data, num_shards=4)
    kw = dict(feature_cols=["a", "b"], label_cols=["y"], shuffle=True,
              seed=3)
    port = tutils.data_to_iterator(shards, 16, **kw)
    jax_it = jutils.data_to_iterator(JShards(shards.collect()), 16,
                                     orca_context.mesh, **kw)
    parts = shards.collect()
    cat = {k: np.concatenate([p[k] for p in parts]) for k in data}
    flat = tutils.data_to_iterator(
        {"x": (cat["a"], cat["b"]), "y": cat["y"]}, 16, shuffle=True, seed=3)
    assert [a.num_chunks for a in port.x] == [4, 4]
    for _ in range(2):
        got = _stream(port._host_batches(True))
        _assert_streams_equal(got, _stream(jax_it._host_batches(True)))
        _assert_streams_equal(got, _stream(flat._host_batches(True)))
    assert len(got) == 4 and got[-1][2].sum() == 5
    assert all(a.materializations == 0 for a in port.x + port.y)


def test_xshards_fit_and_evaluate_match_the_arrays(orca_context):
    """fit and evaluate over XShards with feature/label columns give the
    arrays' losses exactly (the same rows in the same order)."""
    data = _cols(40, seed=10)
    shards = XShards.partition(data, num_shards=4)
    parts = shards.collect()
    cat = {k: np.concatenate([p[k] for p in parts]) for k in data}

    def creator(cfg):
        torch.manual_seed(0)
        return nn.Sequential(nn.Linear(3, 8), nn.ReLU(), nn.Linear(8, 2))

    def run(fit_data, **cols):
        est = Estimator.from_torch(
            model_creator=creator,
            optimizer_creator=lambda m, cfg: torch.optim.SGD(
                m.parameters(), lr=0.1),
            loss_creator=nn.CrossEntropyLoss, device="cpu")
        stats = est.fit(fit_data, epochs=2, batch_size=16, verbose=False,
                        **cols)
        ev = est.evaluate(fit_data, batch_size=16, verbose=False, **cols)
        return [s["train_loss"] for s in stats], ev["loss"]

    def merged(d):
        out = dict(d)
        out["ab"] = np.concatenate(
            [d["a"], d["b"][:, None].astype(np.float32)], 1)
        return out
    merged_shards = shards.transform_shard(merged)
    got = run(merged_shards, feature_cols=["ab"], label_cols=["y"])
    want = run({"x": merged(cat)["ab"], "y": cat["y"]})
    assert got == want


def test_predict_returns_xshards_like_jax(orca_context):
    """predict over XShards returns the input's partitions with their rows'
    predictions under ``"prediction"``: equal to predict over the arrays,
    and to the JAX package's XShards from the same torch weights (1e-6)."""
    from analytics_zoo_tpu.orca.learn.pytorch import Estimator as JEstimator
    data = _cols(37, seed=11)
    shards = XShards.partition(data, num_shards=4)

    def creator(cfg):
        torch.manual_seed(0)
        return nn.Sequential(nn.Linear(2, 8), nn.Tanh(), nn.Linear(8, 3))
    est = Estimator.from_torch(model_creator=creator,
                               loss_creator=nn.CrossEntropyLoss,
                               device="cpu")
    jest = JEstimator.from_torch(model_creator=creator,
                                 loss_creator=nn.CrossEntropyLoss)
    got = est.predict(shards, batch_size=8, feature_cols=["a"])
    assert isinstance(got, HostXShards) and got.num_partitions() == 4
    cat = np.concatenate([p["a"] for p in shards.collect()])
    flat = est.predict(cat, batch_size=8)
    # the JAX estimator's first predict loads the torch weights through a
    # path that reads column dicts without feature_cols and raises, so it
    # predicts the arrays first
    np.testing.assert_allclose(jest.predict(cat, batch_size=8), flat,
                               rtol=1e-6, atol=1e-6)
    want = jest.predict(JShards(shards.collect()), batch_size=8,
                        feature_cols=["a"])
    assert flat.shape == (37, 3)
    np.testing.assert_array_equal(
        np.concatenate([p["prediction"] for p in got.collect()]), flat)
    for g, w, p in zip(got.collect(), want.collect(), shards.collect()):
        assert set(g) == set(w) == {"a", "b", "y", "prediction"}
        np.testing.assert_array_equal(g["b"], p["b"])
        np.testing.assert_allclose(g["prediction"], w["prediction"],
                                   rtol=1e-6, atol=1e-6)


def test_xshards_from_arrays_and_chunk_shards():
    x, y = np.arange(10.0).reshape(5, 2), np.arange(5)
    one = tutils.xshards_from_arrays({"x": x, "y": y})
    assert isinstance(one, HostXShards) and one.num_partitions() == 1
    assert one.collect()[0]["x"][0] is x      # no copy for one partition
    three = tutils.xshards_from_arrays((x, y), num_shards=3)
    want = jutils.xshards_from_arrays((x, y), num_shards=3)
    _assert_parts_equal(three.collect(), want.collect())
    chunked = tutils.chunk_shards(three)
    assert chunked["x"][0].num_chunks == 3
    np.testing.assert_array_equal(chunked["y"][0].slice(0, 5), y)
    with pytest.raises(ValueError, match="empty"):
        tutils.chunk_shards(HostXShards([]))
    bare = tutils.xshards_from_arrays(x)
    assert "y" not in bare.collect()[0]
