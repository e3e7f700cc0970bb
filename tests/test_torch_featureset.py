"""The port's disk-tier FeatureSet and TFRecord reader
(``analytics_zoo_tpu_torch/feature/feature_set.py``,
``orca/data/tfrecord.py``) on the CPU against the JAX package's: the npy
cache byte for byte, the batch stream bit for bit for each seed under row
and shard striping (process 0 of 1 and 1 of 3, two epochs, each package
reading the other's cache), the striping errors, a disk-tier ``fit`` of
two epochs against the JAX ``TPUEstimator.fit`` on the same stream, the
DRAM tier, the TFRecord round trip with its CRC checks, wire compatibility
with TensorFlow, and ``from_tfrecords``.

Batch sizes are multiples of 8: the JAX ``DiskFeatureSet`` rounds its
local batch up to the conftest's 8-device mesh, the port's has no mesh."""

import filecmp
import os

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.feature import feature_set as jfs
from analytics_zoo_tpu.orca.data import tfrecord as jtfr
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.feature import feature_set as tfs
from analytics_zoo_tpu_torch.native import transfer as xfer
from analytics_zoo_tpu_torch.orca.data import tfrecord as ttfr
from analytics_zoo_tpu_torch.orca.data.shard import HostXShards
from analytics_zoo_tpu_torch.orca.learn.utils import BatchIterator

N, SHARD, BATCH = 1000, 96, 48
FIT_TOL = dict(rtol=1e-5, atol=1e-6)


def _data(n=N, seed=0):
    rng = np.random.RandomState(seed)
    return {"x": (rng.rand(n, 3).astype(np.float32),
                  rng.randint(0, 50, n).astype(np.int32)),
            "y": rng.randint(0, 2, n).astype(np.int32)}


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """The same columns spooled by each package."""
    root = tmp_path_factory.mktemp("caches")
    jdir, tdir = str(root / "jax"), str(root / "port")
    jfs.DiskFeatureSet.write(_data(), jdir, shard_size=SHARD)
    tfs.DiskFeatureSet.write(_data(), tdir, shard_size=SHARD)
    return jdir, tdir


def test_cache_is_byte_equal(caches):
    jdir, tdir = caches
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    assert len(names) == 1 + 3 * -(-N // SHARD)
    match, mismatch, errors = filecmp.cmpfiles(jdir, tdir, names,
                                               shallow=False)
    assert (mismatch, errors) == ([], []) and match == names


def _leaves(batch):
    return list(batch.x) + list(batch.y or ())


@pytest.mark.parametrize("stripe", ["row", "shard"])
@pytest.mark.parametrize("pid,nproc", [(0, 1), (1, 3)])
def test_batch_stream_matches_jax(orca_context, caches, stripe, pid, nproc):
    """Two shuffled epochs and an unshuffled one: the port over the JAX
    package's cache emits the JAX stream over the port's cache, leaf for
    leaf, bit for bit (the same dtypes: nothing here narrows)."""
    jdir, tdir = caches
    jset = jfs.DiskFeatureSet(tdir, orca_context.mesh, BATCH, seed=3,
                              stripe=stripe, _pid=pid, _nproc=nproc)
    tset = tfs.DiskFeatureSet(jdir, None, BATCH, seed=3, stripe=stripe,
                              _pid=pid, _nproc=nproc)
    assert (tset.local_bs, tset.global_bs, tset.steps_per_epoch) == (
        jset.local_bs, jset.global_bs, jset.steps_per_epoch)
    assert tset.shard_assignment == jset.shard_assignment
    for shuffle in (True, True, False):
        jb = list(jset._host_batches(shuffle))
        tb = list(tset._host_batches(shuffle))
        assert len(tb) == len(jb) == tset.steps_per_epoch
        for a, b in zip(jb, tb):
            assert b.w is None and a.w is None
            for u, v in zip(_leaves(a), _leaves(b)):
                assert v.dtype == u.dtype and np.array_equal(v, u)


def test_wide_leaves_are_narrowed_on_the_wire(tmp_path):
    """An int64 / float64 cache streams as int32 / float32 (the port's
    wire rule, as the in-memory batches), the same rows."""
    d = str(tmp_path / "wide")
    x = np.arange(200, dtype=np.int64)
    tfs.DiskFeatureSet.write({"x": x, "y": x * 0.5}, d, shard_size=64)
    ds = tfs.DiskFeatureSet(d, None, 40, seed=1)
    for b in ds._host_batches(True):
        assert (b.x[0].dtype, b.y[0].dtype) == (np.int32, np.float32)
        np.testing.assert_array_equal(b.y[0], b.x[0] * 0.5)


def _error(make):
    with pytest.raises(ValueError) as info:
        make()
    return str(info.value)


def test_striping_errors_match_jax(orca_context, tmp_path):
    """The unknown stripe mode, a shard stripe too small for one local
    batch, and fewer rows than one global batch: the same errors."""
    d = str(tmp_path / "small")
    tfs.DiskFeatureSet.write(_data(300), d, shard_size=100)
    mesh = orca_context.mesh
    for kw in (dict(batch_size=48, stripe="block"),
               dict(batch_size=48, stripe="shard", _pid=0, _nproc=4),
               dict(batch_size=400)):
        b = kw.pop("batch_size")
        want = _error(lambda: jfs.DiskFeatureSet(d, mesh, b, **kw))
        assert _error(lambda: tfs.DiskFeatureSet(d, None, b, **kw)) == want
    assert "rows < global batch 400" in want


def test_mesh_raises_naming_a10(tmp_path):
    d = str(tmp_path / "c")
    tfs.DiskFeatureSet.write(_data(100), d)
    with pytest.raises(NotImplementedError, match="A10"):
        tfs.DiskFeatureSet(d, object(), 8)
    with pytest.raises(NotImplementedError, match="A10"):
        tfs.FeatureSet.from_arrays(_data(100), tier="disk", mesh=object())


def test_tiers_and_their_errors_match_jax(orca_context, tmp_path):
    """``tier="dram"`` is the shuffled in-memory iterator (its stream the
    JAX one's); ``"disk..."`` a DiskFeatureSet owning a temporary cache it
    removes on ``cleanup``; an unknown tier raises the same error."""
    data = _data(200)
    jit = jfs.FeatureSet.from_arrays(data, tier="dram", batch_size=32,
                                     seed=5)
    tit = tfs.FeatureSet.from_arrays(data, tier="DRAM", batch_size=32,
                                     seed=5)
    assert isinstance(tit, BatchIterator) and tit.shuffle
    for a, b in zip(jit._host_batches(True), tit._host_batches(True)):
        for u, v in zip(_leaves(a), _leaves(b)):
            np.testing.assert_array_equal(v, u)
    disk = tfs.FeatureSet.from_arrays(data, tier="disk_2", batch_size=32)
    assert isinstance(disk, tfs.DiskFeatureSet) and os.path.isdir(
        disk.cache_dir)
    disk.cleanup()
    assert not os.path.exists(disk.cache_dir)
    want = _error(lambda: jfs.FeatureSet.from_arrays(data, tier="pmem"))
    assert _error(lambda: tfs.FeatureSet.from_arrays(data,
                                                     tier="pmem")) == want


class _JNet(fnn.Module):
    @fnn.compact
    def __call__(self, a, b):
        h = fnn.relu(fnn.Dense(16)(a + b[:, None] / 50.0))
        return fnn.sigmoid(fnn.Dense(1)(h))[..., 0]


class _TNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = torch.nn.Linear(3, 16)
        self.Dense_1 = torch.nn.Linear(16, 1)

    def forward(self, a, b):
        h = torch.relu(self.Dense_0(a + b[:, None] / 50.0))
        return torch.sigmoid(self.Dense_1(h))[..., 0]


def test_disk_fit_matches_jax(orca_context, caches):
    """``TPUEstimator.fit`` over each package's DiskFeatureSet of the same
    cache, two epochs of full batches (``w=None``), SGD from bridged
    weights: the per-epoch losses and the final weights, then
    ``evaluate`` over the sets' unshuffled stream, at FIT_TOL."""
    from analytics_zoo_tpu.orca.learn.estimator import \
        TPUEstimator as JEstimator
    from analytics_zoo_tpu.orca.learn.optimizers import SGD as JSGD
    from analytics_zoo_tpu_torch.orca.learn.estimator import \
        TPUEstimator as TEstimator
    from analytics_zoo_tpu_torch.orca.learn.optimizers import SGD as TSGD
    jdir, tdir = caches
    jest = JEstimator(_JNet(), loss="binary_crossentropy",
                      optimizer=JSGD(learningrate=0.5))
    x = _data()["x"]
    jest.engine.build((x[0][:1], x[1][:1]))
    tnet = interop.load_flax_params(_TNet(),
                                    jax.device_get(jest.engine.params))
    test = TEstimator(tnet, loss="binary_crossentropy",
                      optimizer=TSGD(learningrate=0.5), device="cpu")
    jset = jfs.DiskFeatureSet(jdir, orca_context.mesh, 128, seed=2)
    tset = tfs.DiskFeatureSet(tdir, None, 128, seed=2)
    jstats = jest.fit(jset, epochs=2, batch_size=128, verbose=False)
    tstats = test.fit(tset, epochs=2, batch_size=128, verbose=False)
    assert test.fuse == 1
    np.testing.assert_allclose([s["train_loss"] for s in tstats],
                               [s["train_loss"] for s in jstats], **FIT_TOL)
    want = interop.flax_to_state_dict(jax.device_get(jest.engine.params))
    got = test.get_model()
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   err_msg=key, **FIT_TOL)
    # the set's own stats: two epochs and the batch fit draws first
    stages = test.data_pipeline_stats()
    assert stages["assemble_n"] == stages["h2d_n"] == \
        2 * tset.steps_per_epoch + 1
    jev = jest.evaluate(jset, batch_size=128, verbose=False)
    tev = test.evaluate(tset, batch_size=128, verbose=False)
    assert tev["num_samples"] == jev["num_samples"] == 7 * 128
    np.testing.assert_allclose(tev["loss"], jev["loss"], **FIT_TOL)


# --- TFRecords -----------------------------------------------------------------

def _examples(n=300):
    rng = np.random.RandomState(1)
    return [{"feat": rng.rand(4).astype(np.float32),
             "label": np.asarray([i % 2], np.int64),
             "name": f"row-{i}"} for i in range(n)]


def test_tfrecord_files_equal_jax_and_round_trip(tmp_path):
    """The port writes the JAX writer's bytes, reads back what it wrote,
    and decodes as the JAX reader does."""
    tpath, jpath = str(tmp_path / "t.tfrecord"), str(tmp_path / "j.tfrecord")
    assert ttfr.write_tfrecords(tpath, iter(_examples())) == 300
    jtfr.write_tfrecords(jpath, iter(_examples()))
    assert filecmp.cmp(tpath, jpath, shallow=False)
    back = list(ttfr.read_examples(tpath, verify_crc=True))
    want = list(jtfr.read_examples(jpath, verify_crc=True))
    assert len(back) == len(want) == 300
    for b, w, e in zip(back, want, _examples()):
        assert b["name"] == w["name"] == [e["name"].encode()]
        np.testing.assert_array_equal(b["feat"], e["feat"])
        np.testing.assert_array_equal(b["label"], w["label"])


@pytest.mark.parametrize("where,what", [(3, "length"), (20, "data")])
def test_corrupt_crc_is_detected(tmp_path, where, what):
    """A flipped byte in the length or the payload fails its CRC under
    ``verify_crc``."""
    path = str(tmp_path / "c.tfrecord")
    ttfr.write_records(path, iter([b"payload-bytes-0123456789"] * 2))
    raw = bytearray(open(path, "rb").read())
    raw[where] ^= 0x01
    open(path, "wb").write(bytes(raw))
    with pytest.raises(IOError, match=f"corrupt {what} crc"):
        list(ttfr.read_records(path, verify_crc=True))


def test_wire_compat_with_tensorflow(tmp_path):
    """TensorFlow's records parse here and ours parse in TensorFlow (this
    host has TF; the card's machine does not, so this stays on the
    CPU)."""
    tf = pytest.importorskip("tensorflow")
    theirs = str(tmp_path / "tf.tfrecord")
    with tf.io.TFRecordWriter(theirs) as w:
        for i in range(5):
            ex = tf.train.Example(features=tf.train.Features(feature={
                "x": tf.train.Feature(float_list=tf.train.FloatList(
                    value=[1.5 * i, 2.5 * i])),
                "y": tf.train.Feature(int64_list=tf.train.Int64List(
                    value=[i, -i])),
                "s": tf.train.Feature(bytes_list=tf.train.BytesList(
                    value=[f"v{i}".encode()]))}))
            w.write(ex.SerializeToString())
    mine = list(ttfr.read_examples(theirs, verify_crc=True))
    assert len(mine) == 5
    np.testing.assert_allclose(mine[2]["x"], [3.0, 5.0])
    np.testing.assert_array_equal(mine[2]["y"], [2, -2])
    assert mine[2]["s"] == [b"v2"]
    ours = str(tmp_path / "ours.tfrecord")
    ttfr.write_tfrecords(ours, iter([{"x": np.asarray([7.0, 8.0],
                                                      np.float32),
                                      "y": np.asarray([9, -9], np.int64),
                                      "s": b"hello"}]))
    [raw] = [r.numpy() for r in tf.data.TFRecordDataset(ours)]
    parsed = tf.io.parse_single_example(raw, {
        "x": tf.io.FixedLenFeature([2], tf.float32),
        "y": tf.io.FixedLenFeature([2], tf.int64),
        "s": tf.io.FixedLenFeature([], tf.string)})
    np.testing.assert_allclose(parsed["x"].numpy(), [7.0, 8.0])
    np.testing.assert_array_equal(parsed["y"].numpy(), [9, -9])
    assert parsed["s"].numpy() == b"hello"


def test_from_tfrecords_matches_jax(orca_context, tmp_path):
    """A TFRecord corpus -> XShards -> a disk-tier FeatureSet: the same
    XShards, the same cache bytes and the same batches as the JAX
    package's."""
    path = str(tmp_path / "train.tfrecord")
    ttfr.write_tfrecords(path, iter(_examples()))
    kw = dict(feature_cols=["feat"], label_cols=["label"])
    tsh = ttfr.read_tfrecords_as_xshards(path, shard_size=128, **kw)
    jsh = jtfr.read_tfrecords_as_xshards(path, shard_size=128, **kw)
    assert isinstance(tsh, HostXShards)
    assert tsh.num_partitions() == jsh.num_partitions() == 3
    for a, b in zip(jsh.collect(), tsh.collect()):
        for k in ("x", "y"):
            for u, v in zip(a[k], b[k]):
                np.testing.assert_array_equal(v, u)
    tset = tfs.FeatureSet.from_tfrecords(
        path, tier="disk", batch_size=64, shard_size=100,
        cache_dir=str(tmp_path / "tcache"), **kw)
    jset = jfs.FeatureSet.from_tfrecords(
        path, tier="disk", mesh=orca_context.mesh, batch_size=64,
        shard_size=100, cache_dir=str(tmp_path / "jcache"), **kw)
    names = sorted(os.listdir(tset.cache_dir))
    assert filecmp.cmpfiles(tset.cache_dir, jset.cache_dir, names,
                            shallow=False)[0] == names
    tb = list(tset._host_batches(shuffle=False))
    jb = list(jset._host_batches(shuffle=False))
    assert len(tb) == len(jb) == 300 // 64
    assert tb[0].x[0].shape == (64, 4) and tb[0].y[0].shape == (64,)
    for a, b in zip(jb, tb):
        for u, v in zip(_leaves(a), _leaves(b)):
            np.testing.assert_array_equal(v, xfer.narrow_wire(u))
