"""The port's streaming ImageNet pipeline (analytics_zoo_tpu_torch/orca/data/
image/imagenet.py) against the JAX package's, on the CPU.

The batch stream is held bit for bit (``array_equal``): the synthetic
shards, ``_host_batches`` per seed over two epochs (shuffled and not, train
crops and flips, eval center crop), the pump's batches against the inline
ones, and the batches each epoch of a ``fit`` trains on in both packages.
"""

import os

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.orca.data.image import imagenet as jimagenet
from analytics_zoo_tpu_torch.native.infeed import PipelineStats
from analytics_zoo_tpu_torch.orca.data.image import imagenet as timagenet
from analytics_zoo_tpu_torch.orca.learn import utils as tutils

from test_torch_ncf import native_runtimes_built

IMAGES, SIZE, CROP, BATCH = 40, 20, 16, 8


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("imagenet"))
    timagenet.write_synthetic_imagenet(root, IMAGES, image_size=SIZE,
                                       num_classes=10, shard_size=16,
                                       seed=3)
    return root


def _batches(batches):
    return [(np.asarray(b.x[0]), np.asarray(b.y[0]), b.w) for b in batches]


def _assert_same(got, want):
    assert len(got) == len(want)
    for (gx, gy, gw), (wx, wy, ww) in zip(got, want):
        assert gx.dtype == wx.dtype == np.uint8
        assert gy.dtype == wy.dtype == np.int32
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
        assert gw is None and ww is None


def test_synthetic_shards_same_bytes(tmp_path):
    kw = dict(num_images=21, image_size=12, num_classes=7, shard_size=8,
              seed=5)
    jimagenet.write_synthetic_imagenet(str(tmp_path / "j"), **kw)
    timagenet.write_synthetic_imagenet(str(tmp_path / "t"), **kw)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t"))
    assert len(names) == 6                      # 3 shards, images + labels
    for name in names:
        assert (open(tmp_path / "j" / name, "rb").read()
                == open(tmp_path / "t" / name, "rb").read())
    assert timagenet.IMAGENET_MEAN == jimagenet.IMAGENET_MEAN
    assert timagenet.IMAGENET_STD == jimagenet.IMAGENET_STD


@pytest.mark.parametrize("train,shuffle", [(True, True), (True, False),
                                           (False, False)])
def test_host_batches_match_jax(orca_context, shards, train, shuffle):
    """Two epochs of ``_host_batches`` per seed: the same rows, crops,
    flips and labels, and the same epoch counters."""
    assert native_runtimes_built()
    for seed in (0, 11):
        jpipe = jimagenet.ImageNetPipeline(shards, BATCH, orca_context.mesh,
                                           crop_size=CROP, train=train,
                                           seed=seed)
        tpipe = timagenet.ImageNetPipeline(shards, BATCH, crop_size=CROP,
                                           train=train, seed=seed)
        assert (tpipe.n, tpipe.local_bs, tpipe.steps_per_epoch) == \
            (jpipe.n, jpipe.local_bs, jpipe.steps_per_epoch) == (40, 8, 5)
        epochs = []
        for _ in range(2):
            want = _batches(jpipe._host_batches(shuffle))
            got = _batches(tpipe._host_batches(shuffle))
            _assert_same(got, want)
            epochs.append(got)
        assert tpipe._epoch_idx == jpipe._epoch_idx == 2
        tpipe.close()
        if train:       # the two epochs differ: crops (and order) move on
            assert not np.array_equal(epochs[0][0][0], epochs[1][0][0])
        else:           # eval: the center crop, every epoch alike
            _assert_same(epochs[1], epochs[0])
            src = np.load(os.path.join(shards, "shard-00000-images.npy"))
            off = (SIZE - CROP) // 2
            np.testing.assert_array_equal(
                epochs[0][0][0][0], src[0, off:off + CROP, off:off + CROP])


def test_drop_remainder_and_ragged_tail(orca_context, shards):
    """Without drop_remainder the ragged tail counts a step but, as in the
    JAX package, is never yielded."""
    kw = dict(crop_size=CROP, drop_remainder=False)
    jpipe = jimagenet.ImageNetPipeline(shards, 16, orca_context.mesh, **kw)
    tpipe = timagenet.ImageNetPipeline(shards, 16, **kw)
    assert tpipe.steps_per_epoch == jpipe.steps_per_epoch == 3
    _assert_same(_batches(tpipe._host_batches(True)),
                 _batches(jpipe._host_batches(True)))
    with pytest.raises(ValueError, match="local batch"):
        timagenet.ImageNetPipeline(shards, 64)


@pytest.mark.parametrize("prefetch", [True, False])
def test_device_epochs_match_host_batches(shards, prefetch):
    """The pump (4 assembly workers running tasks out of order) and the
    inline path deliver the host stream's batches, in order, on the
    device; the stats count both stages."""
    stats = PipelineStats()
    pipe = timagenet.ImageNetPipeline(shards, BATCH, crop_size=CROP,
                                      device="cpu")
    ref = timagenet.ImageNetPipeline(shards, BATCH, crop_size=CROP)
    pipe.stats, pipe.prefetch_workers = stats, 4
    for _ in range(2):
        got = list(pipe.epoch(prefetch=prefetch))
        assert all(isinstance(b.x[0], torch.Tensor) for b in got)
        _assert_same(_batches(got), _batches(ref._host_batches(True)))
    snap = stats.snapshot()
    assert snap["assemble_s"] > 0 and snap["h2d_s"] > 0
    pipe.close()
    ref.close()


def test_device_rule_and_front_door(shards, monkeypatch):
    """``epoch`` runs on the card unless given the CPU (and raises without
    a GPU); ``data_to_iterator`` passes a pipeline through with the
    estimator's device and stats."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pipe = timagenet.ImageNetPipeline(shards, BATCH, crop_size=CROP)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipe.epoch()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        timagenet.ImageNetPipeline(shards, BATCH, device="cuda")
    stats = PipelineStats()
    it = tutils.data_to_iterator(pipe, 99, device=torch.device("cpu"),
                                 stats=stats)
    assert it is pipe and pipe.device == torch.device("cpu")
    assert pipe.stats is stats
    assert len(list(pipe.epoch())) == pipe.steps_per_epoch
