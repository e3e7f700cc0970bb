"""The port's ParquetDataset (``analytics_zoo_tpu_torch/orca/data/image/
parquet_dataset.py``) and ``TextSet.read_parquet`` against the JAX
package's, on the CPU.

* A dataset written by either package reads back in the other with equal
  arrays (``read_as_xshards``, ``read_as_torch``, ``read_as_tf``), for
  ``write``, ``write_ndarrays``, ``write_mnist`` (idx files, gzipped or
  not), ``write_from_directory`` and ``write_voc``.
* ``_orca_schema.pkl`` is the same bytes from both packages: the pickle
  names the JAX package's class, and the port reads it without importing
  the JAX package (checked in a fresh interpreter); any other class in a
  schema pickle is refused.
* The column-dict shards go through ``orca/learn/utils`` with
  ``feature_cols``/``label_cols`` as the JAX package's do, and a fit over
  them (uint8 images, int64 labels) trains as the JAX estimator does from
  the same weights: losses and parameters within rtol/atol 1e-4.
"""

import gzip
import json
import os
import struct
import subprocess
import sys
from functools import partial

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.feature.text import text_set as jts
from analytics_zoo_tpu.orca.data.image import parquet_dataset as jpq
from analytics_zoo_tpu.orca.learn import losses as jlosses
from analytics_zoo_tpu.orca.learn import utils as jutils
from analytics_zoo_tpu.orca.learn.estimator import TPUEstimator as JEstimator
from analytics_zoo_tpu.orca.learn.optimizers import optimizers_impl as jopt
from analytics_zoo_tpu_torch.feature.text import text_set as tts
from analytics_zoo_tpu_torch.orca.data import image as timage
from analytics_zoo_tpu_torch.orca.data.image import parquet_dataset as tpq
from analytics_zoo_tpu_torch.orca.learn import losses as tlosses
from analytics_zoo_tpu_torch.orca.learn import utils as tutils
from analytics_zoo_tpu_torch.orca.learn.estimator import \
    TPUEstimator as TEstimator
from analytics_zoo_tpu_torch.orca.learn.optimizers import \
    optimizers_impl as topt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIT_TOL = dict(rtol=1e-4, atol=1e-4)
PKGS = {"jax": jpq, "port": tpq}


def _shards(pkg, path):
    return pkg.ParquetDataset.read_as_xshards(path).collect()


def _equal_shards(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            if g[k].dtype == object:
                for a, b in zip(g[k], w[k]):
                    np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_array_equal(g[k], w[k])


def _records(n, seed=0):
    """Rows with a fixed-shape ndarray, a ragged image, an int and a
    string."""
    rng = np.random.RandomState(seed)
    for i in range(n):
        yield {"feat": rng.randn(3, 2).astype(np.float32),
               "img": rng.randint(0, 255, (rng.randint(2, 5), 4, 3),
                                  dtype=np.uint8),
               "label": int(rng.randint(10)),
               "name": f"row-{i}"}


def _schema(pkg):
    S = pkg.SchemaField
    return {"feat": S("ndarray", "float32", (3, 2)),
            "img": S("image", "uint8", ()),
            "label": S("scalar", "int64"),
            "name": S("scalar", "str")}


def _schema_bytes(path):
    with open(os.path.join(path, "_orca_schema.pkl"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("block_size", [7, 1000])
def test_write_reads_back_in_the_other_package(tmp_path, src, dst,
                                               block_size):
    path = str(tmp_path / "ds")
    PKGS[src].ParquetDataset.write(path, _records(23),
                                   _schema(PKGS[src]), block_size=block_size)
    assert sorted(os.listdir(path))[-1] == \
        f"part-{(23 - 1) // block_size:05d}.parquet"
    _equal_shards(_shards(PKGS[dst], path), _shards(PKGS[src], path))
    # read_as_torch concatenates the shards: a fixed-shape dataset
    PKGS[src].write_ndarrays(np.arange(23 * 6, dtype=np.float32).reshape(
        23, 3, 2), np.arange(23) % 5, path, block_size=block_size)
    got = PKGS[dst].ParquetDataset.read_as_torch(path)
    want = PKGS[src].ParquetDataset.read_as_torch(path)
    assert len(got) == len(want) == 23
    for i in (0, 11, 22):
        assert list(got[i]) == list(want[i])
        for k in want[i]:
            np.testing.assert_array_equal(got[i][k], want[i][k])


def test_schema_pickle_is_the_jax_bytes(tmp_path):
    """Same schema, same file: the bytes name the JAX package's class, and
    each package loads the other's file to equal fields."""
    cases = [_schema, lambda m: {"image": m.SchemaField("ndarray", "uint8",
                                                        (28, 28, 1)),
                                 "label": m.SchemaField("scalar", "int64")}]
    for make in cases:
        files = {}
        for name, pkg in PKGS.items():
            path = str(tmp_path / name)
            pkg.ParquetDataset.write(path, iter([]), make(pkg))
            files[name] = _schema_bytes(path)
        assert files["port"] == files["jax"]
        assert b"analytics_zoo_tpu.orca.data.image.parquet_dataset" in \
            files["port"]
        for src, dst in (("jax", "port"), ("port", "jax")):
            back = PKGS[dst].ParquetDataset._load_schema(str(tmp_path / src))
            assert {k: vars(v) for k, v in back.items()} == {
                k: vars(v) for k, v in make(PKGS[dst]).items()}
            assert all(type(v) is PKGS[dst].SchemaField
                       for v in back.values())


def test_schema_pickle_refuses_other_classes(tmp_path):
    """Only SchemaField resolves: a pickle naming another global (here
    ``os.system``) is refused, not called."""
    import pickle

    class Evil:
        def __reduce__(self):
            return (os.system, ("echo pwned",))

    path = tmp_path / "ds"
    path.mkdir()
    (path / "_orca_schema.pkl").write_bytes(pickle.dumps({"x": Evil()}))
    with pytest.raises(pickle.UnpicklingError, match="system"):
        tpq.ParquetDataset._load_schema(str(path))


def test_jax_written_dataset_reads_without_the_jax_package(tmp_path):
    """The port reads a JAX-written dataset in an interpreter that never
    imports ``analytics_zoo_tpu``."""
    path = str(tmp_path / "ds")
    jpq.write_ndarrays(np.arange(2 * 4 * 4, dtype=np.uint8).reshape(2, 4, 4),
                       np.array([3, 5]), path)
    code = (
        "import sys, json\n"
        "from analytics_zoo_tpu_torch.orca.data.image import "
        "ParquetDataset\n"
        f"s = ParquetDataset.read_as_xshards({path!r}).collect()[0]\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('analytics_zoo_tpu', 'jax', 'flax')]\n"
        "print(json.dumps([bad, s['image'].tolist(), s['label'].tolist(),\n"
        "                  type(ParquetDataset._load_schema(\n"
        f"                      {path!r})['image']).__module__]))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    bad, image, label, module = json.loads(proc.stdout.splitlines()[-1])
    assert bad == []
    assert image == np.arange(32).reshape(2, 4, 4).tolist()
    assert label == [3, 5]
    assert module == "analytics_zoo_tpu_torch.orca.data.image." \
        "parquet_dataset"


def _idx_files(root, n, gz):
    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (n, 6, 5), dtype=np.uint8)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    opener = gzip.open if gz else open
    ext = ".gz" if gz else ""
    img, lab = os.path.join(root, "img" + ext), os.path.join(root,
                                                             "lab" + ext)
    with opener(img, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 6, 5) + images.tobytes())
    with opener(lab, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return img, lab, images, labels


@pytest.mark.parametrize("gz", [False, True], ids=["idx", "idx-gz"])
def test_write_mnist_equals_jax(tmp_path, gz):
    img, lab, images, labels = _idx_files(str(tmp_path), 30, gz)
    for name, pkg in PKGS.items():
        pkg.write_mnist(img, lab, str(tmp_path / name), block_size=8)
    assert _schema_bytes(str(tmp_path / "port")) == \
        _schema_bytes(str(tmp_path / "jax"))
    got = _shards(tpq, str(tmp_path / "port"))
    _equal_shards(got, _shards(jpq, str(tmp_path / "jax")))
    np.testing.assert_array_equal(
        np.concatenate([s["image"] for s in got]), images[..., None])
    np.testing.assert_array_equal(
        np.concatenate([s["label"] for s in got]), labels)
    bad = str(tmp_path / "bad")
    with open(bad, "wb") as f:
        f.write(struct.pack(">II", 1234, 30) + labels.tobytes())
    for pair in ((img, bad), (bad, lab)):
        with pytest.raises(ValueError, match="magic 1234"):
            tpq.write_mnist(*pair, str(tmp_path / "x"))


def test_write_from_directory_and_voc_equal_jax(tmp_path):
    rng = np.random.RandomState(2)
    root = tmp_path / "imgs"
    for cat in ("cat", "dog"):
        (root / cat).mkdir(parents=True)
        for i in range(3):
            (root / cat / f"{i}.bin").write_bytes(
                rng.bytes(int(rng.randint(5, 20))))
    voc = tmp_path / "VOCdevkit" / "VOC2007"
    for sub in ("ImageSets/Main", "Annotations", "JPEGImages"):
        (voc / sub).mkdir(parents=True)
    (voc / "ImageSets/Main/train.txt").write_text("a\nb\n")
    for img_id, boxes in (("a", [(1, 2, 3, 4)]),
                          ("b", [(5, 6, 7, 8), (0, 1, 2, 3)])):
        objs = "".join(
            f"<object><name>c{i}</name><bndbox><xmin>{x1}</xmin>"
            f"<ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax>"
            f"</bndbox></object>" for i, (x1, y1, x2, y2) in enumerate(boxes))
        (voc / f"Annotations/{img_id}.xml").write_text(
            f"<annotation>{objs}</annotation>")
        (voc / f"JPEGImages/{img_id}.jpg").write_bytes(rng.bytes(9))
    for name, pkg in PKGS.items():
        pkg.write_from_directory(str(root), {"cat": 0, "dog": 1},
                                 str(tmp_path / f"dir-{name}"))
        pkg.write_voc(str(tmp_path / "VOCdevkit"), [("2007", "train")],
                      str(tmp_path / f"voc-{name}"))
    for kind in ("dir", "voc"):
        port, jax_ = (str(tmp_path / f"{kind}-{n}") for n in ("port", "jax"))
        assert _schema_bytes(port) == _schema_bytes(jax_)
        _equal_shards(_shards(tpq, port), _shards(jpq, jax_))


def test_read_as_tf_equals_jax(tmp_path):
    pytest.importorskip("tensorflow")
    path = str(tmp_path / "ds")
    tpq.write_ndarrays(np.arange(24, dtype=np.float32).reshape(4, 3, 2),
                       np.arange(4), path)
    got = list(tpq.ParquetDataset.read_as_tf(path).as_numpy_iterator())
    want = list(jpq.ParquetDataset.read_as_tf(path).as_numpy_iterator())
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_package_exports_the_parquet_names():
    for name in ("ParquetDataset", "SchemaField", "write_from_directory",
                 "write_mnist", "write_ndarrays", "write_voc"):
        assert getattr(timage, name) is getattr(tpq, name)


def test_textset_read_parquet_equals_jax(tmp_path):
    import pandas as pd
    texts = ["héllo wörld", "", "a, b; c.", "line\nbreak", "x" * 300]
    path = str(tmp_path / "t.parquet")
    pd.DataFrame({"uri": [f"doc/{i}" for i in range(len(texts))],
                  "text": texts}).to_parquet(path)
    got, want = tts.TextSet.read_parquet(path), jts.TextSet.read_parquet(path)
    assert got.get_texts() == want.get_texts() == texts
    assert got.get_uris() == want.get_uris()


# --- column-dict shards into a fit -------------------------------------------------

def _logits_loss(losses):
    return partial(losses.sparse_categorical_crossentropy, from_logits=True)


class _JaxDigits(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        x = x.reshape(x.shape[0], -1).astype(jnp.float32) / 255.0
        return fnn.Dense(10)(x)


class _Digits(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = torch.nn.Linear(6 * 5, 10)

    def forward(self, x):
        return self.dense(x.reshape(x.shape[0], -1).float() / 255.0)


def test_dict_shards_normalize_as_jax(tmp_path):
    path = str(tmp_path / "ds")
    img, lab, _, _ = _idx_files(str(tmp_path), 20, False)
    tpq.write_mnist(img, lab, path, block_size=6)
    kw = dict(feature_cols=["image"], label_cols=["label"])
    got = tutils.normalize_xshards(
        tpq.ParquetDataset.read_as_xshards(path), **kw).collect()
    want = jutils.normalize_xshards(
        jpq.ParquetDataset.read_as_xshards(path), **kw).collect()
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for key in ("x", "y"):
            assert len(g[key]) == len(w[key]) == 1
            np.testing.assert_array_equal(g[key][0], w[key][0])
    with pytest.raises(ValueError, match="feature_cols"):
        tutils.normalize_xshards(
            tpq.ParquetDataset.read_as_xshards(path)).collect()


def test_fit_over_parquet_shards_matches_jax(orca_context, tmp_path):
    """``read_as_xshards`` into both estimators with ``feature_cols``/
    ``label_cols``: 2 epochs of SGD, unshuffled, from the same weights."""
    path = str(tmp_path / "ds")
    img, lab, _, _ = _idx_files(str(tmp_path), 40, False)
    jpq.write_mnist(img, lab, path, block_size=16)
    jest = JEstimator(_JaxDigits(), loss=_logits_loss(jlosses),
                      optimizer=jopt.SGD(learningrate=0.5),
                      config={"steps_per_dispatch": 1})
    jest.engine.build((np.zeros((1, 6, 5, 1), np.uint8),))
    params = jax.device_get(jest.engine.params)["Dense_0"]
    module = _Digits()
    with torch.no_grad():
        module.dense.weight.copy_(torch.from_numpy(
            np.asarray(params["kernel"]).T.copy()))
        module.dense.bias.copy_(torch.from_numpy(np.asarray(params["bias"])))
    test = TEstimator(module, loss=_logits_loss(tlosses),
                      optimizer=topt.SGD(learningrate=0.5), device="cpu",
                      config={"steps_per_dispatch": 1})
    kw = dict(epochs=2, batch_size=8, feature_cols=["image"],
              label_cols=["label"], shuffle=False, verbose=False)
    js = jest.fit(jpq.ParquetDataset.read_as_xshards(path), **kw)
    ts = test.fit(tpq.ParquetDataset.read_as_xshards(path), **kw)
    np.testing.assert_allclose([s["train_loss"] for s in ts],
                               [s["train_loss"] for s in js], **FIT_TOL)
    params = jax.device_get(jest.engine.params)["Dense_0"]
    np.testing.assert_allclose(module.dense.weight.detach().numpy(),
                               np.asarray(params["kernel"]).T, **FIT_TOL)
    np.testing.assert_allclose(module.dense.bias.detach().numpy(),
                               np.asarray(params["bias"]), **FIT_TOL)

