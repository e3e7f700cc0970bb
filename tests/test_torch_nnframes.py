"""NNFrames (``pipeline/nnframes``), the pandas readers
(``orca/data/pandas``) and ``Estimator.from_keras`` of the port against
the JAX package's, on the CPU.

The slice as a whole: BASELINE #3's fraud-detection MLP, narrowed (29
features -> 32 -> 16 -> 1, ReLU, sigmoid), written with each package's
Keras API, trained by ``NNEstimator(...).fit(df)`` and scored by
``NNModel.transform``. The JAX estimator's flax init (seed 0) is bridged
into the port's module; both shuffle with the native runtime, so the
batch stream is the same bit for bit (checked), and the predictions and
final weights agree at rtol/atol 2e-4 (f32, TF32 off, JAX at
``highest``; tests/test_torch_estimator.py's tolerance). The readers are
host code and compared exactly.
"""

import os
import types

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from analytics_zoo_tpu.common.config import OrcaContext as JOrcaContext
from analytics_zoo_tpu.orca.data import pandas as jpd
from analytics_zoo_tpu.orca.learn import utils as jutils
from analytics_zoo_tpu.orca.learn.estimator import TPUEstimator as JEstimator
from analytics_zoo_tpu.pipeline.api import autograd as jag
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu.pipeline.nnframes import NNClassifier as JNNClassifier
from analytics_zoo_tpu.pipeline.nnframes import NNEstimator as JNNEstimator
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.common import context as tctx
from analytics_zoo_tpu_torch.common.config import OrcaConfig
from analytics_zoo_tpu_torch.common.config import OrcaContext as TOrcaContext
from analytics_zoo_tpu_torch.orca.data import pandas as tpd
from analytics_zoo_tpu_torch.orca.data.pandas import preprocessing as tprep
from analytics_zoo_tpu_torch.orca.learn import utils as tutils
from analytics_zoo_tpu_torch.orca.learn.estimator import Estimator
from analytics_zoo_tpu_torch.orca.learn.estimator import \
    TPUEstimator as TEstimator
from analytics_zoo_tpu_torch.pipeline.api import autograd as tag
from analytics_zoo_tpu_torch.pipeline.api.keras import \
    Sequential as TSequential
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
from analytics_zoo_tpu_torch.pipeline.nnframes import (NNClassifier,
                                                       NNEstimator, NNModel)

TOL = dict(rtol=2e-4, atol=2e-4)
KAGGLE = ["Time"] + [f"V{i}" for i in range(1, 29)] + ["Amount", "Class"]


# --- the pandas readers ------------------------------------------------------

def _kaggle_frame(n, seed):
    rng = np.random.RandomState(seed)
    data = {c: rng.randn(n) for c in KAGGLE[:-1]}
    data["Class"] = (rng.rand(n) < 0.1).astype(np.int64)
    return pd.DataFrame(data)


def _write(root, fmt, n_files, rows=9, sub=False):
    os.makedirs(root, exist_ok=True)
    for i in range(n_files):
        df = _kaggle_frame(rows + i, seed=i)
        d = os.path.join(root, "sub") if (sub and i % 2) else root
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"part-{i:03d}.{fmt}")
        if fmt == "csv":
            df.to_csv(path, index=False)
        elif fmt == "json":
            df.to_json(path, orient="records")
        else:
            df.to_parquet(path)
    # files the readers skip
    with open(os.path.join(root, "_SUCCESS"), "w"):
        pass
    return root


@pytest.fixture
def eight_devices(monkeypatch):
    """A port context of 8 local (CPU) devices, as the JAX suite's mesh
    has: a read of fewer files is repartitioned to 8 on both sides."""
    ctx = tctx.ClusterContext(OrcaConfig(), [torch.device("cpu")] * 8)
    monkeypatch.setattr(tctx, "_current", ctx)
    return ctx


def _assert_same_frames(got, want):
    g, w = got.collect(), want.collect()
    assert len(g) == len(w) == got.num_partitions()
    for a, b in zip(g, w):
        pd.testing.assert_frame_equal(a, b)


@pytest.mark.parametrize("fmt,n_files,sub", [
    ("csv", 8, False), ("csv", 9, True), ("json", 8, False),
    ("parquet", 8, False)])
def test_readers_match_jax(tmp_path, eight_devices, fmt, n_files, sub):
    root = _write(str(tmp_path / "data"), fmt, n_files, sub=sub)
    read = {"csv": "read_csv", "json": "read_json",
            "parquet": "read_parquet"}[fmt]
    got = getattr(tpd, read)(root)
    want = getattr(jpd, read)(root)
    assert got.num_partitions() == n_files
    _assert_same_frames(got, want)


def test_read_csv_globs_lists_and_pyarrow_backend(tmp_path, eight_devices):
    root = _write(str(tmp_path / "d"), "csv", 8)
    spec = f"{root}/part-00[0-3].csv,{root}/part-004.csv"
    _assert_same_frames(tpd.read_csv(spec), jpd.read_csv(spec))
    _assert_same_frames(tpd.read_csv(root, usecols=["V1", "Class"]),
                        jpd.read_csv(root, usecols=["V1", "Class"]))
    old = (TOrcaContext.pandas_read_backend, JOrcaContext.pandas_read_backend)
    try:
        TOrcaContext.pandas_read_backend = "pyarrow"
        JOrcaContext.pandas_read_backend = "pyarrow"
        _assert_same_frames(tpd.read_csv(root), jpd.read_csv(root))
    finally:
        TOrcaContext.pandas_read_backend, JOrcaContext.pandas_read_backend = \
            old
    with pytest.raises(FileNotFoundError):
        tpd.read_csv(str(tmp_path / "missing*.csv"))


def test_read_csv_repartitions_to_the_local_devices(
        tmp_path, monkeypatch, orca_context, eight_devices):
    """Two files and a context of 8 local devices (the JAX suite's CPU
    mesh): both packages cut the rows into 8 partitions alike; without a
    context the port reads one partition a file."""
    root = _write(str(tmp_path / "d"), "csv", 2, rows=20)
    assert len(orca_context.mesh.devices.ravel()) == 8
    got, want = tpd.read_csv(root), jpd.read_csv(root)
    assert got.num_partitions() == 8
    _assert_same_frames(got, want)
    monkeypatch.setattr(tctx, "_current", None)
    assert tpd.read_csv(root).num_partitions() == 2


def test_readers_stripe_files_across_processes(tmp_path, monkeypatch):
    root = _write(str(tmp_path / "d"), "csv", 7)
    every = tprep._expand_paths(root)
    for pid in range(3):
        monkeypatch.setattr(tprep, "current_context",
                            lambda pid=pid: types.SimpleNamespace(
                                process_id=pid, num_processes=3,
                                local_devices=[0]))
        monkeypatch.setattr(jax, "process_index", lambda pid=pid: pid)
        monkeypatch.setattr(jax, "process_count", lambda: 3)
        from analytics_zoo_tpu.orca.data.pandas import preprocessing as jprep
        assert tprep._expand_paths(root) == every[pid::3] == \
            jprep._expand_paths(root)


# --- NNEstimator / NNModel: the slice as a whole -----------------------------

def _fraud_frame(n=640, f=29, seed=0):
    """The fraud example's synthetic data, narrowed: 10 % fraud, +1.5 on
    five features."""
    rng = np.random.RandomState(seed)
    y = (rng.rand(n) < 0.1).astype(np.float32)
    x = rng.randn(n, f).astype(np.float32)
    x[y == 1, :5] += 1.5
    return pd.DataFrame({"features": list(x), "label": y})


def _mlp(L, widths=(32, 16), out=1, act="sigmoid"):
    return ([L.Dense(w, activation="relu") for w in widths] +
            [L.Dense(out, activation=act)])


def _bridged_modules(jlayers, tlayers, loss, n_features=29):
    """The JAX module's flax init (seed 0, as its NNEstimator draws it)
    and the port's module holding the same weights."""
    jmod = JSequential(jlayers).to_module()
    jest = JEstimator(jmod, loss=loss)
    jest.engine.build((np.zeros((1, n_features), np.float32),))
    tmod = TSequential(tlayers, device="cpu").to_module()
    interop.load_flax_params(tmod, jax.device_get(jest.engine.params))
    return jmod, tmod


@pytest.mark.parametrize("optim,lr", [
    ("adam", None), ("sgd", 0.05), ("adagrad", 0.05), ("rmsprop", 1e-3)])
def test_nnestimator_fit_transform_matches_jax(orca_context, optim, lr):
    df = _fraud_frame()
    holdout = df.sample(frac=0.1, random_state=0)
    train = df.drop(holdout.index)
    jmod, tmod = _bridged_modules(_mlp(JL), _mlp(TL), "binary_crossentropy")
    models = []
    for est in (JNNEstimator(jmod, "binary_crossentropy"),
                NNEstimator(tmod, "binary_crossentropy", device="cpu")):
        est = est.setBatchSize(128).setMaxEpoch(2).setOptimMethod(optim)
        if lr is not None:
            est = est.setLearningRate(lr)
        models.append(est.fit(train))
    jmodel, tmodel = models
    want = np.stack(jmodel.transform(holdout)["prediction"].to_numpy())
    scored = tmodel.transform(holdout)
    got = np.stack(scored["prediction"].to_numpy())
    assert got.shape == (len(holdout), 1)
    np.testing.assert_allclose(got, want, **TOL)
    pd.testing.assert_frame_equal(scored.drop(columns="prediction"),
                                  holdout)
    want_w = jax.device_get(jmodel.estimator.engine.params)
    got_w = interop.state_dict_to_flax(tmodel.estimator.module.state_dict())
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want_w),
                            jax.tree.leaves(got_w)):
        np.testing.assert_allclose(g, w, err_msg=str(path), **TOL)
    assert tmodel.estimator.engine.step == 2 * 5


def test_nnestimator_batch_stream_is_jax_bit_for_bit(orca_context):
    """NNEstimator's arrays, shuffled per epoch through the native
    runtime: the port's batches equal the JAX package's."""
    from analytics_zoo_tpu_torch.pipeline.nnframes.nn_classifier import \
        _col_to_array
    df = _fraud_frame(n=300)
    data = {"x": _col_to_array(df, "features"),
            "y": _col_to_array(df, "label")}
    want = jutils.data_to_iterator(data, 64, orca_context.mesh, shuffle=True)
    got = tutils.data_to_iterator(data, 64, shuffle=True)
    for _ in range(2):
        pairs = list(zip(got._host_batches(True), want._host_batches(True)))
        assert len(pairs) == 5
        for g, w in pairs:
            assert (g.w is None) == (w.w is None)
            for a, b in zip(g.leaves(), list(w.x) + list(w.y) + (
                    [] if w.w is None else [w.w])):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        got._epoch += 1
        want._epoch += 1


def test_nnclassifier_matches_jax(orca_context):
    rng = np.random.RandomState(3)
    x = rng.randn(256, 6).astype(np.float32)
    df = pd.DataFrame({"features": list(x),
                       "label": (x[:, 0] > 0).astype(int) + (x[:, 1] > 0)})
    jmod, tmod = _bridged_modules(_mlp(JL, (16,), 3, "softmax"),
                                  _mlp(TL, (16,), 3, "softmax"),
                                  "sparse_categorical_crossentropy", 6)
    jm = JNNClassifier(jmod).setBatchSize(64).setMaxEpoch(2).fit(df)
    tm = NNClassifier(tmod, device="cpu").setBatchSize(64).setMaxEpoch(2) \
        .fit(df)
    got, want = tm.transform(df), jm.transform(df)
    assert got["prediction"].dtype == np.int64
    probs = tm.estimator.predict({"x": x})
    np.testing.assert_allclose(probs, np.asarray(jm.estimator.predict(
        {"x": x})), **TOL)
    agree = (got["prediction"] == want["prediction"]).mean()
    assert agree == 1.0


def test_nnmodel_save_load_setters_and_lr_rule(tmp_path):
    df = _fraud_frame(n=128)
    tmod = TSequential(_mlp(TL), device="cpu").to_module()
    est = (NNEstimator(tmod, "binary_crossentropy", device="cpu")
           .set_batch_size(32).set_max_epoch(1).set_features_col("features")
           .set_label_col("label").set_prediction_col("p")
           .set_optim_method("sgd").set_learning_rate(0.1)
           .set_caching_sample(False))
    model = est.fit(df)
    path = str(tmp_path / "nn.pt")
    model.save(path)
    fresh = TSequential(_mlp(TL), device="cpu").to_module()
    again = NNModel.load(fresh, path, device="cpu").setPredictionCol("p") \
        .setBatchSize(32)
    np.testing.assert_array_equal(
        np.stack(again.transform(df)["p"].to_numpy()),
        np.stack(model.transform(df)["p"].to_numpy()))
    for nn_est in (NNEstimator(tmod, device="cpu"),
                   JNNEstimator(JSequential(_mlp(JL)).to_module())):
        with pytest.raises(ValueError, match="no learning-rate"):
            nn_est.setOptimMethod("adadelta").setLearningRate(0.1).fit(df)


def test_nnestimator_needs_a_gpu_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tmod = TSequential(_mlp(TL)).to_module()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NNEstimator(tmod, "binary_crossentropy").fit(_fraud_frame(n=64))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Estimator.from_keras(model=tmod)


# --- Estimator.from_keras and the Keras API over read_csv XShards -----------

def test_from_keras_module_and_creators():
    tmod = TSequential(_mlp(TL), device="cpu").to_module()
    est = Estimator.from_keras(model=tmod, loss="mse", device="cpu")
    assert isinstance(est, TEstimator) and est.module is tmod
    est = Estimator.from_keras(
        lambda config: (TSequential(_mlp(TL, (config["w"],))).to_module(),
                        "binary_crossentropy", "sgd"),
        config={"w": 4}, device="cpu")
    est.fit({"x": np.ones((8, 29), np.float32),
             "y": np.ones((8, 1), np.float32)}, batch_size=4, verbose=False)
    assert est.module.layers_0.Dense_0.weight.shape == (4, 29)
    with pytest.raises(TypeError, match="torch.nn.Module"):
        Estimator.from_keras(model=TSequential(_mlp(TL)), device="cpu")


def _stacked(L, A):
    """The fraud MLP over the readers' per-column features: the columns
    stacked into one (n, 29) input first."""
    return [A.Lambda(lambda *cols: A.stack(list(cols), axis=1))] + \
        _mlp(L)


def test_keras_fit_over_read_csv_shards_matches_jax(tmp_path, orca_context,
                                                    eight_devices):
    root = _write(str(tmp_path / "cc"), "csv", 2, rows=96)
    cols = KAGGLE[1:-1]
    jshards, tshards = jpd.read_csv(root), tpd.read_csv(root)
    jnet = JSequential(_stacked(JL, jag)).compile("adam",
                                                  "binary_crossentropy")
    tnet = TSequential(_stacked(TL, tag), device="cpu").compile(
        "adam", "binary_crossentropy")
    jnet.estimator.engine.build(tuple(np.zeros((1,), np.float32)
                                      for _ in cols))
    interop.load_flax_params(tnet.to_module(), jnet.get_weights())
    kw = dict(feature_cols=cols, label_cols=["Class"], batch_size=64,
              nb_epoch=2, verbose=False)
    jstats, tstats = jnet.fit(jshards, **kw), tnet.fit(tshards, **kw)
    np.testing.assert_allclose([s["train_loss"] for s in tstats],
                               [s["train_loss"] for s in jstats], **TOL)
    pred = tnet.predict(tshards, feature_cols=cols, batch_size=64)
    parts = pred.collect()
    assert len(parts) == 8 and all("prediction" in p for p in parts)
    want = jnet.estimator.predict(jshards, feature_cols=cols,
                                  batch_size=64).collect()
    for g, w in zip(parts, want):
        np.testing.assert_allclose(g["prediction"],
                                   np.asarray(w["prediction"]), **TOL)


