"""The port's AnomalyDetector, Wide & Deep and SessionRecommender
(``analytics_zoo_tpu_torch/models/{anomalydetection,recommendation}``)
against the JAX package's, on the CPU.

flax's init is bridged into the port's module with ``interop`` (and
back onto the same flax tree, byte for byte); forwards
agree within rtol/atol 1e-5 (f32, TF32 off on the port's side, JAX at
``highest`` precision). Fits run a few steps on both sides over the same
unshuffled batches from the bridged weights: per-epoch losses, trained
parameters and predictions within rtol/atol 1e-4. The helpers
(``unroll``, ``detect_anomalies``, ``recommend_for_user``,
``recommend_for_session``) give the JAX package's answers on the same
predictions. Dropout is 0 for the comparisons: the two packages'
generators draw different masks.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models import anomalydetection as jad
from analytics_zoo_tpu.models import recommendation as jrec
from analytics_zoo_tpu.orca.learn.optimizers import optimizers_impl as jopt
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.models import anomalydetection as tad
from analytics_zoo_tpu_torch.models import recommendation as trec
from analytics_zoo_tpu_torch.orca.learn.optimizers import \
    optimizers_impl as topt

TOL = dict(rtol=1e-5, atol=1e-5)
FIT_TOL = dict(rtol=1e-4, atol=1e-4)
# one step a dispatch: the fused path is the same trajectory (held in
# tests/test_torch_fused_dispatch.py), and its probe would compile more
ONE_STEP = {"steps_per_dispatch": 1}
RNGS = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
TAXI = os.path.join(os.path.dirname(__file__), "resources",
                    "nyc_taxi_subset.csv")


def _forward_matches(jmod, tmod, x):
    """flax's init into the port (and back onto the same flax tree, byte
    for byte), then the forwards in evaluation mode."""
    variables = jax.device_get(jax.jit(jmod.init)(RNGS, jnp.asarray(x)))
    interop.load_flax_params(tmod, dict(variables))
    back = interop.state_dict_to_flax(tmod.state_dict(), tmod)
    want = jax.tree_util.tree_leaves_with_path(variables["params"])
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes(), path
    want = np.asarray(jax.jit(jmod.apply)(variables, jnp.asarray(x)))
    tmod.eval()
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def _fit_pair(jm, tm, x, y, loss, opt, epochs=2, batch_size=16):
    """Compile both, carry the JAX estimator's initial params, fit both
    and hold losses, parameters and predictions."""
    jm.compile(loss=loss, optimizer=getattr(jopt, opt[0])(**opt[1]),
               config=dict(ONE_STEP))
    tm.compile(loss=loss, optimizer=getattr(topt, opt[0])(**opt[1]),
               config=dict(ONE_STEP))
    jm.estimator.engine.build((x[:1],))
    interop.load_flax_params(tm.module,
                             jax.device_get(jm.estimator.engine.params))
    kw = dict(epochs=epochs, batch_size=batch_size, shuffle=False,
              verbose=False)
    js, ts = jm.fit({"x": x, "y": y}, **kw), tm.fit({"x": x, "y": y}, **kw)
    np.testing.assert_allclose([s["train_loss"] for s in ts],
                               [s["train_loss"] for s in js], **FIT_TOL)
    want = interop.flax_to_state_dict(
        jax.device_get(jm.estimator.engine.params))
    got = tm.module.state_dict()
    assert set(want) == set(got)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   err_msg=name, **FIT_TOL)
    jp, tp = np.asarray(jm.predict(x[:16])), tm.predict(x[:16])
    np.testing.assert_allclose(tp, jp, **FIT_TOL)
    return jp, tp


def _taxi(n=400):
    values = np.loadtxt(TAXI, delimiter=",", skiprows=1, usecols=1,
                        dtype=np.float32)[:n]
    return ((values - values.mean()) / values.std()).reshape(-1, 1)


# --- AnomalyDetector --------------------------------------------------------------

def test_anomaly_detector_forward_matches_jax():
    x, _ = jad.AnomalyDetector.unroll(_taxi(40), unroll_length=8)
    kw = dict(feature_shape=(8, 1), hidden_layers=(4, 6, 3),
              dropouts=(0.2, 0.2, 0.2))
    _forward_matches(jad.AnomalyDetectorNet(**kw),
                     tad.AnomalyDetectorNet(**kw), x[:5])


def test_anomaly_detector_fit_and_detection_match_jax(orca_context):
    """The NYC-taxi series unrolled by 12 (``unroll`` equal to JAX's), 2
    epochs of Adam with dropout 0, then ``detect_anomalies`` on each side's
    predictions: the same points."""
    series = _taxi(300)
    (jx, jy), (tx, ty) = (m.AnomalyDetector.unroll(series, 12)
                          for m in (jad, tad))
    assert tx.tobytes() == jx.tobytes() and ty.tobytes() == jy.tobytes()
    kw = dict(feature_shape=(12, 1), hidden_layers=(4, 8),
              dropouts=(0.0, 0.0))
    jm, tm = jad.AnomalyDetector(**kw), tad.AnomalyDetector(**kw,
                                                            device="cpu")
    jp, tp = _fit_pair(jm, tm, jx[:64], jy[:64], "mean_squared_error",
                       ("Adam", dict(lr=1e-2)))
    got = tad.AnomalyDetector.detect_anomalies(ty[:16], tp, 4)
    want = jad.AnomalyDetector.detect_anomalies(jy[:16], jp, 4)
    assert [a[0] for a in got] == [a[0] for a in want] and len(got) == 4
    np.testing.assert_allclose([a[2] for a in got], [a[2] for a in want],
                               **FIT_TOL)


# --- Wide & Deep ------------------------------------------------------------------

def _column_info(mod):
    return mod.ColumnFeatureInfo(
        wide_base_cols=["occupation", "gender"], wide_base_dims=[5, 3],
        wide_cross_cols=["age-gender"], wide_cross_dims=[6],
        indicator_cols=["genres", "gender"], indicator_dims=[4, 3],
        embed_cols=["userId", "itemId"], embed_in_dims=[20, 15],
        embed_out_dims=[4, 3], continuous_cols=["age"])


def _wnd_rows(n, seed=0):
    """Rows in the ``[wide | indicator | embed_ids | continuous]`` layout;
    some embedding ids beyond their column's ``in_dim`` (clipped)."""
    rng = np.random.RandomState(seed)
    onehot = lambda d: np.eye(d, dtype=np.float32)[rng.randint(0, d, n)]
    wide = np.concatenate([onehot(5), onehot(3), onehot(6)], 1)
    ind = np.concatenate([(rng.rand(n, 4) > 0.6).astype(np.float32),
                          onehot(3)], 1)
    ids = np.stack([rng.randint(0, 24, n), rng.randint(0, 15, n)],
                   1).astype(np.float32)
    cont = rng.rand(n, 1).astype(np.float32)
    return (np.concatenate([wide, ind, ids, cont], 1),
            rng.randint(0, 2, n).astype(np.int32))


@pytest.mark.parametrize("model_type", ["wide", "deep", "wide_n_deep"])
def test_wide_and_deep_forward_matches_jax(model_type):
    jci = _column_info(jrec)
    x, _ = _wnd_rows(6)
    kw = dict(class_num=2, model_type=model_type, wide_dim=jci.wide_dim,
              indicator_dim=jci.indicator_dim,
              embed_in_dims=tuple(jci.embed_in_dims),
              embed_out_dims=tuple(jci.embed_out_dims),
              continuous_count=1, hidden_layers=(8, 4))
    _forward_matches(jrec.WideAndDeepNet(**kw), trec.WideAndDeepNet(**kw), x)
    assert _column_info(trec).feature_width() == jci.feature_width() == \
        x.shape[1]


def test_wide_and_deep_fit_and_recommend_match_jax(orca_context):
    x, y = _wnd_rows(64, seed=1)
    jm = jrec.WideAndDeep(2, _column_info(jrec), hidden_layers=(8, 4))
    tm = trec.WideAndDeep(2, _column_info(trec), hidden_layers=(8, 4),
                          device="cpu")
    _fit_pair(jm, tm, x, y, "sparse_categorical_crossentropy",
              ("Adam", dict(lr=1e-2)))
    want, got = jm.recommend_for_user(x[:16], 3), tm.recommend_for_user(
        x[:16], 3)
    assert list(got) == list(want)
    for user in want:
        assert [i for i, _ in got[user]] == [i for i, _ in want[user]]
        np.testing.assert_allclose([s for _, s in got[user]],
                                   [s for _, s in want[user]], **FIT_TOL)


# --- SessionRecommender -----------------------------------------------------------

def _sessions(n, history, seed=0):
    rng = np.random.RandomState(seed)
    width = 5 + (4 if history else 0)
    x = rng.randint(0, 34, (n, width)).astype(np.int32)   # ids > 30 clip
    return x, rng.randint(0, 31, n).astype(np.int32)


@pytest.mark.parametrize("history", [False, True],
                         ids=["session", "with-history"])
def test_session_recommender_forward_matches_jax(history):
    kw = dict(item_count=30, item_embed=8, rnn_hidden_layers=(6, 5),
              session_length=5, include_history=history,
              mlp_hidden_layers=(6, 4), history_length=4)
    x, _ = _sessions(4, history)
    _forward_matches(jrec.SessionRecommenderNet(**kw),
                     trec.SessionRecommenderNet(**kw), x)


def test_session_recommender_fit_and_recommend_match_jax(orca_context):
    kw = dict(item_count=30, item_embed=8, rnn_hidden_layers=(6,),
              include_history=True, mlp_hidden_layers=(6,),
              history_length=4)
    x, y = _sessions(32, True, seed=3)
    jm = jrec.SessionRecommender(**kw)
    tm = trec.SessionRecommender(**kw, device="cpu")
    _fit_pair(jm, tm, x, y, "sparse_categorical_crossentropy",
              ("Adam", dict(lr=1e-2)))
    for zero_based in (True, False):
        want = jm.recommend_for_session(x[:4], 3, zero_based)
        got = tm.recommend_for_session(x[:4], 3, zero_based)
        assert [[int(i) for i, _ in r] for r in got] == \
            [[int(i) for i, _ in r] for r in want]
        np.testing.assert_allclose([[s for _, s in r] for r in got],
                                   [[s for _, s in r] for r in want],
                                   **FIT_TOL)
