"""The port's tfpark (``analytics_zoo_tpu_torch/tfpark``: ``TFDataset``,
``KerasModel``, ``ZooOptimizer``, ``TFOptimizer``, ``TFEstimator``)
against the JAX package's, on the CPU.

* Every ``TFDataset`` constructor gives the JAX constructor's arrays (bit
  for bit: both are host numpy), and the batch size.
* ``ZooOptimizer(opt, 3)`` with SGD (momentum) and Adam over 7 steps of
  seeded gradients against the JAX ``ZooOptimizer`` (``optax.
  MultiSteps``), parameter by parameter after every step at rtol/atol
  1e-6 (the same f32 operations on both sides, in another order); the
  parameters are bit for bit unchanged after k - 1 and k + 1 steps; a
  state taken in the middle of a window crosses through ``interop`` in
  both directions and the run continues as it would have.
* ``KerasModel`` over a ``TFDataset`` (batch size from the dataset):
  fit, evaluate and predict against JAX's from bridged weights.
* The slice as a whole: a 2-block, 64-wide causal ``TransformerLayer``
  (flash strategy; the JAX side's Pallas kernels in interpret mode, the
  port's plain attention) under a keras2 head, through ``KerasModel`` and
  ``ZooOptimizer(..., 4)`` over ``TFDataset.from_text_set``: the
  per-epoch losses, evaluate and predict against JAX's at rtol/atol 2e-4
  (``tests/test_torch_estimator.py``'s f32 tolerance), and with SGD the
  parameters at the same tolerance (with Adam only the losses, for the
  reason that file gives).
"""

import copy
import os

import jax
import numpy as np
import optax
import pandas as pd
import pytest
import torch
from torch import nn

import analytics_zoo_tpu.tfpark as jtf
from analytics_zoo_tpu.feature.image.imageset import ImageSet as JImageSet
from analytics_zoo_tpu.feature.text.text_set import TextFeature as JFeature
from analytics_zoo_tpu.feature.text.text_set import TextSet as JTextSet
from analytics_zoo_tpu.orca.learn.optimizers import optimizers_impl as jopt
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu.pipeline.api.keras2 import layers as J2
import analytics_zoo_tpu_torch.tfpark as ttf
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.feature.image.imageset import \
    ImageSet as TImageSet
from analytics_zoo_tpu_torch.feature.text.text_set import \
    TextFeature as TFeature
from analytics_zoo_tpu_torch.feature.text.text_set import TextSet as TTextSet
from analytics_zoo_tpu_torch.orca.data.tfrecord import write_tfrecords
from analytics_zoo_tpu_torch.orca.learn.engine import TrainEngine
from analytics_zoo_tpu_torch.orca.learn.optimizers import \
    optimizers_impl as topt
from analytics_zoo_tpu_torch.pipeline.api.keras import \
    Sequential as TSequential
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
from analytics_zoo_tpu_torch.pipeline.api.keras2 import layers as T2

FIT_TOL = dict(rtol=2e-4, atol=2e-4)
OPT_TOL = dict(rtol=1e-6, atol=1e-6)


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == object:
        assert list(a) == list(b)
    else:
        np.testing.assert_array_equal(a, b)


def _text_sets(n=6, s=5, labelled=True):
    sets = []
    for feature, text_set in ((JFeature, JTextSet), (TFeature, TTextSet)):
        feats = []
        for i in range(n):
            f = feature(text=f"t {i}", label=i % 3 if labelled else None)
            f.indices = np.arange(i, i + s, dtype=np.int32)
            feats.append(f)
        sets.append(text_set(feats))
    return sets


def test_tfdataset_constructors_give_jax_arrays(tmp_path):
    rng = np.random.RandomState(0)
    x = rng.rand(12, 3).astype(np.float32)
    y = rng.randint(0, 2, 12).astype(np.int32)
    cases = [
        (lambda m: m.TFDataset.from_ndarrays((x, y), batch_size=4), 4),
        (lambda m: m.TFDataset.from_ndarrays(x), None),
        (lambda m: m.TFDataset.from_string_rdd(["a", "b", "c"]), None),
        (lambda m: m.TFDataset.from_bytes_rdd([b"x", b"yz"], batch_size=2),
         2),
    ]
    for build, bs in cases:
        j, t = build(jtf), build(ttf)
        _same(j.x, t.x)
        _same(j.y, t.y)
        assert t.batch_size == j.batch_size == bs
        assert sorted(t.to_dict()) == sorted(j.to_dict())
    for labelled in (True, False):
        jts, tts = _text_sets(labelled=labelled)
        j = jtf.TFDataset.from_text_set(jts, batch_size=3)
        t = ttf.TFDataset.from_text_set(tts, batch_size=3)
        _same(j.x, t.x)
        _same(j.y, t.y)
    imgs = rng.rand(5, 8, 8, 3).astype(np.float32)
    for labels in (np.arange(5), None):
        j = jtf.TFDataset.from_image_set(JImageSet.from_arrays(imgs, labels))
        t = ttf.TFDataset.from_image_set(TImageSet.from_arrays(imgs, labels))
        _same(j.x, t.x)
        _same(j.y, t.y)
    df = pd.DataFrame({"f": [[1.0, 2.0], [3.0, 4.0]], "l": [1.0, 2.0]})
    for labels in ("l", None):
        j = jtf.TFDataset.from_dataframe(df, "f", labels)
        t = ttf.TFDataset.from_dataframe(df, "f", labels)
        _same(j.x, t.x)
        _same(j.y, t.y)
    path = os.path.join(str(tmp_path), "data.tfrecord")
    write_tfrecords(path, ({"a": x[i], "b": x[i, :2] * 2, "label":
                            np.array([y[i]], np.int64)} for i in range(12)))
    for cols, label_cols in ((["a"], ["label"]), (["a", "b"], None)):
        j = jtf.TFDataset.from_tfrecord_file(path, cols, label_cols,
                                             batch_size=4)
        t = ttf.TFDataset.from_tfrecord_file(path, cols, label_cols,
                                             batch_size=4)
        _same(j.x, t.x)
        _same(j.y, t.y)
    import tensorflow as tf
    ds = tf.data.Dataset.from_tensor_slices((x, y))
    j = jtf.TFDataset.from_tf_data_dataset(ds, batch_size=6)
    t = ttf.TFDataset.from_tf_data_dataset(ds, batch_size=6)
    _same(j.x, t.x)
    _same(j.y, t.y)
    for m in (jtf, ttf):
        with pytest.raises(NotImplementedError):
            m.TFDataset.from_rdd(None)
        with pytest.raises(NotImplementedError):
            m.TFDataset.from_feature_set(None)
        with pytest.raises(NotImplementedError):
            m.TFOptimizer.from_loss(None, None)
        with pytest.raises(NotImplementedError):
            m.TFEstimator(lambda f, l, mode: None)


class _Net(nn.Module):
    """flax's ``Dense_0`` / ``Dense_1`` names, so interop bridges it."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(4, 3)
        self.Dense_1 = nn.Linear(3, 2)


def _grads(n_steps, seed=1):
    rng = np.random.RandomState(seed)
    return [{"Dense_0": {"kernel": rng.randn(4, 3).astype(np.float32),
                         "bias": rng.randn(3).astype(np.float32)},
             "Dense_1": {"kernel": rng.randn(3, 2).astype(np.float32),
                         "bias": rng.randn(2).astype(np.float32)}}
            for _ in range(n_steps)]


class _Port:
    """The port's optimizer over ``_Net``'s parameters, fed flax-tree
    gradients."""

    def __init__(self, flax_params, opt):
        self.net = interop.load_flax_params(_Net(), flax_params)
        self.opt = opt(list(self.net.parameters()))

    @classmethod
    def over(cls, net, opt):
        port = cls.__new__(cls)
        port.net, port.opt = net, opt
        return port

    @property
    def names(self):
        return [n for n, _ in self.net.named_parameters()]

    def step(self, grads):
        sd = interop.flax_to_state_dict(grads)
        for name, p in self.net.named_parameters():
            p.grad = sd[name].clone()
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)

    def params(self):
        return interop.state_dict_to_flax(self.net.state_dict())


def _close(got, want, tol=OPT_TOL):
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=str(path),
                                   **tol)


@pytest.mark.parametrize("name,kw", [
    ("SGD", dict(learningrate=0.1, momentum=0.9)),
    ("Adam", dict(lr=0.05))])
def test_zoo_optimizer_matches_optax_multisteps(name, kw):
    k, n = 3, 7
    params0 = _grads(1, seed=0)[0]
    grads = _grads(n)
    tx = jtf.ZooOptimizer(getattr(jopt, name)(**kw), grad_accum_steps=k)
    make = ttf.ZooOptimizer(getattr(topt, name)(**kw), grad_accum_steps=k)
    update = jax.jit(tx.update)
    jp, js = params0, tx.init(params0)
    port = _Port(params0, make)
    history = []
    for i, g in enumerate(grads):
        upd, js = update(g, js, jp)
        jp = jax.device_get(optax.apply_updates(jp, upd))
        port.step(g)
        _close(port.params(), jp)
        history.append(port.params())
        assert port.opt.mini_step == int(js.mini_step) == (i + 1) % k
        assert port.opt.gradient_step == int(js.gradient_step)
        if i == 3:      # mid-window: one micro-step into the second
            mid_jax = js
            mid_port = copy.deepcopy((port.net.state_dict(),
                                      port.opt.state_dict()))
            mid_params = jp
    # no update before the k-th step of a window, bit for bit
    for i in (0, 1, 3, 4):
        for a, b in zip(jax.tree.leaves(history[i]),
                        jax.tree.leaves(params0 if i < k else history[2])):
            np.testing.assert_array_equal(a, b)
    assert not np.array_equal(history[2]["Dense_0"]["kernel"],
                              params0["Dense_0"]["kernel"])
    # a JAX engine checkpoint taken mid-window resumes in a fresh port
    # engine (interop.state_from_jax), then on
    eng = TrainEngine(_Net(), make, None, {}, torch.device("cpu"))
    eng.build()
    eng.set_state(interop.state_from_jax(
        {"params": mid_params, "extra_vars": {}, "opt_state": mid_jax,
         "step": 4}, eng.module, eng.opt))
    assert (eng.step, eng.opt.mini_step, eng.opt.gradient_step) == (4, 1, 1)
    resumed = _Port.over(eng.module, eng.opt)
    for g in grads[4:]:
        resumed.step(g)
    _close(resumed.params(), jp)
    # the port's mid-window state into a JAX engine state
    # (interop.state_to_jax), then on in JAX
    js2 = interop.state_to_jax(
        {"params": mid_port[0], "opt_state": mid_port[1], "step": 4,
         "param_names": port.names}, tx.init(params0))["opt_state"]
    assert int(js2.mini_step) == 1 and int(js2.gradient_step) == 1
    jp2 = mid_params
    for g in grads[4:]:
        upd, js2 = update(g, js2, jp2)
        jp2 = jax.device_get(optax.apply_updates(jp2, upd))
    _close(jp2, jp)


def test_zoo_optimizer_refused_by_the_graph_gate():
    """The engine's gate names the wrapper's host branch for training
    (read on the card; here the engine is told its device is the card
    after building on the CPU, which the gate reaches before any CUDA
    call); evaluation never steps the optimizer, so its gate passes."""
    eng = TrainEngine(_Net(), ttf.ZooOptimizer("sgd", 2), None, {},
                      torch.device("cpu"))
    assert eng.graph_gate() is None          # the CPU: k eager steps
    eng.device = torch.device("cuda")
    assert "MultiSteps" in eng.graph_gate()
    assert eng.graph_gate(training=False) is None
    plain = TrainEngine(_Net(), ttf.ZooOptimizer("sgd", 1), None, {},
                        torch.device("cpu"))
    plain.build()
    assert not isinstance(plain.opt, topt.MultiSteps)


def test_keras_model_over_tfdataset_matches_jax(orca_context):
    rng = np.random.RandomState(0)
    x = rng.randn(96, 6).astype(np.float32)
    y = x.sum(-1, keepdims=True).astype(np.float32)

    def layers(L):
        return [L.Dense(8, activation="relu"), L.Dense(1)]

    jnet, tnet = JSequential(layers(JL)), TSequential(layers(TL))
    jm = jtf.KerasModel(jnet, loss="mean_squared_error",
                        optimizer=jopt.SGD(learningrate=0.05, momentum=0.9))
    tm = ttf.KerasModel(tnet, loss="mean_squared_error",
                        optimizer=topt.SGD(learningrate=0.05, momentum=0.9),
                        device="cpu")
    jnet.estimator.engine.build((x[:1],))
    interop.load_flax_params(tnet.to_module(), jnet.get_weights())
    jds = jtf.TFDataset.from_ndarrays((x, y), batch_size=16)
    tds = ttf.TFDataset.from_ndarrays((x, y), batch_size=16)
    kw = dict(epochs=2, steps_per_epoch=4, verbose=False)
    jstats, tstats = jm.fit(jds, **kw), tm.fit(tds, **kw)
    assert [s["num_samples"] for s in tstats] == [96, 96]
    np.testing.assert_allclose([s["train_loss"] for s in tstats],
                               [s["train_loss"] for s in jstats], **FIT_TOL)
    jev, tev = jm.evaluate(jds, batch_per_thread=20), tm.evaluate(
        tds, batch_per_thread=20)
    np.testing.assert_allclose(tev["loss"], jev["loss"], **FIT_TOL)
    np.testing.assert_allclose(tm.predict(tds), np.asarray(jm.predict(jds)),
                               **FIT_TOL)
    _close(tnet.get_weights(), jax.device_get(jnet.get_weights()), FIT_TOL)


SLICE = dict(vocab=50, seq_len=8, n_block=2, n_head=4, hidden_size=64,
             hidden_drop=0.0, attn_drop=0.0, embedding_drop=0.0,
             mask_attention=True, strategy="flash")


def _slice_layers(L, L2):
    return [L.TransformerLayer(**SLICE), L2.GlobalAveragePooling1D(),
            L2.Dropout(rate=0.0), L2.Dense(units=20, activation="softmax")]


@pytest.mark.parametrize("name,kw", [
    ("SGD", dict(learningrate=0.2, momentum=0.9)), ("Adam", dict(lr=1e-3))])
def test_transformer_slice_matches_jax(orca_context, name, kw):
    """The slice as a whole (see the module docstring): 48 documents, a
    dataset batch of 8, 8 micro-steps over two epochs of 4, so 2 updates
    of ``ZooOptimizer(..., 4)``."""
    rng = np.random.RandomState(0)
    n = 48
    ids = rng.randint(0, SLICE["vocab"], (n, SLICE["seq_len"]))
    sets = []
    for feature, text_set in ((JFeature, JTextSet), (TFeature, TTextSet)):
        feats = []
        for i in range(n):
            f = feature(text=str(i), label=int(ids[i, 0] % 20))
            f.indices = ids[i].astype(np.int32)
            feats.append(f)
        sets.append(text_set(feats))
    jnet = JSequential(_slice_layers(JL, J2))
    tnet = TSequential(_slice_layers(TL, T2))
    loss = "sparse_categorical_crossentropy"
    jm = jtf.KerasModel(jnet, loss=loss, optimizer=jtf.ZooOptimizer(
        getattr(jopt, name)(**kw), grad_accum_steps=4))
    tm = ttf.KerasModel(tnet, loss=loss, optimizer=ttf.ZooOptimizer(
        getattr(topt, name)(**kw), grad_accum_steps=4), device="cpu")
    jnet.estimator.engine.build((ids[:1].astype(np.int32),))
    interop.load_flax_params(tnet.to_module(), jnet.get_weights())
    jds = jtf.TFDataset.from_text_set(sets[0], batch_size=8)
    tds = ttf.TFDataset.from_text_set(sets[1], batch_size=8)
    fit_kw = dict(epochs=2, steps_per_epoch=4, verbose=False)
    jstats, tstats = jm.fit(jds, **fit_kw), tm.fit(tds, **fit_kw)
    np.testing.assert_allclose([s["train_loss"] for s in tstats],
                               [s["train_loss"] for s in jstats], **FIT_TOL)
    assert tm.estimator.engine.step == 8
    assert tm.estimator.engine.opt.gradient_step == 2
    assert "unfused_reason" not in tstats[-1]      # the CPU: no graphs
    if name == "Adam":
        return
    jev = jm.evaluate(jds, batch_per_thread=48)
    tev = tm.evaluate(tds, batch_per_thread=48)
    np.testing.assert_allclose(tev["loss"], jev["loss"], **FIT_TOL)
    np.testing.assert_allclose(tm.predict(tds, batch_per_thread=48),
                               np.asarray(jm.predict(jds,
                                                     batch_per_thread=48)),
                               **FIT_TOL)
    _close(tnet.get_weights(), jax.device_get(jnet.get_weights()), FIT_TOL)
