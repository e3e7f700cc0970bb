"""The port's keras2 API (``analytics_zoo_tpu_torch.pipeline.api.keras2``)
against the JAX package's, on the CPU (the counterpart of
``tests/test_keras2_api.py``).

* Each factory, given the same arguments on both sides, builds the port's
  v1 module of the JAX factory's flax class, with the same fields (the
  flax modules' private and pooling-internal fields aside).
* The factories refuse what the JAX ones refuse.
* Init distributions: a keras2 ``Dense`` draws as flax's ``Dense`` under
  its ``kernel_initializer`` (Glorot-uniform, else lecun-normal), a
  ``Conv2D`` as flax's ``Conv`` (lecun-normal), with torch's default
  ``nn.Linear`` as the control that must miss the limits.
* The merges against numpy; a keras2 ``Sequential`` and an Embedding ->
  LSTM -> Dense stack fit as JAX's do from bridged weights (losses,
  evaluate, predict, and for SGD the parameters, at rtol/atol 2e-4, as
  ``tests/test_torch_keras.py``'s fits); a functional ``maximum`` graph.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import flax.linen as fnn
from analytics_zoo_tpu.orca.learn.optimizers import optimizers_impl as jopt
from analytics_zoo_tpu.pipeline.api import keras2 as jk2
from analytics_zoo_tpu.pipeline.api.keras2 import layers as J
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.orca.learn.optimizers import \
    optimizers_impl as topt
from analytics_zoo_tpu_torch.pipeline.api import keras2 as tk2
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
from analytics_zoo_tpu_torch.pipeline.api.keras2 import layers as T

FIT_TOL = dict(rtol=2e-4, atol=2e-4)

# (factory, args, kwargs)
FACTORIES = [
    ("Dense", (10,), dict(activation="relu", input_dim=8)),
    ("Dense", (5,), dict(kernel_initializer="lecun_normal",
                         use_bias=False, input_shape=(7,))),
    ("Activation", ("tanh",), {}),
    ("Dropout", (0.25,), {}),
    ("Flatten", (), dict(input_shape=(2, 3))),
    ("Conv1D", (4, 5), dict(strides=2, padding="same")),
    ("Conv1D", (4, (3,)), dict(strides=(1,), activation="relu")),
    ("Conv2D", (6, (3, 3)), dict(strides=(2, 2), padding="same",
                                 data_format="channels_last")),
    ("Conv2D", (6, 3), {}),
    ("Cropping1D", ((1, 2),), {}),
    ("MaxPooling1D", (), dict(pool_size=3, strides=2)),
    ("AveragePooling1D", (), dict(pool_size=2, padding="same")),
    ("GlobalMaxPooling1D", (), {}),
    ("GlobalAveragePooling1D", (), dict(input_shape=(5, 4))),
    ("GlobalAveragePooling2D", (), dict(data_format="channels_last")),
    ("Maximum", (), {}), ("Minimum", (), {}), ("Average", (), {}),
    ("Embedding", (100, 16), dict(input_length=12)),
    ("Embedding", (20, 4), dict(embeddings_initializer="normal",
                                trainable=False)),
    ("BatchNormalization", (), dict(momentum=0.9, epsilon=1e-5)),
    ("BatchNormalization", (), dict(axis=1)),
    ("LeakyReLU", (0.1,), {}), ("ELU", (), dict(alpha=0.5)),
    ("PReLU", (), {}), ("ThresholdedReLU", (0.5,), {}),
    ("GaussianNoise", (0.2,), {}), ("GaussianDropout", (0.3,), {}),
    ("LSTM", (7,), dict(return_sequences=True)),
    ("GRU", (5,), dict(recurrent_activation="sigmoid",
                       go_backwards=True)),
    ("SimpleRNN", (3,), dict(activation="relu")),
    ("LocallyConnected1D", (6, 3), dict(strides=2)),
    ("ConvLSTM2D", (8, 3), dict(return_sequences=True)),
    ("ConvLSTM2D", (8, (3, 3)), dict(data_format="channels_first")),
]

# flax fields the v1 modules hold in another form (pooling's window and
# reducer) or that only flax has
INTERNAL = {"parent", "name", "pool_fn", "window", "strides", "_reduce",
            "_spatial"}


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    if isinstance(a, type) or hasattr(a, "dtype"):      # a dtype
        return np.dtype(a).name == str(b).replace("torch.", "")
    return a == b


@pytest.mark.parametrize("name,args,kwargs", FACTORIES,
                         ids=[f"{f[0]}-{i}" for i, f in
                              enumerate(FACTORIES)])
def test_factory_builds_the_v1_module_with_jax_fields(name, args, kwargs):
    j = getattr(J, name)(*args, **kwargs)
    t = getattr(T, name)(*args, **kwargs)
    assert type(t) is getattr(TL, type(j).__name__)
    pooling_1d = type(j).__name__.endswith("Pooling1D")
    checked = 0
    for field in dataclasses.fields(j):
        if field.name in INTERNAL or (pooling_1d and
                                      field.name == "dim_ordering"):
            continue
        want = getattr(j, field.name)
        assert hasattr(t, field.name), field.name
        assert _same(want, getattr(t, field.name)), (
            field.name, want, getattr(t, field.name))
        checked += 1
    assert checked >= 1


def test_pooling_1d_fields():
    mp = T.MaxPooling1D(pool_size=3, strides=2)
    jmp = J.MaxPooling1D(pool_size=3, strides=2)
    assert (mp.pool_length, mp.stride, mp.border_mode) == (
        jmp.pool_length, jmp.stride, jmp.border_mode) == (3, 2, "valid")


def test_embedding_weights_list():
    mat = np.random.RandomState(0).rand(100, 16).astype(np.float32)
    em = T.Embedding(100, 16, weights=[mat])
    assert em.weights.shape == (100, 16)
    np.testing.assert_array_equal(em.embedding.detach().numpy(), mat)
    for mod in (J, T):
        with pytest.raises(ValueError, match="embedding_matrix"):
            mod.Embedding(100, 16, weights=[mat, mat])


@pytest.mark.parametrize("build,match", [
    (lambda m: m.LocallyConnected1D(6, 3, padding="same"), "valid"),
    (lambda m: m.ConvLSTM2D(8, (3, 5)), "square"),
    (lambda m: m.ConvLSTM2D(8, 3, padding="valid"), "padding"),
    (lambda m: m.ConvLSTM2D(8, 3, strides=(2, 2)), "strides"),
    (lambda m: m.BatchNormalization(beta_initializer="glorot_uniform"),
     "beta_initializer"),
    (lambda m: m.BatchNormalization(gamma_initializer="zeros"),
     "gamma_initializer"),
    (lambda m: m.PReLU(shared_axes=[1]), "shared_axes"),
    (lambda m: m.Conv2D(4, 3, data_format="nhwc"), "data_format"),
], ids=["local-padding", "convlstm-square", "convlstm-padding",
        "convlstm-strides", "bn-beta", "bn-gamma", "prelu-shared",
        "conv2d-format"])
def test_refusals_match_jax(build, match):
    for mod in (J, T):
        with pytest.raises(ValueError, match=match):
            build(mod)


def _moments(w):
    w = np.asarray(w, np.float64).ravel()
    return w.std(), np.abs(w).max(), w.mean()


def test_init_distributions_match_flax():
    """std within 3 % of flax's draw (a 256 x 1024 kernel: ~0.9 % standard
    error at these counts), the largest |w| within 3 % of flax's (the
    Glorot bound, the truncation at two deviations), the mean within
    0.002. torch's default ``nn.Linear`` (uniform to 1/sqrt(fan_in),
    std 0.0361 here) misses the Glorot-uniform std (0.0395) by 8.7 %."""
    fan_in, fan_out = 256, 1024
    x = np.zeros((1, fan_in), np.float32)

    def flax_kernel(init):
        params = fnn.Dense(fan_out, kernel_init=init).init(
            jax.random.PRNGKey(0), x)["params"]
        return np.asarray(params["kernel"])

    def port_kernel(**kw):
        torch.manual_seed(0)
        layer = T.Dense(fan_out, **kw)
        layer(torch.from_numpy(x))
        return layer.Dense_0.weight.detach().numpy()

    def close(got, want):
        gs, gm, gmean = _moments(got)
        ws, wm, _ = _moments(want)
        return (abs(gs / ws - 1) < 0.03 and abs(gm / wm - 1) < 0.03
                and abs(gmean) < 2e-3)

    glorot = flax_kernel(fnn.initializers.glorot_uniform())
    lecun = flax_kernel(fnn.initializers.lecun_normal())
    assert close(port_kernel(), glorot)
    assert close(port_kernel(kernel_initializer="lecun_normal"), lecun)
    assert close(port_kernel(kernel_initializer="he_normal"), lecun)
    torch.manual_seed(0)
    control = torch.nn.Linear(fan_in, fan_out).weight.detach().numpy()
    assert not close(control, glorot)
    assert not close(control, lecun)
    # Conv2D: flax's Conv default (lecun-normal over 3 * 3 * in), whatever
    # kernel_initializer says, in JAX and here
    conv = fnn.Conv(64, (3, 3)).init(jax.random.PRNGKey(0),
                                     np.zeros((1, 8, 8, 32), np.float32))
    want = np.asarray(conv["params"]["kernel"])
    torch.manual_seed(0)
    layer = T.Conv2D(64, 3, padding="same")
    layer(torch.zeros(1, 32, 8, 8))
    assert close(layer.Conv_0.weight.detach().numpy(), want)
    torch.manual_seed(0)
    control = torch.nn.Conv2d(32, 64, 3).weight.detach().numpy()
    assert not close(control, want)


def test_merges_match_numpy():
    rng = np.random.RandomState(0)
    a, b, c = (rng.rand(4, 5).astype(np.float32) for _ in range(3))
    ta, tb, tc = map(torch.from_numpy, (a, b, c))
    for fac, fn, ref in (
            (T.Maximum, T.maximum, np.maximum(np.maximum(a, b), c)),
            (T.Minimum, T.minimum, np.minimum(np.minimum(a, b), c)),
            (T.Average, T.average, (a + b + c) / 3)):
        np.testing.assert_allclose(fac()(ta, tb, tc).numpy(), ref,
                                   rtol=1e-6)
        np.testing.assert_allclose(fn([ta, tb, tc]).numpy(), ref,
                                   rtol=1e-6)


def test_functional_merge_graph():
    i1, i2 = tk2.Input(shape=(6,)), tk2.Input(shape=(6,))
    model = tk2.Model([i1, i2], T.maximum([i1, i2]), device="cpu")
    a = np.random.RandomState(0).rand(3, 6).astype(np.float32)
    b = np.random.RandomState(1).rand(3, 6).astype(np.float32)
    np.testing.assert_allclose(np.asarray(model.predict([a, b])),
                               np.maximum(a, b), rtol=1e-6)


def _bridged(layers_of, x, optimizer, loss):
    jnet = jk2.Sequential(layers_of(J)).compile(
        optimizer=getattr(jopt, optimizer[0])(**optimizer[1]), loss=loss)
    tnet = tk2.Sequential(layers_of(T), device="cpu").compile(
        optimizer=getattr(topt, optimizer[0])(**optimizer[1]), loss=loss)
    jnet.estimator.engine.build((x[:1],))
    interop.load_flax_params(tnet.to_module(), jnet.get_weights())
    return jnet, tnet


def _fits_match(jnet, tnet, x, y, sgd):
    kw = dict(batch_size=32, nb_epoch=2, verbose=False, steps_per_epoch=3)
    jstats, tstats = jnet.fit(x, y, **kw), tnet.fit(x, y, **kw)
    np.testing.assert_allclose([s["train_loss"] for s in tstats],
                               [s["train_loss"] for s in jstats],
                               **FIT_TOL)
    jev, tev = (n.evaluate(x[:40], y[:40], batch_size=16, verbose=False)
                for n in (jnet, tnet))
    np.testing.assert_allclose(tev["loss"], jev["loss"], **FIT_TOL)
    np.testing.assert_allclose(tnet.predict(x[:20], batch_size=16),
                               np.asarray(jnet.predict(x[:20],
                                                       batch_size=16)),
                               **FIT_TOL)
    if sgd:
        want, got = jax.device_get(jnet.get_weights()), tnet.get_weights()
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                                jax.tree.leaves(got)):
            np.testing.assert_allclose(g, w, err_msg=str(path), **FIT_TOL)


@pytest.mark.parametrize("optimizer", [
    ("SGD", dict(learningrate=0.05, momentum=0.9)), ("Adam", dict(lr=1e-2))])
def test_keras2_sequential_fits_as_jax(orca_context, optimizer):
    rng = np.random.RandomState(0)
    x = rng.rand(96, 8).astype(np.float32)
    y = (x @ rng.rand(8, 1)).astype(np.float32)
    jnet, tnet = _bridged(
        lambda L: [L.Dense(16, activation="relu", input_shape=(8,)),
                   L.Dropout(0.0), L.Dense(1)], x, optimizer, "mse")
    _fits_match(jnet, tnet, x, y, optimizer[0] == "SGD")


def test_keras2_recurrent_stack_fits_as_jax(orca_context):
    rng = np.random.RandomState(0)
    x = rng.randint(0, 50, (96, 10)).astype(np.int32)
    y = (x.sum(-1) % 2).astype(np.int32)
    jnet, tnet = _bridged(
        lambda L: [L.Embedding(50, 8, input_length=10), L.LSTM(16),
                   L.Dense(2, activation="softmax")], x,
        ("SGD", dict(learningrate=0.5)), "sparse_categorical_crossentropy")
    _fits_match(jnet, tnet, x, y, True)
