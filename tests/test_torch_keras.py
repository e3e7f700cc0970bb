"""The port's Keras API (``analytics_zoo_tpu_torch.pipeline.api.keras``
and ``pipeline.api.autograd``) against the JAX package's, on the CPU.

Every layer is built on both sides, the flax variables (after flax's
init) are bridged into the port's module with ``interop`` (which also
sizes its lazy widths), and both apply to the same numpy-seeded input.
Tolerance: rtol/atol 1e-5 in f32 (TF32 off on the port's side, JAX at
``highest`` precision), except ``LayerNormalization`` and the graphs
holding one (1e-5 relative still: flax takes the variance as E[x^2] -
E[x]^2, torch as E[(x - E[x])^2], which differ in the last bits at these
widths) and the fits (2e-4, as tests/test_torch_estimator.py). Random
layers are compared in evaluation mode or at rate 0, where they draw
nothing; their rates are checked on the port's side alone, since the two
packages' generators give different bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as fnn
from analytics_zoo_tpu.pipeline.api import autograd as jag
from analytics_zoo_tpu.pipeline.api.keras import Input as JInput
from analytics_zoo_tpu.pipeline.api.keras import Model as JModel
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import activations as jact
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu.pipeline.api.keras import objectives as jobj
from analytics_zoo_tpu.orca.learn.optimizers import optimizers_impl as jopt
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.orca.learn.engine import has_lazy_params
from analytics_zoo_tpu_torch.orca.learn.optimizers import \
    optimizers_impl as topt
from analytics_zoo_tpu_torch.pipeline.api import autograd as tag
from analytics_zoo_tpu_torch.pipeline.api.keras import Input as TInput
from analytics_zoo_tpu_torch.pipeline.api.keras import Model as TModel
from analytics_zoo_tpu_torch.pipeline.api.keras import \
    Sequential as TSequential
from analytics_zoo_tpu_torch.pipeline.api.keras import activations as tact
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
from analytics_zoo_tpu_torch.pipeline.api.keras import objectives as tobj
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
    self_attention as tattn

TOL = dict(rtol=1e-5, atol=1e-5)
FIT_TOL = dict(rtol=2e-4, atol=2e-4)
KEY = jax.random.PRNGKey(0)
RNGS = {"params": KEY, "dropout": jax.random.PRNGKey(1)}


def _x(shape, seed=0, kind="normal"):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    if kind == "positive":
        x = np.abs(x) + 0.1
    return x


def _bridge(jmod, tmod, xs):
    """flax init of ``jmod`` on ``xs``; the variables into ``tmod``."""
    variables = jax.device_get(jmod.init(RNGS, *map(jnp.asarray, xs)))
    interop.load_flax_params(tmod, dict(variables))
    return variables


def _outputs_match(jmod, tmod, xs, tol=TOL):
    variables = _bridge(jmod, tmod, xs)
    want = jmod.apply(variables, *map(jnp.asarray, xs))
    tmod.eval()
    with torch.no_grad():
        got = tmod(*map(torch.from_numpy, xs))
    if isinstance(want, (tuple, list)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
    else:
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


# name: (constructor args as (args, kwargs), input shapes, input kind)
LAYERS = {
    "Dense": (((8,), dict(activation="tanh")), [(4, 6)], "normal"),
    "Dense-lecun-nobias": (((5,), dict(init_method="lecun_normal",
                                       use_bias=False)), [(4, 6)], "normal"),
    "Dense-3d": (((5,), dict(activation="relu")), [(2, 3, 6)], "normal"),
    "SparseDense": (((5,), {}), [(4, 6)], "normal"),
    "Activation": ((("gelu",), {}), [(4, 6)], "normal"),
    "Dropout": (((0.3,), {}), [(4, 6)], "normal"),
    "Flatten": (((), {}), [(2, 3, 4)], "normal"),
    "Reshape": ((((6, 2),), {}), [(3, 4, 3)], "normal"),
    "Permute": ((((2, 1),), {}), [(2, 3, 4)], "normal"),
    "RepeatVector": (((3,), {}), [(2, 5)], "normal"),
    "Masking": (((0.0,), {}), [(2, 4, 3)], "masked"),
    "Highway": (((), dict(activation="relu")), [(4, 6)], "normal"),
    "MaxoutDense": (((3,), dict(nb_feature=2)), [(4, 6)], "normal"),
    "Exp": (((), {}), [(4, 6)], "normal"),
    "Log": (((), {}), [(4, 6)], "positive"),
    "Sqrt": (((), {}), [(4, 6)], "positive"),
    "Square": (((), {}), [(4, 6)], "normal"),
    "Negative": (((), {}), [(4, 6)], "normal"),
    "Identity": (((), {}), [(4, 6)], "normal"),
    "AddConstant": (((1.5,), {}), [(4, 6)], "normal"),
    "MulConstant": (((2.5,), {}), [(4, 6)], "normal"),
    "Power": (((2.0, 0.5, 1.0), {}), [(4, 6)], "normal"),
    "Scale": (((), {}), [(4, 6)], "normal"),
    "Scale-axis1": (((), dict(axis=1)), [(2, 3, 4)], "normal"),
    "CAdd": ((((6,),), {}), [(4, 6)], "normal"),
    "CMul": ((((1, 6),), {}), [(4, 6)], "normal"),
    "Mul": (((), {}), [(4, 6)], "normal"),
    "Select": (((1, 2), {}), [(2, 4, 3)], "normal"),
    "Squeeze": (((1,), {}), [(3, 1, 4)], "normal"),
    "Squeeze-all": (((), {}), [(3, 1, 4)], "normal"),
    "ExpandDim": (((1,), {}), [(3, 4)], "normal"),
    "Narrow": (((1, 1, 2), {}), [(3, 4, 2)], "normal"),
    "GetShape": (((), {}), [(3, 4, 2)], "normal"),
    "Threshold": (((0.1, -1.0), {}), [(4, 6)], "normal"),
    "BinaryThreshold": (((0.2,), {}), [(4, 6)], "normal"),
    "HardTanh": (((-0.5, 0.5), {}), [(4, 6)], "normal"),
    "HardShrink": (((0.3,), {}), [(4, 6)], "normal"),
    "SoftShrink": (((0.3,), {}), [(4, 6)], "normal"),
    "Merge-sum": (((), dict(mode="sum")), [(4, 6), (4, 6)], "normal"),
    "Merge-mul": (((), dict(mode="mul")), [(4, 6), (4, 6)], "normal"),
    "Merge-concat": (((), dict(mode="concat")), [(4, 6), (4, 3)],
                     "normal"),
    "Merge-ave": (((), dict(mode="ave")), [(4, 6), (4, 6)], "normal"),
    "Merge-max": (((), dict(mode="max")), [(4, 6), (4, 6)], "normal"),
    "Merge-min": (((), dict(mode="min")), [(4, 6), (4, 6)], "normal"),
    "Merge-dot": (((), dict(mode="dot")), [(4, 6), (4, 6)], "normal"),
    "Merge-cos": (((), dict(mode="cos")), [(4, 6), (4, 6)], "normal"),
    "ResizeBilinear-up": (((6, 10), {}), [(2, 5, 7, 3)], "normal"),
    "ResizeBilinear-down": (((3, 4), dict(data_format="channels_first")),
                            [(2, 3, 7, 9)], "normal"),
    "BatchNormalization": (((), {}), [(4, 6)], "normal"),
    "BatchNormalization-th": (((), {}), [(2, 3, 4, 5)], "normal"),
    "BatchNormalization-tf": (((), dict(dim_ordering="tf")),
                              [(2, 3, 4, 5)], "normal"),
    "LayerNormalization": (((), {}), [(4, 6)], "normal"),
    "LRN2D": (((), dict(alpha=1e-2, n=3)), [(2, 6, 4, 4)], "normal"),
    "LRN2D-tf": (((), dict(dim_ordering="tf")), [(2, 4, 4, 6)], "normal"),
    "WithinChannelLRN2D": (((), dict(size=3)), [(2, 3, 5, 5)], "normal"),
    "LeakyReLU": (((0.2,), {}), [(4, 6)], "normal"),
    "ELU": (((0.7,), {}), [(4, 6)], "normal"),
    "PReLU": (((), {}), [(4, 6)], "normal"),
    "PReLU-channels": (((3,), {}), [(2, 3, 4)], "normal"),
    "ThresholdedReLU": (((0.5,), {}), [(4, 6)], "normal"),
    "SReLU": (((), {}), [(4, 6)], "normal"),
    "RReLU": (((), {}), [(4, 6)], "normal"),
    "GaussianNoise": (((0.5,), {}), [(4, 6)], "normal"),
    "GaussianDropout": (((0.5,), {}), [(4, 6)], "normal"),
    "SpatialDropout1D": (((0.5,), {}), [(2, 3, 4)], "normal"),
    "SpatialDropout2D": (((0.5,), {}), [(2, 3, 4, 4)], "normal"),
    "SpatialDropout3D": (((0.5,), {}), [(2, 3, 2, 2, 2)], "normal"),
}


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_layer_matches_jax(case):
    (args, kwargs), shapes, kind = LAYERS[case]
    cls = case.split("-")[0]
    xs = [_x(s, seed=i, kind="positive" if kind == "positive" else "normal")
          for i, s in enumerate(shapes)]
    if kind == "masked":
        xs[0][:, 1] = 0.0
    if cls == "Merge":
        jmod, tmod = JL.Merge(*args, **kwargs), TL.Merge(*args, **kwargs)
    else:
        jmod = getattr(JL, cls)(*args, **kwargs)
        tmod = getattr(TL, cls)(*args, **kwargs)
    _outputs_match(jmod, tmod, xs)
    if cls in ("Dense", "Highway", "BatchNormalization", "Scale",
               "SReLU", "LayerNormalization", "MaxoutDense"):
        assert not has_lazy_params(tmod)


def test_gaussian_sampler_evaluation_is_the_mean():
    mean, log_var = _x((4, 3), 0), _x((4, 3), 1)
    want = JL.GaussianSampler().apply({}, (jnp.asarray(mean),
                                           jnp.asarray(log_var)))
    got = TL.GaussianSampler().eval()((torch.from_numpy(mean),
                                       torch.from_numpy(log_var)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", sorted(jact._ACTIVATIONS))
def test_activation_matches_jax(name):
    """Each name of the table, against ``jax.nn``'s function (gelu tanh,
    hard_sigmoid 0.2x + 0.5, softplus as logaddexp out to x = 30)."""
    x = np.concatenate([_x((64,), 3) * 4, [-30.0, 30.0, 0.0]]).astype(
        np.float32)
    want = np.asarray(jact.get(name)(jnp.asarray(x)))
    got = tact.get(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_activation_controls_miss():
    """Torch's defaults where they differ: exact gelu, x/6 + 1/2."""
    x = torch.linspace(-3, 3, 61)
    want = np.asarray(jact.get("gelu")(jnp.asarray(x.numpy())))
    assert np.abs(torch.nn.functional.gelu(x).numpy() - want).max() > 1e-4
    want = np.asarray(jact.get("hard_sigmoid")(jnp.asarray(x.numpy())))
    assert np.abs(torch.nn.functional.hardsigmoid(x).numpy() -
                  want).max() > 1e-2
    with pytest.raises(ValueError, match="unknown activation"):
        tact.get("bogus")


def test_batchnorm_running_statistics_after_train_steps():
    """Three train-mode forwards on both sides: flax's ``batch_stats``
    (momentum 0.99, the biased batch variance) and the port's running
    buffers agree, and so do the eval outputs after them; torch's own
    BatchNorm1d (the unbiased variance) is the control that misses."""
    for shape, kw in (((16, 6), {}), ((4, 3, 5, 5), {})):
        jmod, tmod = JL.BatchNormalization(**kw), TL.BatchNormalization(**kw)
        variables = _bridge(jmod, tmod, [_x(shape)])
        tmod.train()
        for step in range(3):
            x = _x(shape, seed=10 + step) * 2 + 1
            _, upd = jmod.apply(variables, jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
            variables = {"params": variables["params"], **upd}
            tmod(torch.from_numpy(x))
        stats = jax.device_get(variables["batch_stats"])["BatchNorm_0"]
        bn = tmod.BatchNorm_0
        np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"],
                                   **TOL)
        np.testing.assert_allclose(bn.running_var.numpy(), stats["var"],
                                   **TOL)
        x = _x(shape, seed=20)
        want = jmod.apply(variables, jnp.asarray(x))
        np.testing.assert_allclose(
            tmod.eval()(torch.from_numpy(x)).detach().numpy(),
            np.asarray(want), **TOL)
    control = torch.nn.BatchNorm1d(6, momentum=0.01, eps=1e-3)
    for step in range(3):
        control(torch.from_numpy(_x((16, 6), seed=10 + step) * 2 + 1))
    ref = jax.device_get(JL.BatchNormalization().init(
        RNGS, jnp.asarray(_x((16, 6)))))
    for step in range(3):
        _, upd = JL.BatchNormalization().apply(
            ref, jnp.asarray(_x((16, 6), seed=10 + step) * 2 + 1),
            train=True, mutable=["batch_stats"])
        ref = {"params": ref["params"], **upd}
    var = np.asarray(ref["batch_stats"]["BatchNorm_0"]["var"])
    assert np.abs(control.running_var.numpy() - var).max() > 1e-4


def test_dense_init_statistics_match_flax():
    """Keras Dense draws glorot_uniform (limit sqrt(6 / (in + out))), as
    flax does; the bridge copies weights, so only this sees the draw.
    Eight layers of 256 -> 128 a side (262,144 draws): std within 2 % of
    flax's, the largest draw under flax's limit; torch's own Linear init
    (kaiming uniform, limit 1 / sqrt(in)) is the control that misses."""
    x = jnp.zeros((1, 256))
    want = np.concatenate([np.asarray(JL.Dense(128).init(
        jax.random.PRNGKey(k), x)["params"]["Dense_0"]["kernel"]).ravel()
        for k in range(8)])
    torch.manual_seed(0)
    got, biases = [], []
    for _ in range(8):
        layer = TL.Dense(128)
        layer(torch.zeros(1, 256))
        got.append(layer.Dense_0.weight.detach().numpy().ravel())
        biases.append(layer.Dense_0.bias.detach().numpy())
    got = np.concatenate(got)
    limit = np.sqrt(6.0 / (256 + 128))
    assert got.size == want.size == 262_144
    assert abs(got.std() / want.std() - 1) <= 0.02
    assert np.abs(got).max() <= limit and np.abs(want).max() <= limit
    assert not np.any(np.concatenate(biases))
    control = np.concatenate([torch.nn.Linear(256, 128).weight.detach()
                              .numpy().ravel() for _ in range(8)])
    assert abs(control.std() / want.std() - 1) > 0.02
    # the lecun_normal branch: std 1 / sqrt(in)
    lecun = TL.Dense(128, init_method="lecun_normal")
    lecun(torch.zeros(1, 256))
    assert abs(lecun.Dense_0.weight.std().item() * 16 - 1) <= 0.02


def test_random_layers_rates_and_generator():
    """The port's random layers in training: Dropout's rate and scale,
    the spatial dropouts' whole maps, the Gaussian noise's std, RReLU's
    slopes; each draws from the generator it is given."""
    torch.manual_seed(0)
    x = torch.ones(200_000)
    g = torch.Generator().manual_seed(3)
    drop = TL.Dropout(0.3).train()
    drop.generator = g
    y = drop(x)
    assert abs((y == 0).float().mean().item() - 0.3) < 0.01
    np.testing.assert_allclose(y[y != 0].numpy(), 1 / 0.7, rtol=1e-6)
    g.manual_seed(3)
    np.testing.assert_array_equal(drop(x).numpy(), y.numpy())
    for layer, shape, axes in ((TL.SpatialDropout1D(0.5), (64, 10, 8), (1,)),
                               (TL.SpatialDropout2D(0.5), (64, 8, 4, 4),
                                (2, 3)),
                               (TL.SpatialDropout3D(0.5, dim_ordering="tf"),
                                (16, 2, 3, 2, 8), (1, 2, 3))):
        y = layer.train()(torch.ones(shape))
        first = y[tuple(slice(None) if i not in axes else 0
                        for i in range(len(shape)))]
        expanded = first.reshape([1 if i in axes else n
                                  for i, n in enumerate(shape)])
        assert torch.equal(y, expanded.expand(shape))
        assert set(torch.unique(y).tolist()) <= {0.0, 2.0}
    noise = TL.GaussianNoise(0.5).train()(torch.zeros(200_000))
    assert abs(noise.std().item() / 0.5 - 1) < 0.01
    gd = TL.GaussianDropout(0.2).train()(torch.ones(200_000))
    assert abs(gd.std().item() / 0.5 - 1) < 0.01
    r = TL.RReLU().train()(-torch.ones(10_000))
    assert (-r).min() >= 1 / 8 and (-r).max() <= 1 / 3
    s = TL.GaussianSampler().train()((torch.zeros(100_000),
                                      torch.zeros(100_000)))
    assert abs(s.std().item() - 1) < 0.02


def _seq_layers(L, widths=(16, 8)):
    return ([L.Dense(w, activation="relu") for w in widths] +
            [L.Dense(1, activation="sigmoid")])


def test_sequential_matches_jax_and_keeps_flax_names():
    jnet = JSequential(_seq_layers(JL) + [JL.BatchNormalization()])
    tnet = TSequential(_seq_layers(TL) + [TL.BatchNormalization()],
                       device="cpu")
    x = _x((8, 5))
    _outputs_match(jnet.to_module(), tnet.to_module(), [x])
    variables = jax.device_get(jnet.to_module().init(RNGS, jnp.asarray(x)))
    got = tnet.get_weights()
    assert jax.tree.structure(got) == jax.tree.structure(
        dict(variables["params"]))
    assert set(got["layers_0"]["Dense_0"]) == {"kernel", "bias"}


def test_functional_model_with_shared_layer_and_stock_module():
    """Two inputs through one shared Dense, merged, then a stock
    ``torch.nn.Linear`` (a stock flax ``nn.Dense`` on the JAX side)
    recorded into the graph by the symbolic dispatch."""
    def build(K, I, M, L, stock):
        a, b = I(shape=(5,)), I(shape=(5,))
        shared = L.Dense(8, activation="relu")
        h = L.merge([shared(a), shared(b)], mode="concat")
        out = stock(h)
        return K(input=[a, b], output=out), shared

    jnet, _ = build(JModel, JInput, None, JL, fnn.Dense(3))
    tnet, tshared = build(TModel, TInput, None, TL, torch.nn.Linear(16, 3))
    tmod = tnet.to_module()
    assert sum(1 for m in tmod.children() if m is tshared) == 1
    xs = [_x((4, 5), 0), _x((4, 5), 1)]
    _outputs_match(jnet.to_module(), tmod, xs)
    assert isinstance(tmod.layers_2, torch.nn.Linear)
    plain = torch.nn.Linear(2, 2)       # untouched outside a graph
    assert plain(torch.ones(1, 2)).shape == (1, 2)


def test_autograd_expressions_lambda_and_parameter():
    w0 = _x((5, 3), 7)

    def build(K, I, A):
        x = I(shape=(5,))
        y = A.exp(x) * 0.5 + A.square(x) - A.abs(x) / 3.0
        y = A.clip(y, -2.0, 2.0) + A.softplus(x) - A.softsign(x)
        y = A.maximum(y, A.neg(x)) + A.l2_normalize(x, axis=1)
        p = A.Parameter((5, 3), init_weight=w0)
        z = A.mm(y, p)
        z = A.Lambda(lambda t: t * 3.0)(z)
        s = A.sum(z, axis=1, keepdims=True) + A.mean(z, axis=1,
                                                       keepdims=True)
        s = s + A.max(z, axis=1, keepdims=True) - A.min(z, axis=1,
                                                        keepdims=True)
        out = A.stack([z[:, 0], A.squeeze(s, 1)], axis=1)
        return K(x, out)

    jnet, tnet = build(JModel, JInput, jag), build(TModel, TInput, tag)
    _outputs_match(jnet.to_module(), tnet.to_module(), [_x((4, 5))])
    weights = tnet.to_module().state_dict()
    assert any(k.endswith(".weight") and v.shape == (5, 3)
               for k, v in weights.items())
    flax_tree = interop.state_dict_to_flax(weights, tnet.to_module())
    leaf = next(iter(flax_tree.values()))
    assert set(leaf) == {"weight"} and leaf["weight"].shape == (5, 3)


def test_autograd_batch_contractions_and_custom_loss():
    a, b = _x((2, 3, 4), 0), _x((2, 5, 4), 1)
    for kwargs in (dict(axes=(2, 2)), dict(axes=(2, 2), normalize=True),
                   dict(axes=(1, 1))):
        bb = b if kwargs["axes"] == (2, 2) else _x((2, 3, 6), 2)
        want = jag.batch_dot(jnp.asarray(a), jnp.asarray(bb), **kwargs)
        got = tag.batch_dot(torch.from_numpy(a), torch.from_numpy(bb),
                            **kwargs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jag.mm(jnp.asarray(a), jnp.asarray(b), axes=(2, 2))
    got = tag.mm(torch.from_numpy(a), torch.from_numpy(b), axes=(2, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    def loss(A):
        return lambda yt, yp: A.mean(A.square(yt - yp) + A.abs(yp), axis=1)
    yt, yp = _x((6, 3), 3), _x((6, 3), 4)
    want = jag.CustomLoss(loss(jag))(jnp.asarray(yt), jnp.asarray(yp))
    got = tag.CustomLoss(loss(tag))(torch.from_numpy(yt),
                                    torch.from_numpy(yp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(TypeError, match="Variable graph"):
        tag.CustomLoss(lambda yt, yp: TInput(shape=(3,)))(yt, yp)


@pytest.mark.parametrize("name", ["MeanSquaredError", "MeanAbsoluteError",
                                  "BinaryCrossEntropy",
                                  "CategoricalCrossEntropy",
                                  "SparseCategoricalCrossEntropy", "Hinge",
                                  "KullbackLeiblerDivergence"])
def test_objectives_match_jax(name):
    rng = np.random.RandomState(5)
    probs = rng.dirichlet(np.ones(4), 8).astype(np.float32)
    if name == "SparseCategoricalCrossEntropy":
        yt = rng.randint(0, 4, 8).astype(np.int32)
    elif name in ("CategoricalCrossEntropy", "KullbackLeiblerDivergence"):
        yt = rng.dirichlet(np.ones(4), 8).astype(np.float32)
    else:
        yt = (rng.rand(8, 4) > 0.5).astype(np.float32)
    want = getattr(jobj, name)()(jnp.asarray(yt), jnp.asarray(probs))
    got = getattr(tobj, name)()(torch.from_numpy(yt), torch.from_numpy(probs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _bridged_nets(optimizer):
    x = _x((96, 5))
    y = (x[:, :1] + x[:, 1:2] > 0).astype(np.float32)
    jnet = JSequential(_seq_layers(JL)).compile(
        optimizer=getattr(jopt, optimizer[0])(**optimizer[1]),
        loss="binary_crossentropy")
    tnet = TSequential(_seq_layers(TL), device="cpu").compile(
        optimizer=getattr(topt, optimizer[0])(**optimizer[1]),
        loss="binary_crossentropy")
    jnet.estimator.engine.build((x[:1],))
    interop.load_flax_params(tnet.to_module(), jnet.get_weights())
    return jnet, tnet, x, y


@pytest.mark.parametrize("optimizer", [
    ("SGD", dict(learningrate=0.1, momentum=0.9)), ("Adam", dict(lr=1e-2))])
def test_compile_fit_evaluate_predict_match_jax(orca_context, optimizer):
    jnet, tnet, x, y = _bridged_nets(optimizer)
    kw = dict(batch_size=32, nb_epoch=2, verbose=False, steps_per_epoch=3)
    jstats = jnet.fit(x, y, **kw)
    tstats = tnet.fit(x, y, **kw)
    np.testing.assert_allclose([s["train_loss"] for s in tstats],
                               [s["train_loss"] for s in jstats], **FIT_TOL)
    jev, tev = (n.evaluate(x[:40], y[:40], batch_size=16, verbose=False)
                for n in (jnet, tnet))
    np.testing.assert_allclose(tev["loss"], jev["loss"], **FIT_TOL)
    np.testing.assert_allclose(tnet.predict(x[:20], batch_size=16),
                               np.asarray(jnet.predict(x[:20],
                                                       batch_size=16)),
                               **FIT_TOL)
    if optimizer[0] == "SGD":
        want, got = jax.device_get(jnet.get_weights()), tnet.get_weights()
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                                jax.tree.leaves(got)):
            np.testing.assert_allclose(g, w, err_msg=str(path), **FIT_TOL)


def test_weights_round_trip_and_lazy_widths(tmp_path):
    """A fresh net has no weights until its first input; ``load_weights``
    into a fresh net sizes them and evaluates to the same loss exactly;
    ``fit`` sizes them from one sample row first."""
    x = _x((64, 5))
    y = (x[:, :1] > 0).astype(np.float32)
    net = TSequential(_seq_layers(TL), device="cpu").compile(
        "adam", "binary_crossentropy")
    assert net.get_weights() is None
    net.fit(x, y, batch_size=16, nb_epoch=1, verbose=False)
    path = str(tmp_path / "w.pt")
    net.save_weights(path)
    again = TSequential(_seq_layers(TL), device="cpu").compile(
        "adam", "binary_crossentropy")
    again.load_weights(path)
    assert again.evaluate(x, y, batch_size=16)["loss"] == \
        net.evaluate(x, y, batch_size=16)["loss"]
    assert again.estimator.engine.step == net.estimator.engine.step == 4


def test_keras_net_needs_a_gpu_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = TSequential(_seq_layers(TL)).compile("adam", "mse")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        net.fit(_x((8, 5)), _x((8, 1)), batch_size=4, nb_epoch=1)


@pytest.mark.parametrize("opt_name", ["Adam", "Adagrad"])
def test_checkpoints_restore_into_a_fresh_lazy_net(orca_context, tmp_path,
                                                   opt_name):
    """A checkpoint the JAX estimator wrote for its Keras net, and one the
    port wrote, each restored into a fresh port net that has never seen
    an input (its widths still lazy): the same predictions, and training
    goes on from there to the same losses as the JAX estimator's."""
    from analytics_zoo_tpu.orca.learn.estimator import \
        TPUEstimator as JEstimator
    from analytics_zoo_tpu.orca.learn.trigger import EveryEpoch as JEvery
    from analytics_zoo_tpu_torch.orca.learn.estimator import \
        TPUEstimator as TEstimator
    x = _x((64, 5))
    y = (x[:, :1] > 0).astype(np.float32)
    kw = dict(batch_size=16, verbose=False, steps_per_epoch=4)

    def port_est(model_dir):
        return TEstimator(TSequential(_seq_layers(TL)).to_module(),
                          loss="binary_crossentropy",
                          optimizer=getattr(topt, opt_name)(),
                          model_dir=model_dir, device="cpu")
    jest = JEstimator(JSequential(_seq_layers(JL)).to_module(),
                      loss="binary_crossentropy",
                      optimizer=getattr(jopt, opt_name)(),
                      model_dir=str(tmp_path / "jax"))
    jest.fit({"x": x, "y": y}, epochs=1, checkpoint_trigger=JEvery(), **kw)
    fresh = port_est(None)
    assert has_lazy_params(fresh.module)
    fresh.load_checkpoint(str(tmp_path / "jax"))
    assert fresh.engine.step == 4
    np.testing.assert_allclose(fresh.predict(x, batch_size=16),
                               np.asarray(jest.predict(x, batch_size=16)),
                               **FIT_TOL)
    tl = fresh.fit({"x": x, "y": y}, epochs=1, **kw)[0]["train_loss"]
    jl = jest.fit({"x": x, "y": y}, epochs=1, **kw)[0]["train_loss"]
    np.testing.assert_allclose(tl, jl, **FIT_TOL)
    # the port's own checkpoint, into another fresh net
    fresh.model_dir = str(tmp_path / "port")
    fresh.save_checkpoint(fresh.model_dir, blocking=True)
    again = port_est(None)
    again.load_checkpoint(str(tmp_path / "port"))
    np.testing.assert_array_equal(again.predict(x, batch_size=16),
                                  fresh.predict(x, batch_size=16))


def test_engine_hands_its_generator_to_every_random_layer():
    """Dropout, the noise layers, RReLU: each takes the engine's generator
    at build, so two fits from the same weights and seed draw alike and a
    third seed draws otherwise."""
    x = _x((64, 6))
    y = (x[:, :1] > 0).astype(np.float32)
    losses = []
    for seed in (0, 0, 1):
        torch.manual_seed(7)
        net = TSequential([TL.GaussianNoise(0.3), TL.Dense(8),
                           TL.RReLU(), TL.GaussianDropout(0.2),
                           TL.Dropout(0.3), TL.Dense(1, activation="sigmoid")],
                          device="cpu").compile("sgd", "binary_crossentropy")
        net.to_module()(torch.zeros(1, 6))
        net.estimator.engine.seed = seed
        torch.manual_seed(seed + 100)   # the global generator is not used
        stats = net.fit(x, y, batch_size=16, nb_epoch=2, shuffle=False,
                        verbose=False)
        random_layers = [m for m in net.to_module().modules()
                         if isinstance(m, tattn.DrawsRandom)]
        assert len(random_layers) == 4
        assert all(m.generator is net.estimator.engine._gen
                   for m in random_layers)
        losses.append([s["train_loss"] for s in stats])
    assert losses[0] == losses[1]
    assert losses[0] != losses[2]
