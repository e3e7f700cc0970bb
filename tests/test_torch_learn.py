"""The port's learning code (analytics_zoo_tpu_torch/orca/learn: losses,
metrics, optimizers, the batch iterator) against the JAX package's, on the
same numpy inputs.

Tolerances: losses and metrics rtol/atol 1e-6 (the same f32 formulas, one
reduction each). Optimizers 1e-5 after 5 steps: optax and torch.optim
compute the same update in another order (bias corrections, weight decay
folded in before or after the lr), so each step may differ by f32 rounding.
Batch streams are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from analytics_zoo_tpu.orca.learn import losses as jlosses
from analytics_zoo_tpu.orca.learn import metrics as jmetrics
from analytics_zoo_tpu.orca.learn import utils as jutils
from analytics_zoo_tpu.orca.learn.optimizers import optimizers_impl as jopt
from analytics_zoo_tpu_torch.orca.learn import losses as tlosses
from analytics_zoo_tpu_torch.orca.learn import metrics as tmetrics
from analytics_zoo_tpu_torch.orca.learn import prologue as tpro
from analytics_zoo_tpu_torch.orca.learn import utils as tutils
from analytics_zoo_tpu_torch.orca.learn.estimator import \
    TPUEstimator as TEstimator
from analytics_zoo_tpu_torch.orca.learn.optimizers import \
    optimizers_impl as topt
from analytics_zoo_tpu_torch.orca.learn.optimizers import schedule as tsched

TOL = dict(rtol=1e-6, atol=1e-6)
OPT_TOL = dict(rtol=1e-5, atol=1e-5)


def _probs(rng, shape):
    z = np.exp(rng.randn(*shape))
    return (z / z.sum(-1, keepdims=True)).astype(np.float32)


def _loss_inputs(name, rng):
    """(y_true, y_pred) suited to the loss, and whether it takes logits."""
    if name in ("binary_crossentropy",):
        return (rng.randint(0, 2, (8, 3)).astype(np.float32),
                rng.uniform(0.01, 0.99, (8, 3)).astype(np.float32))
    if name == "categorical_crossentropy":
        return (np.eye(5, dtype=np.float32)[rng.randint(0, 5, 8)],
                _probs(rng, (8, 5)))
    if name == "sparse_categorical_crossentropy":
        return rng.randint(0, 5, 8).astype(np.int32), _probs(rng, (8, 5))
    if name == "kld":
        return _probs(rng, (8, 5)), _probs(rng, (8, 5))
    return (rng.randn(8, 3).astype(np.float32),
            rng.randn(8, 3).astype(np.float32))


@pytest.mark.parametrize("name", sorted(jlosses._LOSSES))
def test_losses_match_jax(name):
    rng = np.random.RandomState(0)
    y_true, y_pred = _loss_inputs(name, rng)
    want = jlosses.convert_loss(name)(jnp.asarray(y_true),
                                      jnp.asarray(y_pred))
    got = tlosses.convert_loss(name)(torch.from_numpy(y_true),
                                     torch.from_numpy(y_pred))
    assert got.shape == want.shape == (8,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["binary_crossentropy",
                                  "categorical_crossentropy",
                                  "sparse_categorical_crossentropy"])
def test_losses_from_logits_match_jax(name):
    rng = np.random.RandomState(1)
    y_true, _ = _loss_inputs(name, rng)
    logits = rng.randn(*((8, 3) if name == "binary_crossentropy"
                         else (8, 5))).astype(np.float32) * 3
    want = getattr(jlosses, name)(jnp.asarray(y_true), jnp.asarray(logits),
                                  from_logits=True)
    got = getattr(tlosses, name)(torch.from_numpy(y_true),
                                 torch.from_numpy(logits), from_logits=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _metric_inputs(name, rng):
    if name in ("mae", "mse", "rmse", "poisson"):
        return (rng.uniform(0, 2, (8, 3)).astype(np.float32),
                rng.uniform(0.1, 2, (8, 3)).astype(np.float32))
    if name in ("auc", "binary_accuracy", "binary_crossentropy"):
        return (rng.randint(0, 2, (8, 1)).astype(np.float32),
                rng.uniform(0.01, 0.99, (8, 1)).astype(np.float32))
    if name in ("categorical_accuracy", "categorical_crossentropy", "kld"):
        return (np.eye(6, dtype=np.float32)[rng.randint(0, 6, 8)],
                _probs(rng, (8, 6)))
    return rng.randint(0, 6, 8).astype(np.int32), _probs(rng, (8, 6))


@pytest.mark.parametrize("name", sorted(jmetrics._ALIASES))
def test_metrics_match_jax(name):
    """Two batches, the second with a padded tail (weights 1, 1, ..., 0)."""
    rng = np.random.RandomState(2)
    jm, tm = jmetrics.convert_metric(name), tmetrics.convert_metric(name)
    assert tm.name == jm.name
    js, ts = jm.init_state(), tm.init_state()
    for weight in (None, np.array([1.0] * 5 + [0.0] * 3, np.float32)):
        y_true, y_pred = _metric_inputs(name, rng)
        js = jm.update(js, jnp.asarray(y_true), jnp.asarray(y_pred),
                       None if weight is None else jnp.asarray(weight))
        ts = tm.update(ts, torch.from_numpy(y_true),
                       torch.from_numpy(y_pred),
                       None if weight is None else torch.from_numpy(weight))
    np.testing.assert_allclose(float(tm.compute(ts)),
                               float(jm.compute(js)), **TOL)


def test_convert_metrics_list_matches_jax():
    spec = ["accuracy", "mae", tmetrics.Top5Accuracy()]
    got = tmetrics.convert_metrics_list(spec)
    want = jmetrics.convert_metrics_list(["accuracy", "mae", "top5"])
    assert list(got) == list(want)
    with pytest.raises(ValueError, match="unknown metric"):
        tmetrics.convert_metric("bogus")


OPTIMIZERS = [
    ("SGD", dict(learningrate=0.1)),
    ("SGD", dict(learningrate=0.05, momentum=0.9)),
    ("SGD", dict(learningrate=0.05, momentum=0.9, nesterov=True,
                 weightdecay=1e-2)),
    ("Adam", dict(lr=1e-2)),
    ("AdamWeightDecay", dict(lr=1e-2, weight_decay=0.1)),
]


@pytest.mark.parametrize("name,kwargs", OPTIMIZERS)
def test_optimizers_match_optax(name, kwargs):
    rng = np.random.RandomState(3)
    params = {"w": rng.randn(4, 3).astype(np.float32),
              "b": rng.randn(3).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(5)]
    tx = getattr(jopt, name)(**kwargs).to_optax()
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = getattr(topt, name)(**kwargs).to_torch()(list(tp.values()))
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(),
                                   np.asarray(jp[k]), err_msg=k, **OPT_TOL)


def test_convert_optimizer_forms():
    p = [torch.nn.Parameter(torch.ones(2))]
    assert isinstance(topt.convert_optimizer("sgd", 0.5)(p),
                      torch.optim.SGD)
    assert topt.convert_optimizer("adam", 0.25)(p).defaults["lr"] == 0.25
    assert isinstance(topt.convert_optimizer("adamw")(p), torch.optim.AdamW)
    factory = lambda ps: torch.optim.SGD(ps, lr=0.1)  # noqa: E731
    assert topt.convert_optimizer(factory) is factory
    with pytest.raises(ValueError, match="factory"):
        topt.convert_optimizer(torch.optim.SGD(p, lr=0.1))
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.convert_optimizer("bogus")


@pytest.mark.parametrize("make", [
    lambda: topt.LBFGS(), lambda: topt.LBFGS(max_iter=5),
    lambda: tsched.MultiStep([10, 20], 0.1),
    lambda: tsched.Plateau("score"),
    lambda: tsched.Exponential(100, 0.5), lambda: tsched.Step(10, 0.1),
    lambda: topt.Adam(decay=0.1),
])
def test_not_ported_raise(make):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        make()


def _jax_host_batches(orca_context, data, batch_size):
    it = jutils.BatchIterator(
        jutils.chunk_shards(jutils.xshards_from_arrays(data)), batch_size,
        orca_context.mesh, pad_tail=True)
    return list(it._host_batches(shuffle=False))


def test_batch_iterator_matches_jax(orca_context):
    """Batch order, padding, weights and wire dtypes: 37 rows in batches
    of 16 (the last one padded with row 0 and masked); f64/i64 leaves
    narrowed to f32/i32 as on the JAX wire."""
    rng = np.random.RandomState(4)
    data = {"x": (rng.randn(37, 3), rng.randint(0, 9, (37, 2))),
            "y": rng.randint(0, 2, 37).astype(np.int32)}
    want = _jax_host_batches(orca_context, data, 16)
    got = list(tutils.BatchIterator(tutils.xshards_from_arrays(data), 16,
                                    pad_tail=True).epoch(shuffle=False))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        for u, v in zip(a.x + a.y, tuple(b.x) + tuple(b.y)):
            assert u.dtype == np.asarray(v).dtype
            np.testing.assert_array_equal(u, np.asarray(v))
        if b.w is None:
            assert a.w is None
        else:
            np.testing.assert_array_equal(a.w, np.asarray(b.w))


def test_shuffled_order_matches_jax_native_shuffle():
    """With shuffle on, the port's epochs visit the rows in the JAX
    package's order: both shuffle with their native runtime's xoshiro
    Fisher-Yates (built here in both), over three epochs."""
    from analytics_zoo_tpu import native as jnative
    from test_torch_ncf import native_runtimes_built
    assert native_runtimes_built()
    n, seed = 23, 7
    x = np.arange(n, dtype=np.int32)
    it = tutils.BatchIterator({"x": (x,), "y": (x,)}, 5, shuffle=True,
                              seed=seed, pad_tail=False)
    for epoch in range(3):
        rows = np.concatenate([b.x[0] for b in it.epoch()])
        want = jnative.shuffled_indices(n, seed=seed + epoch)
        np.testing.assert_array_equal(rows, want[:len(rows)])
        assert not np.array_equal(
            want, np.random.RandomState(seed + epoch).permutation(n))
    assert it.steps_per_epoch == 4


def test_data_to_iterator_forms():
    x, y = np.zeros((10, 2), np.float32), np.ones(10, np.int32)
    for data in ({"x": x, "y": y}, (x, y),
                 lambda cfg, bs: {"x": x, "y": y}):
        it = tutils.data_to_iterator(data, 4)
        assert (it.n, it.steps_per_epoch) == (10, 3)
    it = tutils.data_to_iterator(x, 4)
    assert it.y is None
    assert tutils.data_to_iterator(it, 8) is it


# --- the host-to-device plane and the prologue ------------------------------

@pytest.mark.parametrize("dtype", ["float64", "int64", "uint64",
                                   "complex128", "uint8", "int32",
                                   "float32"])
def test_narrow_wire_matches_jax(dtype):
    from analytics_zoo_tpu.native import transfer as jxfer
    from analytics_zoo_tpu_torch.native import transfer as txfer
    a = (np.random.RandomState(0).randn(7, 3) * 1e3).astype(dtype)
    got, want = txfer.narrow_wire(a), jxfer.narrow_wire(a)
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()
    assert txfer.narrows_to(a.dtype) == jxfer.narrows_to(a.dtype)
    assert txfer.wire_nbytes([a, a[:2]]) == jxfer.wire_nbytes([a, a[:2]])


def _prologue_ops(mod):
    return {"image_normalize": mod.image_normalize(),
            "rescale": mod.rescale(),
            "one_hot": mod.one_hot(5),
            "cast": mod.cast("float32"),
            "compose": mod.compose(mod.rescale(0.5), mod.cast("float64"))}


@pytest.mark.parametrize("name", sorted(_prologue_ops(tpro)))
def test_prologue_twins_match_jax(name):
    """Each op's host twin is bit-identical to the JAX package's, and its
    torch device function gives the same bits as the twin."""
    from analytics_zoo_tpu.orca.learn import prologue as jpro
    rng = np.random.RandomState(1)
    if name == "one_hot":
        a = rng.randint(-2, 8, (4, 6)).astype(np.int32)   # some out of range
    else:
        a = rng.randint(0, 256, (2, 5, 5, 3)).astype(np.uint8)
    top, jop = _prologue_ops(tpro)[name], _prologue_ops(jpro)[name]
    host = top.host(a)
    want = jop.host(a)
    assert host.dtype == want.dtype and host.tobytes() == want.tobytes()
    dev = top(torch.from_numpy(a)).numpy()
    assert dev.dtype == host.dtype and dev.tobytes() == host.tobytes()


def test_estimator_runs_the_prologue():
    """A uint8 input rescaled on the device trains like the f32 input
    rescaled on the host, bit for bit."""
    rng = np.random.RandomState(2)
    x8 = rng.randint(0, 256, (32, 4)).astype(np.uint8)
    y = rng.randn(32, 1).astype(np.float32)
    pro = tpro.BatchPrologue(x=(tpro.rescale(),))
    losses = []
    for data, prologue in (({"x": x8, "y": y}, pro),
                           ({"x": pro.host_x((x8,))[0], "y": y}, None)):
        torch.manual_seed(0)
        est = TEstimator(torch.nn.Linear(4, 1), loss="mse",
                         optimizer=topt.SGD(learningrate=0.1),
                         device="cpu", prologue=prologue)
        losses.append([s["train_loss"] for s in est.fit(
            data, epochs=2, batch_size=8, verbose=False)])
    assert losses[0] == losses[1]


def test_pump_delivers_the_inline_batches():
    """epoch(prefetch=True) (assembly on the pump's workers, copies on its
    lanes) gives the batches of epoch(prefetch=False), in order, over
    shuffled epochs with a padded tail; both record their stages."""
    rng = np.random.RandomState(3)
    data = {"x": (rng.randn(203, 3), rng.randint(0, 50, (203, 2))),
            "y": (rng.randint(0, 5, 203),)}
    its = [tutils.BatchIterator(tutils.xshards_from_arrays(data), 16,
                                shuffle=True, seed=5,
                                device=torch.device("cpu"))
           for _ in range(2)]
    for _ in range(2):
        inline = list(its[0].epoch(prefetch=False))
        pumped = list(its[1].epoch(prefetch=True))
        assert len(inline) == len(pumped) == 13
        for a, b in zip(inline, pumped):
            for u, v in zip(a.leaves(), b.leaves()):
                assert u.dtype == v.dtype
                assert torch.equal(u, v)
    for it in its:
        snap = it.stats.snapshot()
        assert snap["assemble_n"] == snap["h2d_n"] == 26
        assert snap["h2d_bytes"] > 0
