"""The port's NeuralCF (analytics_zoo_tpu_torch/models/recommendation)
against the JAX package's, on the CPU: a twin of
tests/test_estimator.py::test_ncf_training at its widths (50 users x 30
items, embed 8, hidden (16, 8), mf 8).

The JAX ``TPUEstimator`` builds the flax parameters; ``interop`` bridges
them into the port's module; both fit the same data with ``shuffle=True``
for 2 epochs (the JAX estimator pinned to one step per dispatch), so both
see the same batches only if their shuffles agree.

Tolerances. f32 compute, SGD and Adam: every step's loss and the final
parameters within 1e-5. Both sides sum in f32 in different orders, and the
one-hot backward rounds the cotangents to bf16 on both, so a cotangent on a
rounding boundary may land one bf16 ulp apart.

bf16 compute (the flagship's ``compute_dtype``). The losses stay near
ln(class_num) at these steps whatever the MLP computes, so they alone
cannot tell bf16 compute from f32; each bf16 check below therefore also
runs a control, the port at f32 compute from the same weights, which must
miss its limit. Each limit lies between the two readings (``-s`` prints
them):
* first-step gradients at the bridged weights: the MLP and head kernels
  and the tables within 1e-6 of each one's largest gradient (the two sides
  round the same bf16 products alike), the biases within 2e-2 (their bf16
  reductions over the batch round in different orders);
* a 2-epoch SGD fit: every step's loss within 2e-4 relative, and each
  Dense parameter's total update within 0.2 of its largest (the biases'
  first-step differences carry through ten momentum steps);
* a 2-epoch Adam fit: every step's loss within 2e-4 relative (Adam
  normalises the updates, so bf16 and f32 compute train alike here).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models.recommendation import NeuralCF as JNeuralCF
from analytics_zoo_tpu.orca.learn.optimizers import optimizers_impl as jopt
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
from analytics_zoo_tpu_torch.orca.learn.optimizers import \
    optimizers_impl as topt

WIDTHS = dict(user_count=50, item_count=30, class_num=2, user_embed=8,
              item_embed=8, hidden_layers=(16, 8), mf_embed=8)
OPTIMIZERS = {"SGD": dict(learningrate=0.1, momentum=0.9),
              "Adam": dict(lr=1e-3)}
TOL_F32 = dict(rtol=1e-5, atol=1e-5)
TOL_BF16_LOSS = 2e-4
TOL_BF16_GRAD = 1e-6            # kernels, tables, head
TOL_BF16_BIAS_GRAD = 2e-2       # the MLP's biases
TOL_BF16_UPDATE = 0.2           # SGD fit: each Dense parameter's update


def native_runtimes_built() -> bool:
    """Both packages' native runtimes load (they shuffle alike only then).
    Test processes running side by side may find the JAX package's
    library while another one's g++ is still writing it: its loader then
    gives up for the process, so the load is retried."""
    from analytics_zoo_tpu.native import runtime as jruntime
    from analytics_zoo_tpu_torch.native import runtime as truntime
    for _ in range(30):
        if jruntime.available() and truntime.available():
            return True
        for runtime in (jruntime, truntime):
            if runtime._lib is False:       # load again on the next call
                runtime._lib = None
        time.sleep(1.0)
    return False


def _data(n=320, seed=0):
    rng = np.random.RandomState(seed)
    users = rng.randint(1, 50, n)
    items = rng.randint(1, 30, n)
    labels = ((users + items) % 2).astype(np.int64)
    return np.stack([users, items], -1).astype(np.int32), labels


def _record_steps(engine):
    """Wrap ``engine.train_batch`` to keep every step's loss."""
    losses, inner = [], engine.train_batch

    def train_batch(batch):
        loss = inner(batch)
        losses.append(loss)
        return loss

    engine.train_batch = train_batch
    return losses


def ncf_pair(opt_name, compute="float32", **extra):
    """The JAX NeuralCF (compiled, flax-initialised) and the port's on the
    CPU, holding the same weights."""
    assert native_runtimes_built()
    pairs, _ = _data()
    jm = JNeuralCF(compute_dtype=getattr(jnp, compute), **WIDTHS)
    jm.compile(loss="sparse_categorical_crossentropy",
               optimizer=getattr(jopt, opt_name)(**OPTIMIZERS[opt_name]),
               config={"steps_per_dispatch": 1}, **extra)
    jm.estimator.engine.build((pairs[:1],))
    return jm, port_twin(jm, opt_name, compute, **extra)


def port_twin(jm, opt_name, compute, **extra):
    """The port's NeuralCF on the CPU at ``compute``, holding ``jm``'s
    current weights."""
    tm = NeuralCF(compute_dtype=getattr(torch, compute), device="cpu",
                  **WIDTHS)
    interop.load_flax_params(tm.module,
                             jax.device_get(jm.estimator.engine.params))
    tm.compile(loss="sparse_categorical_crossentropy",
               optimizer=getattr(topt, opt_name)(**OPTIMIZERS[opt_name]),
               **extra)
    return tm


def _max_rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _fit_both(jm, tm, **kw):
    pairs, labels = _data()
    jsteps = _record_steps(jm.estimator.engine)
    tsteps = _record_steps(tm.estimator.engine)
    kw = dict(dict(epochs=2, batch_size=64, shuffle=True, verbose=False),
              **kw)
    jstats = jm.fit({"x": pairs, "y": labels}, **kw)
    tstats = tm.fit({"x": pairs, "y": labels}, **kw)
    jl = np.asarray([float(v) for v in jax.device_get(jsteps)])
    tl = np.asarray([float(v) for v in tsteps])
    return jstats, tstats, jl, tl


@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
def test_ncf_fit_matches_jax(orca_context, opt_name):
    jm, tm = ncf_pair(opt_name)
    jstats, tstats, jl, tl = _fit_both(jm, tm)
    assert len(tl) == len(jl) == 10
    np.testing.assert_allclose(tl, jl, **TOL_F32)
    np.testing.assert_allclose([s["train_loss"] for s in tstats],
                               [s["train_loss"] for s in jstats], **TOL_F32)
    want = interop.flax_to_state_dict(
        jax.device_get(jm.estimator.engine.params))
    got = tm.estimator.get_model()
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   err_msg=key, **TOL_F32)
    pairs, _ = _data()
    np.testing.assert_allclose(tm.predict(pairs[:50]),
                               np.asarray(jm.predict(pairs[:50])),
                               **TOL_F32)


def test_ncf_fit_bf16_matches_jax(orca_context):
    """bf16 compute under Adam: every step's loss within TOL_BF16_LOSS."""
    jm, tm = ncf_pair("Adam", compute="bfloat16")
    _, _, jl, tl = _fit_both(jm, tm)
    assert len(tl) == 10 and np.isfinite(tl).all()
    print("bf16 Adam fit, loss", _max_rel(tl, jl))
    np.testing.assert_allclose(tl, jl, rtol=TOL_BF16_LOSS)


def _dense_update_errs(tm, init, want) -> dict:
    """Each Dense parameter's total update in the port against JAX's,
    relative to the largest element of JAX's."""
    got = tm.estimator.get_model()
    return {k: _max_rel(got[k].numpy() - init[k], want[k] - init[k])
            for k in want if k.startswith(("mlp_dense", "head"))}


def test_ncf_fit_bf16_sgd_updates_match_jax(orca_context):
    """bf16 compute under SGD with momentum: every step's loss within
    TOL_BF16_LOSS and each Dense parameter's update within TOL_BF16_UPDATE;
    the port at f32 compute from the same weights misses both."""
    jm, tm = ncf_pair("SGD", compute="bfloat16")
    control = port_twin(jm, "SGD", "float32")
    init = {k: v.numpy().copy() for k, v in tm.estimator.get_model().items()}
    csteps = _record_steps(control.estimator.engine)
    _, _, jl, tl = _fit_both(jm, tm)
    pairs, labels = _data()
    control.fit({"x": pairs, "y": labels}, epochs=2, batch_size=64,
                shuffle=True, verbose=False)
    cl = np.asarray([float(v) for v in csteps])
    want = {k: v.numpy() for k, v in interop.flax_to_state_dict(
        jax.device_get(jm.estimator.engine.params)).items()}
    errs = _dense_update_errs(tm, init, want)
    cerrs = _dense_update_errs(control, init, want)
    loss_err = float(np.max(np.abs(tl - jl) / np.abs(jl)))
    closs_err = float(np.max(np.abs(cl - jl) / np.abs(jl)))
    print("bf16 SGD fit, loss", loss_err, "updates", errs)
    print("f32 control, loss", closs_err, "updates", cerrs)
    assert len(tl) == 10 and np.isfinite(tl).all()
    assert loss_err <= TOL_BF16_LOSS
    assert max(errs.values()) <= TOL_BF16_UPDATE, errs
    assert closs_err > TOL_BF16_LOSS
    assert max(cerrs.values()) > TOL_BF16_UPDATE, cerrs


def _first_step_grads(tm, x, y) -> dict:
    from analytics_zoo_tpu_torch.orca.learn.utils import Batch
    tm.estimator.engine.build()
    tm.estimator.engine.train_batch(Batch(x=(x,), y=(y,), w=None))
    return {n: p.grad.numpy().copy()
            for n, p in tm.module.named_parameters()}


def test_ncf_bf16_first_step_grads_match_jax(orca_context):
    """bf16 compute: the port's gradients of one batch of 320 at the bridged
    weights against ``jax.grad`` of the JAX estimator's loss: kernels,
    tables and head within TOL_BF16_GRAD, the MLP biases within
    TOL_BF16_BIAS_GRAD; the port at f32 compute misses them."""
    jm, tm = ncf_pair("SGD", compute="bfloat16")
    control = port_twin(jm, "SGD", "float32")
    x, y = _data()
    eng = jm.estimator.engine

    def loss_of(params):
        preds, _ = eng._apply(params, {}, (jnp.asarray(x),), True)
        return eng._compute_loss((jnp.asarray(y),), preds, None)

    want = {k: v.numpy() for k, v in interop.flax_to_state_dict(
        jax.device_get(jax.jit(jax.grad(loss_of))(eng.params))).items()}

    def limit(name):
        bias = name.startswith("mlp_dense") and name.endswith(".bias")
        return TOL_BF16_BIAS_GRAD if bias else TOL_BF16_GRAD

    got = _first_step_grads(tm, x, y)
    ctl = _first_step_grads(control, x, y)
    errs = {k: _max_rel(got[k], want[k]) for k in want}
    cerrs = {k: _max_rel(ctl[k], want[k]) for k in want}
    print("bf16 first-step grads", errs)
    print("f32 control", cerrs)
    assert set(got) == set(want)
    for k in want:
        assert errs[k] <= limit(k), (k, errs[k])
    assert all(cerrs[k] > limit(k) for k in want), cerrs


def test_ncf_predict_and_recommend():
    """The JAX test's checks: softmax rows sum to 1, and
    ``recommend_for_user`` ranks at most ``max_items`` items per user, in
    order of the last class's probability."""
    pairs, labels = _data()
    tm = NeuralCF(device="cpu", **WIDTHS)
    tm.compile(loss="sparse_categorical_crossentropy", optimizer="adam",
               metrics=["accuracy"])
    stats = tm.fit({"x": pairs, "y": labels}, epochs=2, batch_size=64,
                   verbose=False)
    assert np.isfinite(stats[-1]["train_loss"])
    res = tm.evaluate({"x": pairs, "y": labels}, batch_size=64,
                      verbose=False)
    assert set(res) == {"accuracy", "loss", "num_samples"}
    probs = tm.predict(pairs[:10])
    assert probs.shape == (10, 2)
    np.testing.assert_allclose(probs.sum(-1), np.ones(10), rtol=1e-3)
    recs = tm.recommend_for_user(pairs[:50], max_items=3)
    assert set(recs) == set(np.unique(pairs[:50, 0]).tolist())
    scores = tm.predict(pairs[:50])[:, -1]
    for user, ranked in recs.items():
        assert 0 < len(ranked) <= 3
        assert [s for _, s in ranked] == sorted([s for _, s in ranked],
                                                reverse=True)
        mine = pairs[:50, 0] == user
        assert ranked[0][1] == pytest.approx(scores[mine].max())


def test_neuralcf_legacy_checkpoint_migration(tmp_path):
    """The twin of tests/test_batch3_components.py::
    test_neuralcf_legacy_checkpoint_migration: a pre-fusion checkpoint
    (separate mlp_*/mf_* embedding tables) loads into the fused layout."""
    widths = dict(user_count=20, item_count=15, class_num=2, user_embed=4,
                  item_embed=4, hidden_layers=(8,), mf_embed=3)
    model = NeuralCF(device="cpu", **widths)
    model.compile(loss="sparse_categorical_crossentropy", optimizer="adam")
    pairs = np.stack([np.arange(10) % 19 + 1, np.arange(10) % 14 + 1],
                     -1).astype(np.int32)
    y = (np.arange(10) % 2).astype(np.int64)
    model.fit({"x": pairs, "y": y}, epochs=1, batch_size=10, verbose=False)
    expected = model.predict(pairs)

    # de-fuse the trained state into the legacy layout and save it
    state = model.estimator.engine.get_state()
    params = dict(state["params"])
    u = params.pop("user_embed_table")
    i = params.pop("item_embed_table")
    params["mlp_user_embed.embedding"] = u[:, :4].clone()
    params["mf_user_embed.embedding"] = u[:, 4:].clone()
    params["mlp_item_embed.embedding"] = i[:, :4].clone()
    params["mf_item_embed.embedding"] = i[:, 4:].clone()
    path = str(tmp_path / "legacy.pt")
    torch.save(dict(state, params=params), path)

    model2 = NeuralCF(device="cpu", seed=3, **widths)
    model2.compile(loss="sparse_categorical_crossentropy", optimizer="adam")
    model2.load(path)
    np.testing.assert_allclose(model2.predict(pairs), expected,
                               rtol=1e-5, atol=1e-6)
    migrated, _ = NeuralCF.migrate_legacy_state(
        model2.estimator.engine.get_state())
    assert not migrated
    # training goes on from the migrated weights with fresh moments
    model2.fit({"x": pairs, "y": y}, epochs=1, batch_size=10,
               verbose=False)
