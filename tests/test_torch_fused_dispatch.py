"""Fused dispatch (config ``steps_per_dispatch``) of the port's estimator
against the JAX package's, on the CPU.

The JAX ``TPUEstimator`` fuses k train (or eval) steps into one
``lax.scan`` dispatch; the port runs them as one CUDA-graph replay on the
card and, here on the CPU, as k eager steps in a loop. Both must keep the
per-step loop's semantics: the same trajectory, the same step count with a
ragged tail, checkpoints, TensorBoard steps and preemption at group
boundaries, and an ``"auto"`` probe that leaves no trace.

Each comparison with JAX starts from the same weights (the flax init
bridged through ``interop``) on numpy-seeded data, at the same pinned k.
Tolerances: within the port, a fused run equals its ``steps_per_dispatch:
1`` run bit for bit (the CPU group is those steps). Against JAX, final
parameters, losses and metrics at rtol/atol 1e-5 (tests/test_torch_ncf.py's
f32 tolerance; f32 on both sides, JAX's matmuls at ``highest``: the two
frameworks round the same f32 sums in different orders, and Adam's
normalised steps carry that to 2e-6 in a parameter after 32 steps at lr
1e-2); the Zouwu forecaster keeps its suite's 1e-5 relative, the fraud
MLP its 2e-4.
"""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from analytics_zoo_tpu.orca.learn import utils as jutils
from analytics_zoo_tpu.orca.learn.estimator import TPUEstimator as JEstimator
from analytics_zoo_tpu.orca.learn.optimizers import optimizers_impl as jopt
from analytics_zoo_tpu.orca.learn.optimizers import schedule as jsched
from analytics_zoo_tpu.orca.learn.trigger import MinLoss as JMinLoss
from analytics_zoo_tpu.orca.learn.trigger import \
    SeveralIteration as JSeveralIteration
from analytics_zoo_tpu.orca.learn.trigger import TriggerOr as JTriggerOr
from analytics_zoo_tpu.resilience import faults as jfaults
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.orca.learn import utils as tutils
from analytics_zoo_tpu_torch.orca.learn.estimator import \
    TPUEstimator as TEstimator
from analytics_zoo_tpu_torch.orca.learn.optimizers import \
    optimizers_impl as topt
from analytics_zoo_tpu_torch.orca.learn.optimizers import schedule as tsched
from analytics_zoo_tpu_torch.orca.learn.trigger import (MinLoss,
                                                        SeveralIteration,
                                                        TriggerOr)
from analytics_zoo_tpu_torch.resilience import faults as tfaults

TOL = dict(rtol=1e-5, atol=1e-5)


def _data(n=512, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 4).astype(np.float32)
    y = x @ np.array([1.0, -2.0, 3.0, 0.5], np.float32) + 0.1
    return {"x": x, "y": y.astype(np.float32)}


def _flax_mlp():
    import flax.linen as fnn

    class MLP(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            h = fnn.relu(fnn.Dense(8)(x))
            return fnn.Dense(1)(h)[:, 0]

    return MLP()


class TorchMLP(nn.Module):
    """The flax MLP's layout (``Dense_0``, ``Dense_1``), for ``interop``."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(4, 8)
        self.Dense_1 = nn.Linear(8, 1)

    def forward(self, x):
        return self.Dense_1(torch.relu(self.Dense_0(x)))[:, 0]


def _jax_est(k, optimizer=None, **kw):
    est = JEstimator(_flax_mlp(), loss="mse",
                     optimizer=optimizer or jopt.Adam(lr=1e-2),
                     config={"steps_per_dispatch": k}, **kw)
    est.engine.build((np.zeros((1, 4), np.float32),))
    return est


def _port_est(jest, k, optimizer=None, **kw):
    """The port's estimator holding ``jest``'s initial weights."""
    module = interop.load_flax_params(
        TorchMLP(), jax.device_get(jest.engine.params))
    cfg = {} if k is None else {"steps_per_dispatch": k}
    return TEstimator(module, loss="mse",
                      optimizer=optimizer or topt.Adam(lr=1e-2),
                      device="cpu", config=cfg, **kw)


def _twin(port, k):
    """A second port estimator from ``port``'s initial weights (taken
    before it trains) at fuse ``k``."""
    module = TorchMLP()
    module.load_state_dict(port.module.state_dict())
    cfg = {} if k is None else {"steps_per_dispatch": k}
    return TEstimator(module, loss=port.loss_fn,
                      optimizer=port.engine.make_optimizer, device="cpu",
                      config=cfg)


def _params(est):
    return {n: t.clone() for n, t in est.module.state_dict().items()}


def _assert_bitwise(a, b):
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name


def _assert_matches_jax(test, jest):
    want = interop.flax_to_state_dict(jax.device_get(jest.engine.params))
    got = test.module.state_dict()
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)


# --- the iterator ----------------------------------------------------------

@pytest.mark.parametrize("fuse,pad_tail", [(2, True), (3, True), (4, False)])
def test_fused_batch_stream_matches_jax_and_single_batches(orca_context,
                                                           fuse, pad_tail):
    """``epoch(fuse=k)``: superbatches ``(k, batch, ...)`` of full batches,
    then the ragged tail as single batches; stacking only reshapes, so the
    stream equals the single batches' and the JAX package's bit for bit,
    inline and through the pump."""
    base = _data(5 * 16 + 7)
    data = {"x": (base["x"], np.arange(87, dtype=np.int64)),
            "y": (base["y"],)}
    want = list(jutils.BatchIterator(
        jutils.chunk_shards(jutils.xshards_from_arrays(data)), 16,
        orca_context.mesh, shuffle=True, seed=3, pad_tail=pad_tail
    )._host_batches(True, fuse))
    it = tutils.BatchIterator(tutils.xshards_from_arrays(data), 16,
                              shuffle=True, seed=3, pad_tail=pad_tail,
                              device=torch.device("cpu"))
    singles = tutils.BatchIterator(tutils.xshards_from_arrays(data), 16,
                                   shuffle=True, seed=3, pad_tail=pad_tail,
                                   device=torch.device("cpu"))
    for prefetch in (False, True):
        got = list(it.epoch(prefetch=prefetch, fuse=fuse))
        assert [b.fused for b in got] == [getattr(b, "fused", 1)
                                          for b in want]
        for g, w in zip(got, want):
            assert (g.w is None) == (w.w is None)
            wl = list(w.x) + list(w.y) + ([] if w.w is None else [w.w])
            for a, b in zip(g.leaves(), wl):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        flat = []
        for g in got:
            flat.extend([tuple(t[i] for t in g.leaves())
                         for i in range(g.fused)] if g.fused > 1
                        else [tuple(g.leaves())])
        one = list(singles.epoch(prefetch=prefetch))
        assert len(flat) == len(one) == it.steps_per_epoch
        for f, o in zip(flat, one):
            for a, b in zip(f, o.leaves()):
                assert torch.equal(a, b)
        it._epoch = singles._epoch = 0


def test_fused_staging_is_bounded_in_bytes():
    """A superbatch's pinned ring holds at most FUSED_STAGING_BYTES (and at
    least the one-worker, one-lane pump's window), and a fused epoch's pump
    runs one transfer lane."""
    from analytics_zoo_tpu_torch.native import infeed
    from analytics_zoo_tpu_torch.native import transfer as xfer
    assert xfer.fused_ring(tutils.MAX_GROUP_BYTES) == xfer.FUSED_MIN_RING
    assert xfer.fused_ring(tutils.MAX_GROUP_BYTES) * \
        tutils.MAX_GROUP_BYTES <= xfer.FUSED_STAGING_BYTES
    assert xfer.fused_ring(1 << 20) == 1024
    assert xfer.fused_ring(0) > 0
    pump = infeed.InfeedPump(lambda: iter(()), device_put=None, max_lanes=1)
    assert pump._lanes == pump._max_lanes == 1


def test_auto_fuse_factor_matches_jax():
    """``auto_fuse_factor`` is the JAX package's function: equal over a
    grid of step times, compute estimates, epoch lengths and batch
    bytes."""
    assert tutils.MAX_GROUP_BYTES == jutils.MAX_GROUP_BYTES
    assert tutils.ASSUMED_TRAIN_MFU == jutils.ASSUMED_TRAIN_MFU
    n = 0
    for step_s in (2e-6, 1e-5, 3e-4, 1e-3, 4e-3, 9.9e-3, 1e-2, 0.05):
        for compute_s in (None, 1e-6, 2e-4, 5e-3, 1e-2, 0.1):
            for spe in (1, 2, 7, 100, 1000):
                for bb in (0, 1 << 10, 3 << 20, 300 << 20):
                    got = tutils.auto_fuse_factor(step_s, spe, bb, compute_s)
                    want = jutils.auto_fuse_factor(step_s, spe, bb,
                                                   compute_s)
                    assert got == want, (step_s, compute_s, spe, bb)
                    n += 1
    assert n == 960


def test_step_compute_estimate_is_none_on_the_cpu():
    """As the JAX function without a peak: no estimate on the CPU, and the
    step is not run."""
    ran = []
    assert tutils.estimate_step_compute_s(lambda: ran.append(1),
                                          torch.device("cpu")) is None
    assert ran == []
    assert tutils.peak_flops(torch.device("cpu")) == 0.0


def test_step_compute_estimate_counts_flops_by_type(monkeypatch):
    """With a peak table (the card's, here a stand-in on the CPU): each
    counted operation's FLOPs over its own type's peak, over the assumed
    MFU; a float32 matmul takes the float32 rate with TF32 off (the
    port's default) and the TF32 rate with it on."""
    peaks = {"bfloat16": 4e12, "tf32": 2e12, "float32": 1e12}
    monkeypatch.setattr(tutils, "peak_flops",
                        lambda device, kind="bfloat16": peaks.get(kind, 0.0))
    a, b = torch.randn(64, 32), torch.randn(32, 16)
    mm_flops = 2 * 64 * 32 * 16

    def step():
        (a @ b).sum()
        (a.bfloat16() @ b.bfloat16()).sum()
        (a + 1.0).relu()                        # not a counted op
    got = tutils.estimate_step_compute_s(step, torch.device("cpu"))
    want = (mm_flops / 1e12 + mm_flops / 4e12) / tutils.ASSUMED_TRAIN_MFU
    assert got == pytest.approx(want, rel=1e-12)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    got = tutils.estimate_step_compute_s(step, torch.device("cpu"))
    want = (mm_flops / 2e12 + mm_flops / 4e12) / tutils.ASSUMED_TRAIN_MFU
    assert got == pytest.approx(want, rel=1e-12)


# --- fit --------------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 8])
def test_fused_fit_matches_sequential_and_jax(orca_context, k):
    """k steps a dispatch: the same steps and parameters as the port's
    per-step run (bit for bit) and as the JAX estimator's at the same k."""
    data = _data(1024)
    jest = _jax_est(k)
    test = _port_est(jest, k)
    seq = _twin(test, 1)
    jest.fit(data, epochs=2, batch_size=64, verbose=False)
    stats = test.fit(data, epochs=2, batch_size=64, verbose=False)
    seq_stats = seq.fit(data, epochs=2, batch_size=64, verbose=False)
    assert test.fuse == k and seq.fuse == 1
    assert test.engine.step == seq.engine.step == jest.engine.step == 32
    assert [s["train_loss"] for s in stats] == \
        [s["train_loss"] for s in seq_stats]
    _assert_bitwise(_params(test), _params(seq))
    _assert_matches_jax(test, jest)


def test_fused_ragged_tail_runs_single_steps(orca_context):
    """5 full batches + 17 rows at k = 2: two fused groups, one full single
    batch and one padded one, 6 steps, in both packages; the trajectory is
    the per-step run's."""
    data = _data(64 * 5 + 17)
    jest = _jax_est(2, optimizer=jopt.SGD(learningrate=0.05, momentum=0.9))
    test = _port_est(jest, 2, topt.SGD(learningrate=0.05, momentum=0.9))
    seq = _twin(test, 1)
    seen = []
    inner = test.engine.train_batch_group
    test.engine.train_batch_group = lambda b: seen.append(b.fused) or \
        inner(b)
    for est in (jest, test, seq):
        est.fit(data, epochs=1, batch_size=64, verbose=False)
    assert seen == [2, 2]
    assert test.engine.step == seq.engine.step == jest.engine.step == 6
    _assert_bitwise(_params(test), _params(seq))
    _assert_matches_jax(test, jest)


def test_auto_probe_rolls_back(orca_context):
    """``"auto"`` probes with real steps and rolls them back: after
    shuffled epochs the step count, the parameters and the shuffle order
    are a pinned-1 run's, bit for bit (and JAX's auto run's)."""
    data = _data(512)
    jest = _jax_est(1)
    jest.config.pop("steps_per_dispatch")
    test = _port_est(jest, None)
    pinned = _twin(test, 1)
    orders = {"auto": [], "pinned": []}
    for key, est in (("auto", test), ("pinned", pinned)):
        inner_one = est.engine.train_batch
        inner_group = est.engine.train_batch_group

        def one(b, inner=inner_one, key=key):
            orders[key].append(b.x[0].numpy().copy())
            return inner(b)

        def group(b, inner=inner_group, key=key):
            orders[key].extend(a.numpy().copy() for a in b.x[0])
            return inner(b)
        est.fit(data, epochs=1, batch_size=64, verbose=False)   # probes
        est.engine.train_batch, est.engine.train_batch_group = one, group
        est.fit(data, epochs=2, batch_size=64, shuffle=True, verbose=False)
    jest.fit(data, epochs=1, batch_size=64, verbose=False)
    jest.fit(data, epochs=2, batch_size=64, shuffle=True, verbose=False)
    assert test._fuse_probe_cache, "the auto fit did not probe"
    assert test.probe_steps > 0
    assert test.engine.step == pinned.engine.step == jest.engine.step == 24
    assert len(orders["auto"]) == len(orders["pinned"]) == 16
    for a, b in zip(orders["auto"], orders["pinned"]):
        np.testing.assert_array_equal(a, b)
    _assert_bitwise(_params(test), _params(pinned))
    _assert_matches_jax(test, jest)


def test_a_new_optimizer_drops_the_captured_graphs():
    """A captured graph writes into its optimizer's state and lr tensors,
    so ``build`` of a new optimizer (after ``NeuralCF.load`` of a migrated
    checkpoint drops the old one) drops every graph, and a graph's key
    names no optimizer. No group captures on the CPU, so a stand-in takes
    a graph's place in the engine's table."""
    est = TEstimator(TorchMLP(), loss="mse", optimizer=topt.Adam(lr=1e-2),
                     device="cpu", config={"steps_per_dispatch": 2})
    est.fit(_data(128), epochs=1, batch_size=32, verbose=False)
    eng = est.engine
    first = eng.opt
    group = tutils.Batch(x=(torch.zeros(2, 32, 4),), y=(torch.zeros(2, 32),),
                         w=None, fused=2)
    key = eng._signature("train", group)
    eng._graphs[key] = object()
    eng.build()                 # the optimizer exists: the graph stays
    assert eng.opt is first and key in eng._graphs
    eng.opt = None
    eng.build()
    assert eng.opt is not first and eng._graphs == {}
    assert eng._signature("train", group) == key


@pytest.mark.parametrize("make", [
    lambda s: s.Exponential(7, 0.8), lambda s: s.Exponential(7, 0.8, True),
    lambda s: s.Exponential(50, 0.5), lambda s: s.Step(25, 0.5),
    lambda s: s.MultiStep([0, 40, 40, 110, 250], 0.3),
    lambda s: s.Plateau("score", factor=0.5),
    lambda s: s.SequentialSchedule().add(s.Warmup(0.01), 20).add(
        s.Exponential(10, 0.9, True), 280)])
def test_schedule_lr_matches_optax(make):
    """Each schedule's ``lr_at(step)`` equals the JAX class's optax
    schedule at every one of 300 steps. JAX evaluates ``rate ** p`` in
    float32: the rate's own rounding (1.5e-8 of 0.8) grows p-fold, and
    the exponent's and the power's add ~1e-7, 1.05e-6 of the lr at step
    299 of Exponential(7, 0.8) (p = 42.7): held at 2e-6 relative."""
    fn = make(jsched).to_optax(0.2)
    sched = make(tsched)
    steps = range(300)
    want = np.asarray([float(fn(k)) for k in steps])
    got = np.asarray([sched.lr_at(k, 0.2) for k in steps])
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)


def test_adam_decay_lr_matches_jax():
    """Adam's ``decay``: the JAX class's lr function, schedule(step) / (1 +
    decay * step), at every one of 300 steps, over a constant lr and over
    a schedule."""
    for sched in (None, "step"):
        kw = dict(lr=0.01, decay=0.05)
        j = jopt.Adam(**kw, schedule=jsched.Step(30, 0.5) if sched else None)
        t = topt.Adam(**kw, schedule=tsched.Step(30, 0.5) if sched else None)
        base = j._lr_schedule()
        want = [float(base(jnp.int32(k)) / (1.0 + j.decay * jnp.int32(k)))
                for k in range(300)]
        got = [t.to_torch().lr_at(k) for k in range(300)]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert topt.Adam(lr=0.01).to_torch().lr_at is None


@pytest.mark.parametrize("name", ["exponential", "exponential_stair",
                                  "step", "multistep", "plateau",
                                  "adam_decay"])
def test_scheduled_fit_matches_jax(orca_context, name):
    """A fit with each schedule (and Adam's decay) at k = 2: the lr a fused
    group applies at each step is the per-step loop's (bit for bit) and
    the JAX estimator's (the final parameters agree); Plateau trains at
    its constant lr, as JAX's does."""
    def opt(sched, o):
        if name == "adam_decay":
            return o.Adam(lr=0.05, decay=0.3)
        return o.SGD(learningrate=0.1, momentum=0.9,
                      leaningrate_schedule=sched)
    scheds = {"exponential": lambda s: s.Exponential(3, 0.7),
              "exponential_stair": lambda s: s.Exponential(3, 0.7, True),
              "step": lambda s: s.Step(4, 0.5),
              "multistep": lambda s: s.MultiStep([5, 11], 0.3),
              "plateau": lambda s: s.Plateau("score", patience=0),
              "adam_decay": lambda s: None}
    data = _data(640)
    jest = _jax_est(2, optimizer=opt(scheds[name](jsched), jopt))
    test = _port_est(jest, 2, opt(scheds[name](tsched), topt))
    seq = _twin(test, 1)
    for est in (jest, test, seq):
        est.fit(data, epochs=2, batch_size=64, verbose=False)
    assert test.engine.step == seq.engine.step == jest.engine.step == 20
    _assert_bitwise(_params(test), _params(seq))
    _assert_matches_jax(test, jest)
    lr_at = test.engine.lr_at
    lrs = [lr_at(s) for s in range(20)]
    if name == "plateau":
        assert lrs == [0.1] * 20
    else:
        assert len(set(lrs)) > 1


# --- evaluate ---------------------------------------------------------------

def test_fused_evaluate_matches_sequential_and_jax(orca_context):
    """Fused evaluation, ragged tail included: equal to the per-step loop
    bit for bit (per-step sums in step order) and to JAX's fused
    evaluate."""
    data = _data(64 * 5 + 17)
    jest = _jax_est(2, optimizer=jopt.SGD(learningrate=0.05),
                    metrics=["mae"])
    test = _port_est(jest, 2, topt.SGD(learningrate=0.05), metrics=["mae"])
    fused = test.evaluate(data, batch_size=64, verbose=False)
    assert test.eval_fuse == 2
    test.config["steps_per_dispatch"] = 1
    seq = test.evaluate(data, batch_size=64, verbose=False)
    assert test.eval_fuse == 1
    assert fused == seq
    assert fused["num_samples"] == 64 * 5 + 17
    want = jest.evaluate(data, batch_size=64, verbose=False)
    for key in ("loss", "mae"):
        np.testing.assert_allclose(fused[key], want[key], **TOL)


def test_eval_probe_runs_once_across_fit_with_validation(orca_context):
    """``fit(validation_data=)`` evaluates every epoch: the eval probe runs
    once, its k cached per input signature."""
    data = _data(512)
    test = _port_est(_jax_est(1), None, metrics=["mae"])
    calls = []
    real = test._auto_probe_eval_fuse
    test._auto_probe_eval_fuse = lambda *a: calls.append(1) or real(*a)
    stats = test.fit(data, epochs=3, batch_size=64, validation_data=data,
                     verbose=False)
    assert calls == [1]
    assert all(np.isfinite(s["val_mae"]) for s in stats)


# --- checkpoints, failures, preemption, TensorBoard --------------------------

def _ckpt_steps(root):
    return sorted(int(d.split("-")[1]) for d in os.listdir(root)
                  if d.startswith("ckpt-"))


def test_composite_trigger_caps_fuse_and_checkpoints_like_jax(
        orca_context, tmp_path):
    """``TriggerOr(SeveralIteration(4), MinLoss(-1))`` caps a pinned k of
    64 at 4, so checkpoints land every 4 steps, at JAX's steps."""
    data = _data(512)
    jest = _jax_est(64, optimizer=jopt.SGD(learningrate=0.05),
                    model_dir=str(tmp_path / "jax"))
    test = _port_est(jest, 64, topt.SGD(learningrate=0.05),
                     model_dir=str(tmp_path / "port"))
    jest.fit(data, epochs=2, batch_size=64, verbose=False,
             checkpoint_trigger=JTriggerOr(JSeveralIteration(4),
                                           JMinLoss(-1.0)))
    test.fit(data, epochs=2, batch_size=64, verbose=False,
             checkpoint_trigger=TriggerOr(SeveralIteration(4),
                                          MinLoss(-1.0)))
    assert test.fuse == 4
    got = _ckpt_steps(tmp_path / "port")
    assert got == _ckpt_steps(tmp_path / "jax")
    assert got[-1] == 16 and {4, 8, 12, 16} <= set(got)
    _assert_matches_jax(test, jest)


def test_failure_in_a_fused_group_retries_from_the_checkpoint(
        orca_context, tmp_path):
    """A fault injected into the 6th fused dispatch (epoch 2's second
    group): the epoch is retried from epoch 1's checkpoint and the fit
    ends at the uninterrupted run's step with its parameters, bit for bit
    (as the JAX estimator ends at its step)."""
    data = _data(512)
    jest = _jax_est(2, model_dir=str(tmp_path / "jax"))
    test = _port_est(jest, 2, model_dir=str(tmp_path / "port"))
    clean = _twin(test, 2)
    with jfaults.inject("engine.dispatch", count=1, skip=5):
        jest.fit(data, epochs=3, batch_size=64, shuffle=False,
                 verbose=False, checkpoint_trigger="every_epoch")
    with tfaults.inject("engine.dispatch", count=1, skip=5) as reg:
        test.fit(data, epochs=3, batch_size=64, shuffle=False,
                 verbose=False, checkpoint_trigger="every_epoch")
    assert reg.snapshot()["engine.dispatch"]["fired"] == 1
    clean.fit(data, epochs=3, batch_size=64, shuffle=False, verbose=False)
    assert test.engine.step == clean.engine.step == jest.engine.step == 24
    _assert_bitwise(_params(test), _params(clean))


def test_sigterm_stops_at_a_group_boundary(orca_context, tmp_path):
    """SIGTERM raised at iteration >= 10 is seen at the next group
    boundary (12 at k = 4): the fit checkpoints ``ckpt-12`` and returns,
    as the JAX estimator does."""
    data = _data(512)

    def sigterm_at(base):
        class _SigtermAt(base):
            fired = False

            def __call__(self, state):
                if state.iteration >= 10 and not self.fired:
                    self.fired = True
                    os.kill(os.getpid(), signal.SIGTERM)
                return False
        return _SigtermAt(10_000)

    stops = []
    jest = _jax_est(4, model_dir=str(tmp_path / "jax"))
    test = _port_est(jest, 4, model_dir=str(tmp_path / "port"))
    for est, base, root in ((jest, JSeveralIteration, "jax"),
                            (test, SeveralIteration, "port")):
        stats = est.fit(data, epochs=50, batch_size=64, verbose=False,
                        checkpoint_trigger=sigterm_at(base))
        assert stats[-1].get("preempted") is True
        stops.append(est.engine.step)
        assert f"ckpt-{est.engine.step}" in os.listdir(tmp_path / root)
    assert stops == [12, 12]


def test_tensorboard_loss_steps_match_jax(orca_context, tmp_path):
    """TensorBoard ``Loss`` has one point per step, fused or not, at JAX's
    steps and values."""
    data = _data(64 * 5 + 17)
    jest = _jax_est(2)
    test = _port_est(jest, 2)
    jest.set_tensorboard(str(tmp_path), "jax")
    test.set_tensorboard(str(tmp_path), "port")
    jest.fit(data, epochs=2, batch_size=64, verbose=False)
    test.fit(data, epochs=2, batch_size=64, verbose=False)
    want = jest.get_train_summary("Loss")
    got = test.get_train_summary("Loss")
    assert [s for s, _ in got] == [s for s, _ in want] == list(range(1, 13))
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               **TOL)


def test_profile_counts_steps_not_dispatches(orca_context):
    """``fit(profile=True)`` at k = 4: one time per step."""
    test = _port_est(_jax_est(1), 4)
    stats = test.fit(_data(512), epochs=1, batch_size=64, verbose=False,
                     profile=True)
    prof = stats[0]["profile"]
    assert prof["steps"] == len(prof["step_ms"]) == 8


# --- the zoo models' paths ---------------------------------------------------

def test_ncf_fused_fit_matches_jax(orca_context):
    """NeuralCF through ``NeuralCF.fit`` at k = 2 (``compile(config=)``
    passes the key through, as in the JAX package): JAX's parameters at
    NCF's f32 tolerance, and the port's per-step run bit for bit."""
    from analytics_zoo_tpu.models.recommendation import NeuralCF as JNCF
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    widths = dict(user_count=50, item_count=30, class_num=2, user_embed=8,
                  item_embed=8, hidden_layers=(16, 8), mf_embed=8)
    rng = np.random.RandomState(0)
    pairs = np.stack([rng.randint(1, 50, 320), rng.randint(1, 30, 320)],
                     -1).astype(np.int32)
    labels = (pairs.sum(-1) % 2).astype(np.int64)
    jm = JNCF(compute_dtype=jnp.float32, **widths)
    jm.compile(loss="sparse_categorical_crossentropy",
               optimizer=jopt.Adam(lr=1e-3),
               config={"steps_per_dispatch": 2})
    jm.estimator.engine.build((pairs[:1],))
    params = jax.device_get(jm.estimator.engine.params)
    tms = []
    for k in (2, 1):
        tm = NeuralCF(compute_dtype=torch.float32, device="cpu", **widths)
        interop.load_flax_params(tm.module, params)
        tm.compile(loss="sparse_categorical_crossentropy",
                   optimizer=topt.Adam(lr=1e-3),
                   config={"steps_per_dispatch": k})
        tms.append(tm)
    kw = dict(epochs=2, batch_size=64, shuffle=True, verbose=False)
    jm.fit({"x": pairs, "y": labels}, **kw)
    for tm in tms:
        tm.fit({"x": pairs, "y": labels}, **kw)
    assert tms[0].estimator.fuse == 2
    _assert_bitwise(tms[0].estimator.get_model(), tms[1].estimator.get_model())
    want = interop.flax_to_state_dict(
        jax.device_get(jm.estimator.engine.params))
    got = tms[0].estimator.get_model()
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   err_msg=key, rtol=1e-5, atol=1e-5)


def test_lstm_forecaster_fused_fit_matches_jax(orca_context):
    """A Zouwu LSTM forecaster at k = 4 (set on its estimator's config):
    JAX's at dropout 0 (the suite's 1e-5 relative); with dropout 0.2, the
    port's fused run equals its per-step run bit for bit (each step
    reseeds the engine's generator, fused or not)."""
    from analytics_zoo_tpu.zouwu.model import forecast as jforecast
    from analytics_zoo_tpu_torch.zouwu.model import forecast as tforecast
    rng = np.random.RandomState(0)
    x = rng.randn(128, 12, 3).astype(np.float32)
    y = x[:, -1:, :1].sum(-1) * 0.5
    kw = dict(target_dim=1, feature_dim=3, lstm_units=(8, 4), lr=1e-3)
    jf = jforecast.LSTMForecaster(dropouts=0.0, **kw)
    jf.estimator.config["steps_per_dispatch"] = 4
    jf.estimator.engine.build((x[:1],))
    params = jax.device_get(jf.estimator.engine.params)
    runs = {}
    for drop in (0.0, 0.2):
        for k in (4, 1):
            tf = tforecast.LSTMForecaster(device="cpu", dropouts=drop, **kw)
            interop.load_flax_params(tf.module, params)
            tf.estimator.config["steps_per_dispatch"] = k
            stats = tf.fit(x, y, epochs=2, batch_size=32)
            assert tf.estimator.fuse == k
            runs[drop, k] = (stats, _params(tf.estimator))
    jstats = jf.fit(x, y, epochs=2, batch_size=32)
    for drop in (0.0, 0.2):
        _assert_bitwise(runs[drop, 4][1], runs[drop, 1][1])
    for a, b in zip(runs[0.0, 4][0], jstats):
        assert abs(a["train_loss"] - b["train_loss"]) <= \
            1e-5 * abs(b["train_loss"])
    want = interop.flax_to_state_dict(jax.device_get(jf.estimator.engine.params))
    got = runs[0.0, 4][1]
    for key in want:
        err = np.abs(got[key].numpy() - want[key].numpy()).max()
        assert err <= 1e-5 * max(np.abs(want[key].numpy()).max(), 1.0), key


def test_fraud_mlp_nnestimator_fused_fit_matches_jax(orca_context):
    """The fraud MLP (29 -> 32 -> 16 -> 1) through ``NNEstimator.fit`` at
    k = 4 (the key set on the estimator ``fit`` builds): JAX's weights and
    predictions at 2e-4 (tests/test_torch_nnframes.py's tolerance), and
    the port's per-step run bit for bit."""
    import pandas as pd

    from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSeq
    from analytics_zoo_tpu.pipeline.api.keras import layers as JL
    from analytics_zoo_tpu.pipeline.nnframes import NNEstimator as JNNE
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential as TSeq
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
    from analytics_zoo_tpu_torch.pipeline.nnframes import NNEstimator

    rng = np.random.RandomState(0)
    yv = (rng.rand(640) < 0.1).astype(np.float32)
    xv = rng.randn(640, 29).astype(np.float32)
    xv[yv == 1, :5] += 1.5
    df = pd.DataFrame({"features": list(xv), "label": yv})

    def mlp(L):
        return [L.Dense(32, activation="relu"),
                L.Dense(16, activation="relu"),
                L.Dense(1, activation="sigmoid")]
    jmod = JSeq(mlp(JL)).to_module()
    jbuild = JEstimator(jmod, loss="binary_crossentropy")
    jbuild.engine.build((np.zeros((1, 29), np.float32),))
    params = jax.device_get(jbuild.engine.params)

    def pinned(nn_est, k):
        make = nn_est._make_estimator

        def build():
            est = make()
            est.config["steps_per_dispatch"] = k
            return est
        nn_est._make_estimator = build
        return nn_est.setBatchSize(64).setMaxEpoch(2)

    jmodel = pinned(JNNE(jmod, "binary_crossentropy"), 4).fit(df)
    tmodels = []
    for k in (4, 1):
        tmod = TSeq(mlp(TL), device="cpu").to_module()
        interop.load_flax_params(tmod, params)
        tmodels.append(pinned(NNEstimator(tmod, "binary_crossentropy",
                                          device="cpu"), k).fit(df))
    assert tmodels[0].estimator.fuse == 4
    _assert_bitwise(_params(tmodels[0].estimator),
                    _params(tmodels[1].estimator))
    want = np.stack(jmodel.transform(df[:100])["prediction"].to_numpy())
    got = np.stack(tmodels[0].transform(df[:100])["prediction"].to_numpy())
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert tmodels[0].estimator.engine.step == 20
