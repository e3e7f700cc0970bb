"""The port's AutoML (``analytics_zoo_tpu_torch/automl``) on the CPU against
the JAX package's: the hp DSL and the engine's trial list per seed (equal
values), the GP-EI picker (equal suggestions), ``TrialModel.fit_eval``
from bridged weights (scores and weights at 1e-5 relative; a resumed run
equals an uninterrupted one bit for bit), the optimizer names'
mapping onto optax's rules, device leases, ``stop_score``,
``AutoEstimator`` and the device rule.

f32 on both sides, TF32 off, JAX at "highest" matmul precision."""

import sys
import threading
import time

import jax
import numpy as np
import optax
import pytest
import torch
from torch import nn

from analytics_zoo_tpu.automl import hp as jhp
from analytics_zoo_tpu.automl import model_builder as jmb
from analytics_zoo_tpu.automl.search import bayes as jbayes
from analytics_zoo_tpu.automl.search.search_engine import \
    TPUSearchEngine as JEngine
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.automl import AutoEstimator, ModelBuilder
from analytics_zoo_tpu_torch.automl import auto_estimator as tae
from analytics_zoo_tpu_torch.automl import hp as thp
from analytics_zoo_tpu_torch.automl.scheduler import (DeviceLeaseManager,
                                                      LeaseTimeout)
from analytics_zoo_tpu_torch.automl.search import bayes as tbayes
from analytics_zoo_tpu_torch.automl.search.search_engine import \
    TPUSearchEngine as TEngine
from analytics_zoo_tpu_torch.common import context as tctx

TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _space(hp):
    return {"lr": hp.loguniform(1e-4, 1e-1),
            "hidden": hp.choice([8, 16, 32]),
            "units": hp.randint(1, 5),
            "drop": hp.quniform(0.1, 0.5, 0.1),
            "scale": hp.qloguniform(1, 100, 5),
            "noise": hp.randn(0.0, 2.0),
            "step": hp.qrandn(1.0, 3.0, 0.5),
            "wide": hp.qrandint(0, 20, 4),
            "u": hp.uniform(-1, 1),
            "pair": hp.sample_from(lambda rng: [int(rng.choice([4, 8])),
                                                float(rng.rand())]),
            "nested": {"a": hp.choice(["x", "y"]), "b": 3},
            "batch_size": hp.grid_search([16, 32]),
            "layers": hp.grid_search([1, 2, 3]),
            "const": 7}


@pytest.mark.parametrize("seed", [0, 1, 7, 42])
def test_hp_sample_and_grid_equal_jax(seed):
    js, ts = _space(jhp), _space(thp)
    jg, tg = jhp.grid_configs(js), thp.grid_configs(ts)
    assert len(tg) == len(jg) == 6
    jrng, trng = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(5):
        want = [jhp.sample_config(g, jrng) for g in jg]
        got = [thp.sample_config(g, trng) for g in tg]
        assert got == want


def test_engine_compiles_the_jax_trial_list():
    """The same space and seed give the same trials, in order."""
    for seed, n in ((42, 3), (0, 2)):
        kw = dict(n_sampling=n, epochs=2, metric="mse")
        je = JEngine(seed=seed).compile(None, None, _space(jhp), **kw)
        te = TEngine(seed=seed, device="cpu").compile(None, None,
                                                      _space(thp), **kw)
        assert [(t.trial_id, t.config, t.state) for t in te._trials] == \
            [(t.trial_id, t.config, t.state) for t in je._trials]
        assert len(te._trials) == 6 * n


def test_gp_ei_picker_equal_to_jax():
    space = {"lr": 0, "u": 0}
    js = {"lr": jhp.loguniform(1e-4, 1e-1), "u": jhp.uniform(0, 4),
          "k": jhp.randint(1, 9), "c": jhp.choice([1, 2])}
    ts = {"lr": thp.loguniform(1e-4, 1e-1), "u": thp.uniform(0, 4),
          "k": thp.randint(1, 9), "c": thp.choice([1, 2])}
    jc, tc = jbayes.SpaceCodec(js), tbayes.SpaceCodec(ts)
    assert tc.dim == jc.dim == 3
    jp, tp = jbayes.GPEIPicker(3), tbayes.GPEIPicker(3)
    rng = np.random.RandomState(3)
    for i in range(6):
        cfg = thp.sample_config(ts, rng)
        x = tc.encode(cfg)
        np.testing.assert_array_equal(x, jc.encode(cfg))
        y = float(np.sin(3 * x).sum()) if i != 2 else float("inf")
        jp.observe(x, y)
        tp.observe(x, y)
        a, b = (p.suggest(np.random.RandomState(i)) for p in (jp, tp))
        np.testing.assert_array_equal(a, b)
        assert tc.decode_into(b, dict(space)) == jc.decode_into(a, dict(space))


# --- TrialModel.fit_eval against JAX's ---------------------------------------

class _MLP(nn.Module):
    """flax's names: Dense_0, Dense_1."""

    def __init__(self, n_in=4, hidden=8):
        super().__init__()
        self.Dense_0 = nn.Linear(n_in, hidden)
        self.Dense_1 = nn.Linear(hidden, 1)

    def forward(self, x):
        return self.Dense_1(torch.relu(self.Dense_0(x)))


def _data(n=96, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 4).astype(np.float32)
    y = (x @ np.array([1.0, -2.0, 3.0, 0.5], np.float32) + 0.1)[:, None]
    return {"x": x, "y": y.astype(np.float32)}


def _jax_mlp():
    import flax.linen as fnn

    class MLP(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            h = fnn.relu(fnn.Dense(8)(x))
            return fnn.Dense(1)(h)
    return MLP()


def test_fit_eval_matches_jax_and_resumes(orca_context):
    """A dropout-free MLP from bridged weights, Adam at the config's lr:
    the JAX and port ``fit_eval`` scores, metrics and weights agree (1e-5
    relative); a port run of 1 epoch resumed with ``state`` to 3 equals an
    uninterrupted 3-epoch run bit for bit, and JAX's 3-epoch run to 1e-5."""
    cfg = {"lr": 0.01, "batch_size": 16, "loss": "mse"}
    data, val = _data(), _data(48, seed=1)
    jtm = jmb.ModelBuilder(lambda c: _jax_mlp())(cfg, orca_context.mesh)
    jtm.estimator = jtm._build_estimator("mse")
    jtm.estimator.engine.build((data["x"][:1],))
    params = jax.device_get(jtm.estimator.engine.params)

    def creator(c):
        return interop.load_flax_params(_MLP(), params)
    builder = ModelBuilder(creator)
    jscore, jmetrics, _ = jtm.fit_eval(data, val, epochs=3, metric="mse")
    whole = builder(cfg, "cpu")
    score, metrics, state = whole.fit_eval(data, val, epochs=3, metric="mse")
    assert _rel(score, jscore) <= TOL
    assert _rel(metrics["loss"], jmetrics["loss"]) <= TOL
    assert state["epochs_done"] == 3 and state["step"] == 18
    want = interop.flax_to_state_dict(jax.device_get(
        jtm.estimator.engine.params))
    for name, t in state["params"].items():
        assert _rel(t, want[name]) <= TOL, name
    first = builder(cfg, "cpu")
    _, _, s1 = first.fit_eval(data, val, epochs=1, metric="mse")
    resumed = builder(cfg, "cpu")
    score_r, _, s3 = resumed.fit_eval(data, val, epochs=3, metric="mse",
                                      state=s1)
    assert score_r == score and s3["step"] == state["step"]
    for name, t in state["params"].items():
        assert torch.equal(s3["params"][name], t), name
    # at or past the budget: scored, not trained
    again = builder(cfg, "cpu")
    score_a, _, s_a = again.fit_eval(data, val, epochs=3, metric="mse",
                                     state=s3)
    assert score_a == score and s_a["step"] == s3["step"]


def test_fit_eval_trial_context_protocol():
    """A scheduler's TrialContext drives fit_eval segment by segment: a
    boundary every 2 epochs gives reports at 2, 4 and 5."""
    class Ctx:
        def __init__(self):
            self.reports, self.beats, self.state_fn = [], [], None

        def set_state_fn(self, fn):
            self.state_fn = fn

        def heartbeat(self, done):
            self.beats.append(done)

        def next_boundary(self, done):
            return done + 2

        def report(self, done, score):
            self.reports.append(done)
    ctx = Ctx()
    tm = ModelBuilder(lambda c: _MLP())({"lr": 0.01, "loss": "mse"}, "cpu")
    tm.fit_eval(_data(32), epochs=5, metric="mse", trial_context=ctx)
    assert ctx.reports == [2, 4, 5] and ctx.beats == [0, 2, 4]
    assert ctx.state_fn()["epochs_done"] == 5


@pytest.mark.parametrize("name", ["sgd", "adam", "rmsprop", "adagrad"])
def test_optimizer_names_step_like_optax(name):
    """``from_torch(optimizer=<name>)`` builds the port's optimizer with the
    config's lr; three of its steps equal optax.<name>(lr)'s (1e-6)."""
    lr = 0.05
    creator = tae._wrap_opt(name)
    p0 = np.random.RandomState(0).randn(5).astype(np.float32)
    grads = np.random.RandomState(1).randn(3, 5).astype(np.float32)
    p = nn.Parameter(torch.from_numpy(p0.copy()))
    opt = creator(None, {"lr": lr})
    torch_opt = opt.to_torch()([p])
    tx = getattr(optax, name)(lr)
    jp, state = jax.numpy.asarray(p0), None
    state = tx.init(jp)
    for g in grads:
        p.grad = torch.from_numpy(g.copy())
        torch_opt.step()
        upd, state = tx.update(jax.numpy.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
    assert _rel(p.detach().numpy(), np.asarray(jp)) <= 1e-6


# --- leases --------------------------------------------------------------------

def test_leases_exclusive_and_timeout():
    mgr = DeviceLeaseManager(["d0", "d1"])
    a, b = mgr.acquire(owner=1), mgr.acquire(owner=2)
    assert {a.device, b.device} == {"d0", "d1"}
    with pytest.raises(LeaseTimeout):
        mgr.acquire(timeout=0.05)
    a.release()
    c = mgr.acquire(timeout=1.0)
    assert c.device == a.device and c.index == a.index
    with pytest.raises(RuntimeError, match="not outstanding"):
        mgr.release(type(a)(mgr, "d9", 0, None))
    a.release()                             # already released: no-op
    for lease in (b, c):
        lease.release()
    assert mgr.outstanding() == []
    assert mgr.utilization()["leases"] == [1, 2] or \
        mgr.utilization()["leases"] == [2, 1]


def test_lease_blocks_until_released_and_counts_busy_seconds():
    mgr = DeviceLeaseManager(["only"])
    held = mgr.acquire(owner="first")
    got = []

    def waiter():
        with mgr.acquire(owner="second", timeout=5.0) as lease:
            got.append((lease.owner, time.perf_counter()))
    t = threading.Thread(target=waiter)
    t0 = time.perf_counter()
    t.start()
    time.sleep(0.15)
    assert got == []
    held.release()
    t.join(timeout=5.0)
    assert not t.is_alive() and got[0][0] == "second"
    assert got[0][1] - t0 >= 0.15
    u = mgr.utilization()
    assert u["leases"] == [2] and u["chips"] == 1
    assert u["busy_s"][0] >= 0.15
    assert 0.0 < u["utilization"] <= 1.0


def test_leases_under_contention_stay_exclusive():
    """More threads than devices and cores, a short switch interval: no
    device is ever held twice at once, and every acquire is counted."""
    mgr = DeviceLeaseManager(["a", "b", "c"])
    holders = {d: 0 for d in ("a", "b", "c")}
    guard = threading.Lock()
    errors = []

    def work():
        for _ in range(50):
            with mgr.acquire(timeout=10.0) as lease:
                with guard:
                    holders[lease.device] += 1
                    if holders[lease.device] > 1:
                        errors.append(lease.device)
                time.sleep(0)
                with guard:
                    holders[lease.device] -= 1
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert sum(mgr.utilization()["leases"]) == 16 * 50


def test_cpu_inventory_from_the_context():
    ctx = tctx.init_orca_context(device="cpu")
    try:
        assert DeviceLeaseManager().devices == [torch.device("cpu")]
        assert TEngine(device="cpu").devices == [torch.device("cpu")]
    finally:
        tctx.stop_orca_context()


# --- the engine's run ------------------------------------------------------------

class _Stub:
    """A trial model scoring its config's ``s`` after ``wait`` seconds."""

    def __init__(self, config, device):
        self.config, self.device = config, device

    def fit_eval(self, data, validation_data, epochs, metric):
        time.sleep(self.config.get("wait", 0.0))
        return self.config["s"], {metric: self.config["s"]}, {"w": 1}


def test_stop_score_cancels_queued_trials():
    space = {"s": thp.grid_search([0.01, 5.0, 6.0, 7.0, 8.0, 9.0]),
             "wait": 0.1}
    eng = TEngine(device="cpu", max_concurrent=2)
    eng.compile(None, _Stub, space, epochs=1, metric="mse", stop_score=0.05)
    trials = eng.run()
    # trial 0 reaches the threshold; the worker that ran it may lease the
    # device for its next trial (1 or 2) before the flag is set, and that
    # trial trains; everything else is cancelled
    assert trials[0].state == "done" and trials[0].device == "cpu"
    assert [t.state for t in trials[1:3]].count("done") <= 1
    assert all(t.state in ("done", "cancelled") for t in trials[1:3])
    assert all(t.state == "cancelled" for t in trials[3:])
    assert eng.get_best_trial() is trials[0]
    summary = eng.summary()
    assert summary["trials"]["cancelled"] >= 4
    assert summary["devices"]["leases"][0] <= 3
    # one device, one worker: the sequential path stops launching
    seq = TEngine(device="cpu")
    seq.compile(None, _Stub, {"s": thp.grid_search([9.0, 0.01, 5.0])},
                stop_score=0.05)
    assert [t.state for t in seq.run()] == ["done", "done"]


def test_keep_model_states_and_errors():
    class Flaky(_Stub):
        def fit_eval(self, *a, **k):
            if self.config["s"] == 3.0:
                raise ValueError("boom")
            return super().fit_eval(*a, **k)
    eng = TEngine(device="cpu")
    eng.compile(None, Flaky, {"s": thp.grid_search([2.0, 1.0, 3.0])})
    trials = eng.run()
    assert [t.state for t in trials] == ["done", "done", "error"]
    assert "boom" in trials[2].error
    assert [t.model_state is not None for t in trials] == [False, True,
                                                           False]


def test_asha_not_ported():
    """The engine and ``AutoEstimator.fit`` run ``scheduler="asha"`` to
    completion, and only an unknown scheduler raises. (The name is kept
    from when this test held the raise of the unported scheduler; the
    runtime's own suite is tests/test_torch_scheduler.py.)"""
    eng = TEngine(device="cpu")
    eng.compile(None, _Stub, {"s": thp.grid_search([2.0, 1.0, 3.0])},
                epochs=3, scheduler="asha")
    trials = eng.run()
    assert [t.state for t in trials] == ["done"] * 3
    assert eng.get_best_trial() is trials[1]
    assert eng.summary()["status"] == "completed"
    with pytest.raises(ValueError, match="scheduler"):
        TEngine(device="cpu").compile(None, _Stub, {}, scheduler="pbt")
    auto = AutoEstimator.from_torch(model_creator=lambda c: _MLP(),
                                    loss="mse", device="cpu")
    auto.fit(_data(32), epochs=2, scheduler="asha",
             search_space={"lr": thp.grid_search([0.01, 0.02])})
    assert auto.search_summary()["epochs"]["exhaustive"] == 4
    assert all(t.state == "done" for t in auto.get_trials())


# --- AutoEstimator -------------------------------------------------------------

def test_auto_estimator_from_torch_search():
    """lr x hidden x batch size on the CPU: every trial done; the best
    model's ``evaluate`` equals the best trial's score; a second fit
    raises."""
    def creator(config):
        torch.manual_seed(0)
        return nn.Sequential(nn.Linear(4, config["hidden"]), nn.ReLU(),
                             nn.Linear(config["hidden"], 1))
    auto = AutoEstimator.from_torch(model_creator=creator,
                                    loss=nn.MSELoss(), optimizer="adam",
                                    device="cpu")
    data, val = _data(256), _data(64, seed=1)
    auto.fit(data, epochs=6, validation_data=val, metric="mse",
             n_sampling=2, search_space={
                 "lr": thp.grid_search([0.05, 1e-4]),
                 "hidden": thp.choice([8, 16]),
                 "batch_size": thp.choice([32, 64])})
    trials = auto.get_trials()
    assert len(trials) == 4 and all(t.state == "done" for t in trials)
    best = auto.best_trial
    assert auto.get_best_config()["lr"] == 0.05
    est = auto.get_best_model()
    res = est.evaluate(val, batch_size=best.config["batch_size"],
                       verbose=False)
    assert res["mse"] == best.metric_value
    assert auto.search_summary()["trials"]["done"] == 4
    with pytest.raises(RuntimeError, match="already been fitted"):
        auto.fit(data, search_space={"lr": 0.01})


def test_auto_estimator_from_keras_net():
    """A creator of the port's Keras net (compiled): its module trains,
    and the larger lr wins on this easy problem, as in the JAX test."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential

    def creator(config):
        torch.manual_seed(0)
        return Sequential([Dense(8, activation="relu"), Dense(1)]).compile(
            "adam", "mse")
    auto = AutoEstimator.from_keras(model_creator=creator, device="cpu")
    auto.fit(_data(256), epochs=6, validation_data=_data(64, seed=1),
             metric="mse", search_space={
                 "lr": thp.grid_search([0.1, 1e-4]), "batch_size": 64})
    assert auto.get_best_config()["lr"] == 0.1
    assert auto.best_trial.metric_value < 0.5


def test_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tctx, "_current", None)
    for make in (lambda: TEngine(),
                 lambda: AutoEstimator.from_torch(
                     model_creator=lambda c: _MLP()),
                 lambda: AutoEstimator.from_keras(
                     model_creator=lambda c: _MLP()),
                 lambda: ModelBuilder(lambda c: _MLP())({}, None),
                 lambda: DeviceLeaseManager()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
