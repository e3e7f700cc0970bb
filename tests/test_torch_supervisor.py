"""The port's dispatch watchdog and training supervisor
(analytics_zoo_tpu_torch/resilience/{watchdog,supervisor}.py) on the CPU:
the JAX suite's watchdog and supervisor cases (tests/test_resilience.py)
on the port, the sections the port's engine, estimator and transfer open,
the device-loss difference kept on purpose, and the JAX supervisor and
the port's under one fault schedule (a hang in epoch 2, a crash in epoch
3): equal report counts, final weights within TOL_SUP of JAX's, and the
port's faulted run bit for bit its own clean run.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch
from torch import nn

from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.orca.learn.estimator import TPUEstimator
from analytics_zoo_tpu_torch.resilience import (DispatchTimeout,
                                                DispatchWatchdog,
                                                SupervisorGiveUp,
                                                TrainingSupervisor, classify,
                                                faults, resilience_snapshot)
from analytics_zoo_tpu_torch.resilience import watchdog as wd_mod

# port against JAX after the same 12 supervised Adam steps (f32 sums in
# another order, through Adam's normalisation)
TOL_SUP = dict(rtol=1e-5, atol=1e-5)
# the schedule's hang: the stall outlasts the bound, which clears a cold
# step on a loaded host
TIMEOUT_S, STALL_S = 1.5, 4.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread beside the suite's other workers (see
    tests/test_torch_tcmf.py)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


class _Net(nn.Module):
    """The JAX suite's MLP, Dense(8) -> relu -> Dense(1), with flax's
    names."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(4, 8)
        self.Dense_1 = nn.Linear(8, 1)

    def forward(self, x):
        return self.Dense_1(torch.relu(self.Dense_0(x)))[:, 0]


_INIT = {}


def _mlp_estimator(model_dir=None):
    """The port's MLP estimator, from the same weights every call."""
    net = _Net()
    if not _INIT:
        torch.manual_seed(0)
        _INIT.update({k: v.clone() for k, v in _Net().state_dict().items()})
    net.load_state_dict(_INIT)
    return TPUEstimator(net, loss="mse", optimizer="adam",
                        model_dir=model_dir, seed=0, device="cpu",
                        config={"steps_per_dispatch": 1})


def _train_data(n=96):
    rng = np.random.RandomState(0)
    return {"x": rng.rand(n, 4).astype(np.float32),
            "y": rng.rand(n).astype(np.float32)}


def _params(est):
    return {k: v.clone() for k, v in est.engine.get_state()["params"].items()}


def _equal(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


# --- watchdog ------------------------------------------------------------------

def test_watchdog_hang_detection_on_stalled_dispatch():
    wd = DispatchWatchdog(timeout_s=0.15, poll_s=0.02)
    try:
        with pytest.raises(DispatchTimeout) as ei:
            wd.run(time.sleep, 2.0, label="fake.dispatch")
        assert classify(ei.value) == "hang"
        assert wd.tripped.is_set()

        def boom():
            raise RuntimeError("step failed")

        with pytest.raises(RuntimeError) as ei:
            wd.run(boom, label="fake.dispatch")
        assert classify(ei.value) == "crash"
        wd.reset()
        token = wd.enter("engine.dispatch")
        time.sleep(0.3)
        wd.exit(token)
        assert wd.tripped.is_set()
        assert wd.snapshot()["by_label"]["engine.dispatch"] >= 1
        wd.reset()
        token = wd.enter("engine.dispatch")
        wd.exit(token)
        time.sleep(0.05)
        assert not wd.tripped.is_set()
    finally:
        wd.close()


def test_delay_fault_in_h2d_trips_watchdog():
    """A delay-mode h2d.put fault (a hung copy) stalls INSIDE the section
    the port's ``put_tree`` opens, so the monitor classifies it a hang."""
    from analytics_zoo_tpu_torch.native.transfer import put_tree

    wd = DispatchWatchdog(timeout_s=0.1, poll_s=0.02)
    wd_mod.set_active(wd)
    try:
        with faults.inject("h2d.put", count=1, mode="delay", delay_s=0.4):
            out, _ = put_tree([np.ones(4, np.float32)],
                              torch.device("cpu"))
        assert torch.equal(out[0], torch.ones(4))
        assert wd.tripped.is_set()
        assert wd.snapshot()["by_label"].get("h2d.put", 0) >= 1
    finally:
        wd_mod.clear_active()
        wd.close()


def test_watchdog_disabled_is_noop():
    wd = DispatchWatchdog(timeout_s=None)
    assert wd.enter("x") is None
    wd.exit(None)
    assert wd.run(lambda: 7) == 7
    wd.close()


class _Recorder(DispatchWatchdog):
    def __init__(self):
        super().__init__(timeout_s=60.0)
        self.labels = []

    def enter(self, label):
        self.labels.append(label)
        return super().enter(label)


def test_engine_and_estimator_open_watchdog_sections():
    """Each train dispatch (per step and fused) opens ``engine.dispatch``;
    the host's reads of the card's results in fit, evaluate and predict
    open ``engine.sync`` (a torch launch returns before the card ends)."""
    wd = wd_mod.set_active(_Recorder())
    try:
        data = _train_data(64)
        est = _mlp_estimator()
        est.fit(dict(data), epochs=1, batch_size=32, verbose=False)
        n_fit = len(wd.labels)
        assert wd.labels.count("engine.dispatch") == 2
        assert wd.labels.count("engine.sync") == 1
        est.config["steps_per_dispatch"] = 2
        est.fit(dict(data), epochs=1, batch_size=32, verbose=False)
        assert est.fuse == 2
        assert wd.labels[n_fit:].count("engine.dispatch") == 1
        before = len(wd.labels)
        est.evaluate(dict(data), batch_size=32, verbose=False)
        est.predict(data["x"], batch_size=32)
        assert wd.labels[before:].count("engine.sync") == 3
    finally:
        wd_mod.clear_active()
        wd.close()


# --- supervisor ----------------------------------------------------------------

def test_supervisor_resume_bit_identity(tmp_path):
    data = _train_data()
    ref = _mlp_estimator()
    ref.fit(dict(data), epochs=3, batch_size=32, verbose=False)
    sup = TrainingSupervisor(lambda: _mlp_estimator(str(tmp_path)),
                             model_dir=str(tmp_path), max_restarts=3)
    sup.retry_policy.base_delay_s = 0.02
    with faults.inject("engine.dispatch", count=1, skip=5):
        report = sup.fit(dict(data), epochs=3, batch_size=32)
    assert report["restarts"] == 1 and report["crashes"] == 1
    assert report["completed"] and not report["preempted"]
    assert report["steps_replayed"] >= 1
    assert _equal(_params(sup.estimator), _params(ref))
    sup.estimator.shutdown()


def test_supervisor_hang_recovery_via_watchdog(tmp_path):
    data = _train_data(64)
    ref = _mlp_estimator()
    ref.fit(dict(data), epochs=2, batch_size=32, verbose=False)
    sup = TrainingSupervisor(lambda: _mlp_estimator(str(tmp_path)),
                             model_dir=str(tmp_path), max_restarts=2,
                             dispatch_timeout_s=TIMEOUT_S, poll_s=0.02)
    sup.retry_policy.base_delay_s = 0.02
    with faults.inject("engine.dispatch", count=1, skip=1,
                       mode="delay", delay_s=STALL_S):
        report = sup.fit(dict(data), epochs=2, batch_size=32)
    assert report["hangs"] == 1 and report["completed"], report
    assert _equal(_params(sup.estimator), _params(ref))
    sup.estimator.shutdown()


def test_supervisor_give_up_report(tmp_path):
    sup = TrainingSupervisor(lambda: _mlp_estimator(str(tmp_path)),
                             model_dir=str(tmp_path), max_restarts=1)
    sup.retry_policy.base_delay_s = 0.01
    with faults.inject("engine.dispatch", prob=1.0):
        with pytest.raises(SupervisorGiveUp) as ei:
            sup.fit(_train_data(64), epochs=1, batch_size=32)
    rep = ei.value.report
    assert rep["restarts"] == 2 and len(rep["failures"]) == 2
    assert all(f["kind"] == "crash" for f in rep["failures"])
    assert "last_checkpoint" in rep
    assert not rep.get("process_restart_required")


def test_resilience_stats_surface(tmp_path):
    sup = TrainingSupervisor(lambda: _mlp_estimator(str(tmp_path)),
                             model_dir=str(tmp_path), max_restarts=2)
    sup.retry_policy.base_delay_s = 0.02
    with faults.inject("engine.dispatch", count=1, skip=1):
        sup.fit(_train_data(64), epochs=1, batch_size=32)
    res = sup.estimator.data_pipeline_stats().get("resilience", {})
    assert res.get("fault.engine.dispatch", 0) >= 1
    assert res.get("supervisor.restarts", 0) >= 1
    assert resilience_snapshot() == res
    sup.estimator.shutdown()


def test_cuda_device_loss_gives_up_naming_it(tmp_path):
    """A real CUDA error classified as device loss is not restarted
    in-process (CUDA cannot replace a lost context): the supervisor gives
    up at once, its report naming the error and asking for a process
    restart, the last committed epoch its resume point."""
    calls = []

    def factory():
        est = _mlp_estimator(str(tmp_path))
        inner = est.engine.train_batch

        def train_batch(batch):
            calls.append(1)
            if len(calls) == 5:
                raise RuntimeError("CUDA error: an illegal memory access "
                                   "was encountered")
            return inner(batch)

        est.engine.train_batch = train_batch
        return est

    sup = TrainingSupervisor(factory, model_dir=str(tmp_path),
                             max_restarts=3)
    with pytest.raises(SupervisorGiveUp, match="process must restart") as ei:
        sup.fit(_train_data(96), epochs=3, batch_size=32)
    rep = ei.value.report
    assert rep["process_restart_required"] and rep["restarts"] == 0
    assert rep["failures"][-1]["device_loss"]
    assert "illegal memory access" in rep["failures"][-1]["error"]
    assert rep["last_checkpoint"]["epoch"] == 1
    # an injected device loss (an InjectedFault) restarts, as in JAX
    assert not TrainingSupervisor._needs_process_restart(
        faults.InjectedFault("injected fault at engine.dispatch"))
    assert not TrainingSupervisor._needs_process_restart(
        DispatchTimeout("engine.dispatch", 2.0, 1.0))


# --- the port against the JAX package under one fault schedule ----------------

def _schedule(faults_mod, plan):
    """A fault registry of ``faults_mod`` (either package's) firing at
    ``engine.dispatch`` by call number: ``plan`` maps a call to
    ``("delay", s)`` (a hang) or ``("raise",)`` (an injected device loss).
    A thread that hung is not counted again (a real hang never comes
    back), so the count follows the live segments only."""

    class Schedule(faults_mod.FaultRegistry):
        def __init__(self):
            super().__init__(seed=0)
            self.calls = 0
            self.hung = []
            self.guard = threading.Lock()

        def fire(self, site):
            if site != "engine.dispatch":
                return
            me = threading.current_thread()
            with self.guard:
                if any(t is me for t in self.hung):
                    return
                self.calls += 1
                act = plan.get(self.calls)
                if act is not None and act[0] == "delay":
                    self.hung.append(me)
            if act is None:
                return
            if act[0] == "delay":
                time.sleep(act[1])
                return
            raise faults_mod.InjectedFault(
                f"injected device loss at {site} (call {self.calls})")

    return faults_mod.inject(registry=Schedule())


# 3 steps an epoch, 4 epochs: call 5 (epoch 2's second step) hangs; after
# the restart epoch 2 runs calls 6-8, and call 10 (epoch 3's second step)
# raises
PLAN = {5: ("delay", STALL_S), 10: ("raise",)}
REPORT_KEYS = ("restarts", "hangs", "crashes", "steps_replayed",
               "completed")


def test_supervisor_reports_match_jax(orca_context, tmp_path):
    import flax.linen as fnn

    from analytics_zoo_tpu.orca.learn.estimator import \
        TPUEstimator as JTPUEstimator
    from analytics_zoo_tpu.resilience import TrainingSupervisor as JSup
    from analytics_zoo_tpu.resilience import faults as jfaults

    class JNet(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            h = fnn.relu(fnn.Dense(8)(x))
            return fnn.Dense(1)(h)[:, 0]

    data = _train_data()
    probe = JTPUEstimator(JNet(), loss="mse", optimizer="adam", seed=0,
                          config={"steps_per_dispatch": 1})
    probe.engine.build((data["x"][:1],))
    init = jax.device_get(probe.engine.params)

    def jfactory():
        est = JTPUEstimator(JNet(), loss="mse", optimizer="adam", seed=0,
                            model_dir=str(tmp_path / "jax"),
                            config={"steps_per_dispatch": 1})
        return est          # seed 0: flax draws ``init`` again

    def tfactory(d=str(tmp_path / "port")):
        est = _mlp_estimator(d)
        interop.load_flax_params(est.module, init)
        return est

    reports = {}
    for name, sup_cls, factory, fmod in (
            ("jax", JSup, jfactory, jfaults),
            ("port", TrainingSupervisor, tfactory, faults)):
        sup = sup_cls(factory, max_restarts=3, dispatch_timeout_s=TIMEOUT_S,
                      poll_s=0.02)
        sup.retry_policy.base_delay_s = 0.02
        with _schedule(fmod, PLAN):
            rep = sup.fit(dict(data), epochs=4, batch_size=32,
                          shuffle=False)
        reports[name] = (rep, sup.estimator)
    (jrep, jest), (trep, test) = reports["jax"], reports["port"]
    assert {k: jrep[k] for k in REPORT_KEYS} == \
        {k: trep[k] for k in REPORT_KEYS}
    assert (trep["restarts"], trep["hangs"], trep["crashes"]) == (2, 1, 1)
    assert trep["completed"]
    want = interop.flax_to_state_dict(jax.device_get(jest.engine.params))
    got = _params(test)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **TOL_SUP)
    # the port's faulted run is its clean run, bit for bit
    clean = tfactory(None)
    clean.fit(dict(data), epochs=4, batch_size=32, shuffle=False,
              verbose=False)
    assert _equal(got, _params(clean))
    jest.shutdown()
    test.shutdown()
