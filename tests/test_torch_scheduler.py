"""The port's ASHA trial runtime (``analytics_zoo_tpu_torch/automl/
scheduler``), its entry points and AutoXGBoost on the CPU, against the JAX
package's.

* The JAX suite ``tests/test_trial_scheduler.py``'s non-slow tests, on the
  port's runtime with the same fake models (no training; milliseconds).
* Parity: the JAX ``TrialRuntime`` and the port's drive the same fake
  models over nine trials on one lease; rung geometry, study fingerprint,
  event sequence (time and chip fields removed), rung ledger, epochs and
  counters are equal.
* Pause/resume through ``TrialModel`` and the checkpoint plane's disk
  round trip: bit for bit equal to the straight run, with a control (the
  shuffle's epoch off by one) that differs.
* ``AutoEstimator`` and ``AutoTSTrainer`` with ``scheduler="asha"``, and a
  SIGTERM mid-study resumed from the manifest by a fresh ``AutoEstimator``.
* AutoXGBoost and the histogram GBT: equal to the JAX package's bit for
  bit (numpy on both sides)."""

import json
import os
import pickle
import signal
import threading
import time

import numpy as np
import pandas as pd
import pytest
import torch
from torch import nn

import jax
from analytics_zoo_tpu.automl import hp as jhp
from analytics_zoo_tpu.automl.scheduler import asha as jasha
from analytics_zoo_tpu.automl.scheduler import runtime as jruntime
from analytics_zoo_tpu.automl.search import search_engine as jsearch
from analytics_zoo_tpu.automl.xgboost import auto_xgb as jxgb
from analytics_zoo_tpu.automl.xgboost import hist_gbt as jgbt
from analytics_zoo_tpu_torch.automl import AutoEstimator, ModelBuilder
from analytics_zoo_tpu_torch.automl import hp
from analytics_zoo_tpu_torch.automl.scheduler import (AshaBracket,
                                                      DeviceLeaseManager,
                                                      LeaseTimeout,
                                                      TrialRuntime,
                                                      asha_rungs)
from analytics_zoo_tpu_torch.automl.search.search_engine import (
    TPUSearchEngine, Trial)
from analytics_zoo_tpu_torch.automl.xgboost import auto_xgb as txgb
from analytics_zoo_tpu_torch.automl.xgboost import hist_gbt as tgbt
from analytics_zoo_tpu_torch.ckpt import CheckpointPlane, load_checkpoint_dir
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.self_attention import \
    Dropout

CPU = [torch.device("cpu")]


# --- rung promotion math ----------------------------------------------------

def test_asha_rung_geometry():
    assert asha_rungs(9, eta=3, grace_period=1) == [1, 3, 9]
    assert asha_rungs(8, eta=2, grace_period=1) == [1, 2, 4, 8]
    assert asha_rungs(5, eta=3, grace_period=2) == [2, 5]
    assert asha_rungs(1, eta=3, grace_period=1) == [1]
    # grace > max_t clamps instead of producing an empty ladder
    assert asha_rungs(3, eta=3, grace_period=10) == [3]
    with pytest.raises(ValueError):
        asha_rungs(0)
    with pytest.raises(ValueError):
        asha_rungs(4, eta=1)


def test_asha_promotion_top_1_over_eta():
    b = AshaBracket(9, eta=3, grace_period=1, metric_mode="min")
    # fewer than eta reports: floor(n/eta) == 0, everything pauses
    assert b.report("t0", 0, 5.0) == "pause"
    assert b.report("t1", 0, 4.0) == "pause"
    # third report is the best so far: top-1 of 3 -> promote
    assert b.report("t2", 0, 3.0) == "promote"
    # worse than the current top-1: pause
    assert b.report("t3", 0, 9.0) == "pause"
    # final rung never promotes/pauses: it's completion
    assert b.report("t2", 2, 1.0) == "stop"


def test_asha_late_promotion_and_retire():
    b = AshaBracket(9, eta=3, grace_period=1, metric_mode="min")
    b.report("t0", 0, 1.0)       # best, but alone -> paused
    b.report("t1", 0, 2.0)
    assert b.promotable() is None            # floor(2/3) == 0
    b.report("t2", 0, 3.0)                   # n=3: top-1 is t0 -> promotable
    assert b.promotable() == ("t0", 0)
    assert b.promotable() is None            # already promoted
    b.report("t3", 0, 0.5)                   # new best, immediately promoted
    assert b.promotable() is None
    # at n=6 the top-2 (t3, t0) are already promoted: nothing new
    b.report("t4", 0, 9.0)
    b.report("t5", 0, 9.5)
    assert b.promotable() is None
    # at n=9 floor(9/3)=3 lifts t1 into the top set
    b.report("t6", 0, 9.9)
    b.report("t7", 0, 9.95)
    b.report("t8", 0, 9.99)
    assert b.promotable() == ("t1", 0)
    # a retired (errored) trial is never promoted even when it qualifies
    b2 = AshaBracket(9, eta=3, grace_period=1, metric_mode="min")
    for i, score in enumerate([1.0, 2.0, 3.0]):
        b2.report(f"t{i}", 0, score)
    b2.retire("t0")
    b2._promoted[0].clear()              # reset the inline-promotion mark
    assert b2.promotable() is None


def test_asha_metric_mode_max():
    b = AshaBracket(4, eta=2, grace_period=1, metric_mode="max")
    b.report("lo", 0, 0.1)
    assert b.report("hi", 0, 0.9) == "promote"   # higher is better
    assert b.promotable() is None


# --- device leasing ---------------------------------------------------------

def test_lease_manager_never_double_books():
    mgr = DeviceLeaseManager(devices=[f"dev{i}" for i in range(3)])
    active = {}
    violations = []
    lock = threading.Lock()

    def worker(n):
        for _ in range(25):
            with mgr.acquire(owner=n) as lease:
                with lock:
                    if lease.index in active:
                        violations.append((lease.index, n,
                                           active[lease.index]))
                    active[lease.index] = n
                time.sleep(0.001)
                with lock:
                    del active[lease.index]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not violations, f"device double-booked: {violations[:3]}"
    util = mgr.utilization()
    assert sum(util["leases"]) == 8 * 25
    assert not mgr.outstanding()


def test_lease_timeout_and_double_release():
    mgr = DeviceLeaseManager(devices=["only"])
    lease = mgr.acquire(owner="a")
    with pytest.raises(LeaseTimeout):
        mgr.acquire(owner="b", timeout=0.05)
    lease.release()
    lease.release()                      # idempotent
    lease2 = mgr.acquire(owner="b", timeout=0.05)
    lease2.release()


# --- fake models for runtime-logic tests ------------------------------------

class _FakeModel:
    """lr-indexed quadratic 'loss' that improves with epochs; supports the
    full extended protocol in-process (no training). The second argument
    is the JAX runtime's mesh or the port's device: unused."""

    def __init__(self, config, device):
        self.config = config

    def fit_eval(self, data, validation_data, epochs, metric, state=None,
                 trial_context=None):
        done = 0 if state is None else int(state["epochs_done"])
        total = int(epochs)
        if trial_context is not None:
            trial_context.set_state_fn(lambda: {"epochs_done": done})
            while done < total:
                done += 1
                if trial_context.should_report(done):
                    trial_context.report(done, self._score(done))
        else:
            done = total
        return self._score(done), {metric: self._score(done)}, \
            {"epochs_done": done}

    def _score(self, done):
        return 1.0 / max(done, 1) + float(self.config["lr"])


def _fake_trials(n=9, trial_cls=Trial, **extra):
    return [trial_cls(i, {"lr": 0.01 * i, **extra}) for i in range(n)]


def _runtime(trials, model_cls=_FakeModel, runtime_cls=TrialRuntime, **kw):
    kw.setdefault("metric", "mse")
    kw.setdefault("metric_mode", "min")
    kw.setdefault("max_t", 9)
    kw.setdefault("eta", 3)
    kw.setdefault("grace_period", 1)
    kw.setdefault("retry_backoff_s", 0.01)
    kw.setdefault("devices", CPU)
    return runtime_cls(trials, model_cls, data=None, **kw)


# --- scheduler behaviour (fake models) --------------------------------------

def test_runtime_spends_fewer_epochs_and_finds_best():
    trials = _fake_trials(9)
    rt = _runtime(trials)
    rt.run()
    s = rt.summary()
    assert s["status"] == "completed"
    assert all(t.state == "done" for t in trials)
    assert all(t.device == "cpu" for t in trials)
    # the lr=0 trial is best at every fidelity: it must train to max_t and win
    best = min(trials, key=lambda t: t.metric_value)
    assert best.config["lr"] == 0.0
    assert best.epochs_trained == 9
    # massive pruning vs the exhaustive 9*9 budget
    assert s["epochs"]["trained"] < s["epochs"]["exhaustive"] * 0.5
    # rung populations shrink ~1/eta per rung
    reported = [r["reported"] for r in s["rungs"]]
    assert reported[0] == 9 and reported[-1] >= 1
    assert reported[0] > reported[1] >= reported[2]
    # pruned trials surface their checkpointed state at finalize
    assert all(t.model_state is not None for t in trials)
    # no compile plane in the port: the JAX runtime's compile_cache=False
    assert s["compile"] == {}


def test_runtime_small_study_force_promotes_one_winner():
    # 2 trials < eta=3: pure ASHA would pause both forever; the runtime's
    # small-study guard must still deliver one max_t-trained winner
    trials = _fake_trials(2)
    rt = _runtime(trials)
    rt.run()
    assert any(t.epochs_trained == 9 for t in trials)
    assert rt.summary()["counters"]["forced_promotions"] >= 1


def test_runtime_retries_transient_failure_from_checkpoint():
    boom = {"left": 2}

    class Flaky(_FakeModel):
        def fit_eval(self, *a, **kw):
            if self.config["lr"] == 0.0 and boom["left"] > 0:
                boom["left"] -= 1
                raise RuntimeError("injected transient failure")
            return super().fit_eval(*a, **kw)

    trials = _fake_trials(4)
    rt = _runtime(trials, model_cls=Flaky, max_t=4, eta=2,
                  max_trial_retries=3)
    rt.run()
    t0 = trials[0]
    assert t0.state == "done" and t0.retries == 2
    assert rt.summary()["counters"]["retries"] == 2


def test_runtime_exhausted_retries_mark_error_others_unaffected():
    class AlwaysBoom(_FakeModel):
        def fit_eval(self, *a, **kw):
            if self.config["lr"] == 0.0:
                raise RuntimeError("hard failure")
            return super().fit_eval(*a, **kw)

    trials = _fake_trials(4)
    rt = _runtime(trials, model_cls=AlwaysBoom, max_t=4, eta=2,
                  max_trial_retries=1)
    rt.run()
    assert trials[0].state == "error"
    assert trials[0].retries == 2            # initial + 1 retry
    assert "hard failure" in trials[0].error
    assert all(t.state == "done" for t in trials[1:])


def test_runtime_legacy_fit_eval_is_driven_per_rung():
    calls = []

    class Legacy:
        def __init__(self, config, device):
            self.config = config

        def fit_eval(self, data, validation_data, epochs, metric):
            calls.append((self.config["lr"], int(epochs)))
            s = 1.0 / int(epochs) + self.config["lr"]
            return s, {metric: s}, {"w": "weights"}

    trials = _fake_trials(4)
    rt = _runtime(trials, model_cls=Legacy, max_t=4, eta=2)
    rt.run()
    assert all(t.state == "done" for t in trials)
    # rung ladder [1, 2, 4]: the winner was re-driven at growing cumulative
    # budgets; pruned trials only ever saw the small ones
    budgets = sorted({b for _, b in calls})
    assert budgets[0] == 1 and budgets[-1] == 4
    winner = min(trials, key=lambda t: t.metric_value)
    assert winner.metric_value == pytest.approx(0.25 + winner.config["lr"])


class _Slow(_FakeModel):
    def fit_eval(self, data, validation_data, epochs, metric, state=None,
                 trial_context=None):
        done = 0 if state is None else int(state["epochs_done"])
        total = int(epochs)
        trial_context.set_state_fn(lambda: {"epochs_done": done})
        while done < total:
            time.sleep(0.05)                 # one "epoch"
            done += 1
            trial_context.heartbeat(done)    # preemption safe-point
            if trial_context.should_report(done):
                trial_context.report(done, self._score(done))
        return self._score(done), {metric: self._score(done)}, \
            {"epochs_done": done}


def _done_before(manifest, tid):
    for t in manifest["trials"]:
        if t["id"] == tid:
            return t["epochs_done"]
    return 0


def test_runtime_sigterm_checkpoints_and_manifest_resumes(tmp_path):
    logs = str(tmp_path / "study")
    trials = _fake_trials(6)
    # two workers over two stand-in devices, as the JAX test runs two chips
    rt = _runtime(trials, model_cls=_Slow, max_t=8, eta=2, max_concurrent=2,
                  logs_dir=logs, devices=["dev0", "dev1"])
    # deliver a real SIGTERM mid-study; the watcher latches it in the main
    # thread while workers are mid-epoch
    timer = threading.Timer(
        0.4, lambda: os.kill(os.getpid(), signal.SIGTERM))
    timer.start()
    try:
        rt.run()
    finally:
        timer.cancel()
    s = rt.summary()
    assert s["status"] == "preempted"
    with open(os.path.join(logs, "study_state.json")) as f:
        manifest = json.load(f)
    assert manifest["status"] == "preempted"
    assert {t["id"] for t in manifest["trials"]} == set(range(6))
    # at least one running trial was checkpointed mid-flight
    paused = [t for t in manifest["trials"] if t["status"] == "paused"]
    assert paused, manifest["trials"]
    assert all(t["epochs_done"] > 0 for t in paused)

    # resume the study from the manifest with fresh objects
    trials2 = _fake_trials(6)
    rt2 = _runtime(trials2, model_cls=_Slow, max_t=8, eta=2,
                   max_concurrent=2, logs_dir=logs, devices=["dev0", "dev1"])
    rt2.run(resume="auto")
    s2 = rt2.summary()
    assert s2["status"] == "completed"
    # every trial accounted for: done (full or pruned) with a real score
    assert all(t.state == "done" and t.metric_value is not None
               for t in trials2)
    assert any(t.epochs_trained + _done_before(manifest, t.trial_id) >= 8
               for t in trials2)
    best = min(trials2, key=lambda t: t.metric_value)
    assert best.config["lr"] == 0.0


class _StateOnlyModel:
    """State-in/state-out but no trial_context (the zouwu _TSTrialModel
    shape): the runtime drives it rung-by-rung via _drive_rungs."""

    def __init__(self, config, device):
        self.config = config

    def fit_eval(self, data, validation_data, epochs, metric, state=None):
        done = 0 if state is None else int(state["epochs_done"])
        s = 1.0 / max(int(epochs), 1) + float(self.config["lr"])
        return s, {metric: s}, {"epochs_done": int(epochs),
                                "trained_from": done}


def test_runtime_epoch_accounting_exact_on_rung_driven_path():
    # single trial, rungs [1, 2, 4]: slices train 1, +1, +2 epochs via
    # forced promotions -> exactly 4 epochs spent
    trials = _fake_trials(1)
    rt = _runtime(trials, model_cls=_StateOnlyModel, max_t=4, eta=2)
    rt.run()
    s = rt.summary()
    assert trials[0].state == "done"
    assert s["epochs"]["trained"] == 4
    assert trials[0].epochs_trained == 4


def test_runtime_resumes_trials_stranded_as_running(tmp_path):
    # a kill -9 mid-slice snapshots the trial as "running" in the manifest;
    # resume must re-queue it, not strand it
    logs = str(tmp_path / "crash")
    trials = _fake_trials(4)
    rt = _runtime(trials, max_t=4, eta=2, logs_dir=logs)
    rt.run()
    path = os.path.join(logs, "study_state.json")
    with open(path) as f:
        doc = json.load(f)
    doc["status"] = "preempted"
    victim = doc["trials"][0]
    victim.update(status="running", score=None, epochs_done=1)
    with open(path, "w") as f:
        json.dump(doc, f)

    trials2 = _fake_trials(4)
    rt2 = _runtime(trials2, max_t=4, eta=2, logs_dir=logs)
    rt2.run(resume=True)
    assert rt2.summary()["status"] == "completed"
    assert trials2[0].state == "done"
    assert trials2[0].metric_value is not None


class _MkdirOnUnpickle:
    """Creates ``path`` when unpickled: shows whether a file was loaded."""

    def __init__(self, path):
        self.path = path

    def __reduce__(self):
        return os.mkdir, (self.path,)


def test_runtime_reads_no_pickle_a_manifest_names(tmp_path):
    # a manifest adopted from a reused logs_dir may name any file as a
    # trial's checkpoint: only a checkpoint-plane directory is loaded, and
    # anything else restarts the trial from scratch without unpickling it
    logs = str(tmp_path / "reused")
    trials = _fake_trials(4)
    rt = _runtime(trials, max_t=4, eta=2, logs_dir=logs)
    rt.run()
    marker = str(tmp_path / "unpickled")
    planted = str(tmp_path / "planted.pkl")
    with open(planted, "wb") as f:
        pickle.dump(_MkdirOnUnpickle(marker), f)
    path = os.path.join(logs, "study_state.json")
    with open(path) as f:
        doc = json.load(f)
    doc["status"] = "preempted"
    doc["trials"][0].update(status="paused", score=None, epochs_done=1,
                            runnable=True, ckpt=planted)
    with open(path, "w") as f:
        json.dump(doc, f)

    trials2 = _fake_trials(4)
    rt2 = _runtime(trials2, max_t=4, eta=2, logs_dir=logs)
    rt2.run(resume=True)
    assert not os.path.exists(marker)
    assert rt2.summary()["status"] == "completed"
    assert trials2[0].state == "done"
    assert trials2[0].metric_value is not None


def test_runtime_halt_does_not_burn_retries():
    # a transient failure landing while the study halts must park the trial
    # runnable (retried on resume), not convert it to a permanent error
    trials = _fake_trials(2)
    rt = _runtime(trials, max_t=4, eta=2, max_trial_retries=2)
    rt._halt_study("preempted")
    rec = rt._rec[trials[0].trial_id]
    outcome = {"trial": trials[0], "kind": "failed",
               "exc": RuntimeError("transient"), "tb": "tb",
               "checkpoint": None}
    assert rt._finish_trial(outcome) is None
    assert rec["status"] == "paused" and rec["runnable"]
    assert trials[0].state == "paused"
    assert rec["retries"] == 0


def test_runtime_completed_study_is_not_readopted(tmp_path):
    logs = str(tmp_path / "study2")
    trials = _fake_trials(4)
    rt = _runtime(trials, max_t=4, eta=2, logs_dir=logs)
    rt.run()
    assert rt.summary()["status"] == "completed"
    # re-running the same (completed) study with resume="auto" starts fresh
    trials2 = _fake_trials(4)
    rt2 = _runtime(trials2, max_t=4, eta=2, logs_dir=logs)
    rt2.run(resume="auto")
    assert rt2.summary()["epochs"]["trained"] > 0


def test_runtime_stop_score_halts_study():
    trials = _fake_trials(8)
    # lr=0 reaches 1/4 + 0 = 0.25 at max_t; threshold 0.3 triggers the halt
    rt = _runtime(trials, max_t=4, eta=2, stop_score=0.3)
    rt.run()
    s = rt.summary()
    assert s["status"] == "stopped"
    assert any(t.state == "done" and t.metric_value <= 0.3 for t in trials)


def test_runtime_events_jsonl_written(tmp_path):
    logs = str(tmp_path / "ev")
    trials = _fake_trials(4)
    rt = _runtime(trials, max_t=4, eta=2, logs_dir=logs)
    rt.run()
    with open(os.path.join(logs, "study_events.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    kinds = {line["event"] for line in lines}
    assert {"study_start", "trial_start", "report",
            "study_completed"} <= kinds
    assert any(k in kinds for k in ("pause", "promote"))


# --- engine satellites ------------------------------------------------------

class _InstantModel:
    def __init__(self, config, device):
        self.config = config

    def fit_eval(self, data, validation_data, epochs, metric):
        s = float(self.config["lr"])
        return s, {metric: s}, {"weights": np.zeros(4)}


def test_engine_stop_score_cancels_concurrent_pending():
    # two workers over two stand-in devices (the JAX test's chips)
    eng = TPUSearchEngine(max_concurrent=2, name="stopper", device="cpu")
    eng.devices = ["dev0", "dev1"]
    eng.compile(None, _InstantModel, {"lr": 0.0}, n_sampling=24,
                epochs=1, metric="mse", metric_mode="min", stop_score=0.5)
    eng.run()
    states = [t.state for t in eng._trials]
    # the threshold is reached by the very first completion: the engine must
    # cancel (not run) a chunk of the 24 queued trials
    assert states.count("cancelled") > 0
    assert states.count("done") >= 1
    assert eng.get_best_trial().metric_value == 0.0


def test_engine_model_state_topk_retention():
    class Scored(_InstantModel):
        def fit_eval(self, data, validation_data, epochs, metric):
            s = float(self.config["lr"])
            return s, {metric: s}, {"weights": np.zeros(8), "score": s}

    eng = TPUSearchEngine(max_concurrent=2, name="retain",
                          keep_model_states=2, device="cpu")
    eng.compile(None, Scored, {"lr": 0.0}, n_sampling=6, epochs=1,
                metric="mse", metric_mode="min")
    # distinct scores so top-k is unambiguous
    for i, t in enumerate(eng._trials):
        t.config = {"lr": float(i)}
    eng.run()
    kept = [t for t in eng._trials if t.model_state is not None]
    assert len(kept) == 2
    assert sorted(t.metric_value for t in kept) == [0.0, 1.0]
    # keep_model_states=None keeps everything
    eng2 = TPUSearchEngine(max_concurrent=2, name="keepall",
                           keep_model_states=None, device="cpu")
    eng2.compile(None, Scored, {"lr": 0.0}, n_sampling=3, epochs=1,
                 metric="mse", metric_mode="min")
    eng2.run()
    assert all(t.model_state is not None for t in eng2._trials)


def test_engine_rejects_unknown_scheduler():
    eng = TPUSearchEngine(device="cpu")
    with pytest.raises(ValueError, match="scheduler"):
        eng.compile(None, _InstantModel, {}, scheduler="pbt")
    with pytest.raises(ValueError, match="exclusive"):
        TPUSearchEngine(scheduler="asha", device="cpu").compile(
            None, _InstantModel, {}, search_alg="bayes")
    # the port has no compile plane: a cache object is refused
    with pytest.raises(NotImplementedError, match="A12"):
        _runtime(_fake_trials(1), compile_cache=object())


def test_engine_asha_with_fake_models():
    eng = TPUSearchEngine(name="asha_fake", scheduler="asha",
                          scheduler_params={"eta": 3, "grace_period": 1},
                          device="cpu")
    eng.compile(None, _FakeModel, {"lr": 0.0}, n_sampling=9, epochs=9,
                metric="mse", metric_mode="min")
    for i, t in enumerate(eng._trials):
        t.config = {"lr": 0.01 * i}
    eng.run()
    s = eng.summary()
    assert s["epochs"]["trained"] < s["epochs"]["exhaustive"]
    assert s["chips"]["utilization"] >= 0
    assert eng.get_best_trial().config["lr"] == 0.0


# --- the port against the JAX runtime ---------------------------------------

def _strip(events):
    """Event dicts without the wall-clock and chip fields."""
    drop = {"t", "wall_s", "chip", "chips", "trace"}
    return [{k: v for k, v in e.items() if k not in drop} for e in events]


@pytest.mark.parametrize("kind", ["trial_context", "state_only"])
def test_runtime_matches_jax_runtime(kind):
    """Nine trials on one lease through each package's runtime: equal rung
    geometry over a grid, fingerprint, event sequence, rung ledger, epochs,
    counters and trial results."""
    for max_t in (1, 4, 5, 9, 27):
        for eta in (2, 3, 4):
            for grace in (1, 2, 3):
                assert asha_rungs(max_t, eta, grace) == \
                    jasha.asha_rungs(max_t, eta, grace)
    model = _FakeModel if kind == "trial_context" else _StateOnlyModel
    jtrials = _fake_trials(9, trial_cls=jsearch.Trial)
    ttrials = _fake_trials(9)
    jrt = _runtime(jtrials, model_cls=model, runtime_cls=jruntime.TrialRuntime,
                   devices=jax.local_devices()[:1], compile_cache=False,
                   name="parity")
    trt = _runtime(ttrials, model_cls=model, name="parity")
    assert trt._fingerprint() == jrt._fingerprint()
    jrt.run()
    trt.run()
    assert _strip(trt._ev.recent()) == _strip(jrt._ev.recent())
    js, ts = jrt.summary(), trt.summary()
    for key in ("status", "rungs", "epochs", "counters", "trials",
                "events", "max_t", "eta", "compile"):
        assert ts[key] == js[key], key
    assert [(t.state, t.metric_value, t.epochs_trained, t.rung)
            for t in ttrials] == [(t.state, t.metric_value, t.epochs_trained,
                                   t.rung) for t in jtrials]


# --- pause/resume bit-equivalence on a real model ---------------------------

class _MLP(nn.Module):
    """Its dropout draws from the engine's generator, seeded by the step."""

    def __init__(self, hidden=4):
        super().__init__()
        torch.manual_seed(0)
        self.fc1 = nn.Linear(4, hidden)
        self.drop = Dropout(0.1)
        self.fc2 = nn.Linear(hidden, 1)

    def forward(self, x):
        return self.fc2(self.drop(torch.relu(self.fc1(x))))


def _mlp_builder():
    return ModelBuilder(lambda config: _MLP(config.get("hidden", 4)),
                        loss_creator=lambda config: nn.MSELoss())


def _mlp_data(n=64, seed=0):
    r = np.random.RandomState(seed)
    x = r.rand(n, 4).astype(np.float32)
    y = (x @ np.array([1., -2., 3., .5], np.float32) + .1)[:, None]
    return {"x": x, "y": y.astype(np.float32)}


def test_pause_resume_bit_equivalence(tmp_path):
    """A trial paused at a rung and resumed from its checkpoint (the
    checkpoint plane's disk round trip, as the runtime writes it) gives
    bit-identical weights to one trained straight through: the engine step
    (dropout's generator) rides in the state and fit(initial_epoch=...)
    re-aligns the shuffle. The control resumes with the shuffle's epoch
    off by one: the same steps, other batches, other weights."""
    builder = _mlp_builder()
    data = _mlp_data()
    cfg = {"lr": 0.05, "hidden": 4, "batch_size": 16}

    straight = builder(cfg, "cpu")
    s1, _, state1 = straight.fit_eval(data, None, epochs=4, metric="mse")

    part1 = builder(cfg, "cpu")
    _, _, ckpt = part1.fit_eval(data, None, epochs=2, metric="mse")
    plane = CheckpointPlane(str(tmp_path), keep_last_k=2)
    path = plane.save(ckpt, 2, name="trial_0")
    assert plane.flush()
    ckpt = load_checkpoint_dir(path)
    assert isinstance(ckpt["params"]["fc1.weight"], np.ndarray)
    part2 = builder(cfg, "cpu")                  # fresh model, fresh engine
    s2, _, state2 = part2.fit_eval(data, None, epochs=4, metric="mse",
                                   state=ckpt)
    assert s1 == s2
    assert state1["step"] == state2["step"] == 16
    for name, t in state1["params"].items():
        assert torch.equal(t, state2["params"][name]), name

    control = builder(cfg, "cpu")
    control.fit_eval(data, None, epochs=0, metric="mse", state=ckpt)
    control.estimator.fit(data, epochs=2, batch_size=16, verbose=False,
                          initial_epoch=3)
    off = control.estimator.engine.get_state()
    assert off["step"] == state1["step"]
    assert not all(torch.equal(t, off["params"][n])
                   for n, t in state1["params"].items())
    plane.close()


# --- the entry points --------------------------------------------------------

def _auto(logs_dir=None, builder_cls=None):
    auto = AutoEstimator.from_torch(
        model_creator=lambda c: _MLP(c.get("hidden", 4)), loss=nn.MSELoss(),
        optimizer="adam", device="cpu", logs_dir=logs_dir)
    if builder_cls is not None:
        b = auto.model_builder
        auto.model_builder = builder_cls(b.model_creator,
                                         b.optimizer_creator, b.loss_creator)
    return auto


def test_auto_estimator_asha_end_to_end():
    """The JAX suite's (slow) acceptance test at a small size: ASHA spends
    fewer epochs than the exhaustive search and its winner, trained the
    full budget, scores within 1.5x of the exhaustive best; the hopeless lr
    never wins."""
    def fit_once(scheduler):
        auto = _auto()
        auto.fit(_mlp_data(n=128), epochs=8,
                 validation_data=_mlp_data(n=128, seed=1),
                 metric="mse", metric_mode="min", n_sampling=1,
                 search_space={"lr": hp.grid_search([0.2, 0.18, 1e-5]),
                               "hidden": 4, "batch_size": 32},
                 scheduler=scheduler,
                 scheduler_params={"eta": 2, "grace_period": 2})
        return auto

    asha = fit_once("asha")
    full = fit_once(None)
    s = asha.search_summary()
    assert s["epochs"]["trained"] < s["epochs"]["exhaustive"]
    assert asha.best_trial.metric_value <= full.best_trial.metric_value * 1.5
    assert asha.best_trial.config["lr"] > 1e-3
    assert asha.best_trial.epochs_trained == 8
    assert all(t.device == "cpu" for t in asha.get_trials())
    est = asha.get_best_model()
    res = est.evaluate(_mlp_data(n=128, seed=1), batch_size=32,
                       verbose=False)
    assert res["mse"] == asha.best_trial.metric_value


class _SigtermAtContinue:
    """A model builder whose trials' reports are counted; at the first
    report from ``at`` on that lets its trial train on ("continue"), it
    sends the process SIGTERM and waits until the study halts, so the
    trial is preempted at its next heartbeat: a deterministic point."""

    at = 1

    def __init__(self):
        self.count, self.fired = 0, False

    def wrap(self, ctx):
        hook = self

        class _Ctx:
            def __getattr__(self, name):
                return getattr(ctx, name)

            def report(self, step, metric):
                hook.count += 1
                out = ctx.report(step, metric)
                if not hook.fired and hook.count >= hook.at \
                        and out == "continue":
                    hook.fired = True
                    os.kill(os.getpid(), signal.SIGTERM)
                    assert ctx._runtime._halt.wait(10)
                return out
        return _Ctx()


def _hooked_builder(hook):
    class Builder(ModelBuilder):
        def __call__(self, config, device):
            tm = super().__call__(config, device)
            fit_eval = tm.fit_eval

            def hooked(data, validation_data=None, epochs=1, metric="mse",
                       state=None, trial_context=None):
                return fit_eval(data, validation_data, epochs, metric,
                                state=state,
                                trial_context=hook.wrap(trial_context))
            tm.fit_eval = hooked
            return tm
    return Builder


def test_auto_estimator_sigterm_manifest_resume(tmp_path):
    """SIGTERM mid-study from a report hook: ``fit`` returns with the study
    ``preempted`` and the running trial checkpointed; a fresh
    ``AutoEstimator`` on the same ``logs_dir`` adopts the manifest, and its
    rung ledger and winner (config, epochs, score) equal an uninterrupted
    study's on one lease."""
    def fit(logs, builder_cls=None):
        auto = _auto(str(logs), builder_cls)
        auto.fit(_mlp_data(128), epochs=9,
                 validation_data=_mlp_data(64, seed=1), metric="mse",
                 n_sampling=6, search_space={
                     "lr": hp.loguniform(1e-4, 1e-1),
                     "batch_size": hp.grid_search([16, 32])},
                 scheduler="asha",
                 scheduler_params={"eta": 3, "grace_period": 1})
        return auto

    ref = fit(tmp_path / "straight")
    hook = _SigtermAtContinue()
    logs = tmp_path / "preempted"
    cut = fit(logs, _hooked_builder(hook))
    assert hook.fired
    assert cut.searcher._runtime.summary()["status"] == "preempted"
    with open(logs / "study_state.json") as f:
        manifest = json.load(f)
    assert manifest["status"] == "preempted"
    inflight = [t for t in manifest["trials"]
                if t["status"] == "paused" and t["runnable"]]
    assert len(inflight) == 1 and inflight[0]["epochs_done"] > 0
    assert os.path.isdir(inflight[0]["ckpt"])
    resumed = fit(logs)
    s, want = resumed.search_summary(), ref.search_summary()
    assert s["status"] == "completed"
    assert s["trials"] == {"total": 12, "done": 12}
    assert s["rungs"] == want["rungs"]
    assert s["epochs"] == want["epochs"]
    a, b = resumed.best_trial, ref.best_trial
    assert (a.config, a.epochs_trained, a.metric_value) == \
        (b.config, b.epochs_trained, b.metric_value)


def _series(n, seed=0):
    rng = np.random.RandomState(seed)
    value = (np.sin(np.arange(n) / 24 * 2 * np.pi)
             + 0.1 * rng.randn(n)).astype(np.float32)
    return pd.DataFrame({"datetime": pd.date_range("2024-01-01", periods=n,
                                                   freq="h"),
                         "value": value})


def test_autots_asha_end_to_end():
    """``AutoTSTrainer(scheduler="asha")`` over a small LSTM recipe: the
    same trial configs as the exhaustive search, every trial done on the
    CPU, fewer epochs, rung populations shrinking, the winner trained the
    full budget and within 1.5x of the exhaustive best."""
    from analytics_zoo_tpu_torch.zouwu.autots import AutoTSTrainer
    from analytics_zoo_tpu_torch.zouwu.config.recipe import \
        LSTMGridRandomRecipe

    df = _series(300)
    runs = {}
    for scheduler in ("asha", None):
        tr = AutoTSTrainer(horizon=1, device="cpu", scheduler=scheduler,
                           scheduler_params={"eta": 3, "grace_period": 1})
        pipe = tr.fit(df, recipe=LSTMGridRandomRecipe(
            num_rand_samples=3, epochs=3, lstm_1_units=[8],
            lstm_2_units=[8]))
        runs[scheduler] = (tr, pipe)
    (asha, pipe), (full, _) = runs["asha"], runs[None]
    trials = asha.engine._trials
    assert [t.config for t in trials] == [t.config for t in
                                          full.engine._trials]
    assert all(t.state == "done" and t.device == "cpu" for t in trials)
    s = asha.engine.summary()
    assert s["status"] == "completed"
    assert s["epochs"]["trained"] < s["epochs"]["exhaustive"] == 6 * 3
    reported = [r["reported"] for r in s["rungs"]]
    assert reported[0] == 6 and reported[0] > reported[-1] >= 1
    best, full_best = asha.engine.get_best_trial(), \
        full.engine.get_best_trial()
    assert best.epochs_trained == 3
    assert best.metric_value <= 1.5 * full_best.metric_value
    res = pipe.evaluate(df, metrics=["mse"])
    assert np.isfinite(res["mse"])


# --- AutoXGBoost --------------------------------------------------------------

@pytest.mark.parametrize("kind", ["regressor", "classifier"])
def test_auto_xgb_equals_jax(kind):
    """The JAX suite's AutoXGBoost searches (tests/test_batch3_components.py)
    through each package (the bundled histogram GBT on both): the same best
    config and predictions, bit for bit, with the JAX suite's quality
    bars."""
    if kind == "regressor":
        from analytics_zoo_tpu.zouwu.config.recipe import \
            XgbRegressorGridRandomRecipe as JRecipe
        from analytics_zoo_tpu_torch.zouwu.config.recipe import \
            XgbRegressorGridRandomRecipe as TRecipe
        rng = np.random.RandomState(0)
        x = rng.rand(600, 6)
        y = (10 * np.sin(np.pi * x[:, 0] * x[:, 1]) + 5 * x[:, 3]
             + 0.2 * rng.randn(600))
        train, val = (x[:480], y[:480]), (x[480:], y[480:])
        spaces = [r(num_rand_samples=1, n_estimators=(30,),
                    max_depth=(3, 5)).search_space([])
                  for r in (JRecipe, TRecipe)]
        name, metric, n_sampling = "AutoXGBRegressor", "rmse", 1
    else:
        rng = np.random.RandomState(1)
        x = rng.randn(500, 5)
        y = (x[:, 0] + x[:, 1] > 0).astype(int)
        train, val = (x[:400], y[:400]), (x[400:], y[400:])
        spaces = [{"n_estimators": m.grid_search([30]),
                   "max_depth": m.grid_search([3]),
                   "lr": m.loguniform(1e-2, 3e-1)} for m in (jhp, hp)]
        name, metric, n_sampling = "AutoXGBClassifier", "error", 2
    j = getattr(jxgb, name)().fit(train, validation_data=val, metric=metric,
                                  search_space=spaces[0],
                                  n_sampling=n_sampling)
    t = getattr(txgb, name)(device="cpu").fit(
        train, validation_data=val, metric=metric, search_space=spaces[1],
        n_sampling=n_sampling)
    assert t.get_best_config() == j.get_best_config()
    pred = t.predict(val[0])
    np.testing.assert_array_equal(pred, j.predict(val[0]))
    assert isinstance(t.get_best_model(), tgbt._BaseGBT)
    if kind == "regressor":
        assert pred.shape == (120,)
        rmse = float(np.sqrt(np.mean((pred - val[1]) ** 2)))
        assert rmse < 0.7 * float(np.std(val[1]))
    else:
        assert float(np.mean(pred == val[1])) > 0.9


def test_hist_gbt_equals_jax():
    """The bundled histogram GBT: regression, binary and multiclass fits
    equal the JAX package's copy bit for bit, with the JAX suite's
    quality bars."""
    rng = np.random.RandomState(0)
    x = rng.randn(600, 6)
    y = x[:, 0] * 3 + np.sin(2 * x[:, 1]) + 0.1 * rng.randn(600)
    kw = dict(n_estimators=30, max_depth=4, learning_rate=0.2)
    a = tgbt.ZooGBTRegressor(**kw).fit(x[:500], y[:500])
    b = jgbt.ZooGBTRegressor(**kw).fit(x[:500], y[:500])
    np.testing.assert_array_equal(a.predict(x[500:]), b.predict(x[500:]))
    r2 = 1 - np.mean((a.predict(x[500:]) - y[500:]) ** 2) / np.var(y[500:])
    assert r2 > 0.9, r2
    assert a.get_params()["max_depth"] == 4
    assert a.set_params(max_depth=2).max_depth == 2
    for labels in ((x[:, 0] > 0).astype(int), np.digitize(x[:, 0],
                                                          [-0.5, 0.5])):
        kw = dict(n_estimators=20, max_depth=4, learning_rate=0.3)
        c = tgbt.ZooGBTClassifier(**kw).fit(x[:500], labels[:500])
        d = jgbt.ZooGBTClassifier(**kw).fit(x[:500], labels[:500])
        np.testing.assert_array_equal(c.predict_proba(x[500:]),
                                      d.predict_proba(x[500:]))
        np.testing.assert_array_equal(c.predict(x[500:]), d.predict(x[500:]))
        assert float(np.mean(c.predict(x[500:]) == labels[500:])) > 0.9


def test_new_modules_import_nothing_of_jax():
    """This slice's modules import no JAX, flax, optax, pandas or the JAX
    package anywhere, inside functions included (the import test of the
    whole port, tests/test_torch_serving.py, sees only imports at load)."""
    import ast

    root = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "analytics_zoo_tpu_torch")
    files = ["automl/scheduler/asha.py", "automl/scheduler/events.py",
             "automl/scheduler/runtime.py", "automl/scheduler/__init__.py",
             "orca/learn/preemption.py", "automl/xgboost/__init__.py",
             "automl/xgboost/hist_gbt.py", "automl/xgboost/auto_xgb.py"]
    banned = {"jax", "jaxlib", "flax", "optax", "pandas", "analytics_zoo_tpu"}
    for rel in files:
        with open(os.path.join(root, rel)) as f:
            tree = ast.parse(f.read())
        names = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names.append(node.module)
        assert not [n for n in names if n.split(".")[0] in banned], rel
