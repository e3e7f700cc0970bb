"""HPO search engine with device-leased trials (counterpart of
``analytics_zoo_tpu/automl/search/search_engine.py``).

The reference's engine is Ray Tune (pyzoo/zoo/automl/search/
ray_tune_search_engine.py: compile() builds a trainable from a ModelBuilder
+ search space, run() launches trials as Ray actors). Here, as in the JAX
package, trials are sampled from the hp DSL (random + grid) and run on the
local devices, **each trial exclusively leasing one device** through
``scheduler.DeviceLeaseManager``. ``model_builder(config, device)`` gets
the leased torch device (the JAX engine passes a one-chip mesh), and the
trial runs with it as the current CUDA device.

``TPUSearchEngine(device=...)`` picks the inventory: ``None`` means every
visible card, and without a GPU it raises unless given ``device="cpu"``.

Three execution modes, as in the JAX package:

* default — trials train their full epoch budget on a thread pool (one
  leased device each); ``stop_score`` cancels not-yet-started trials once
  a completed one reaches the threshold.
* ``search_alg="bayes"`` — sequential GP-EI proposal loop.
* ``scheduler="asha"`` — the fault-tolerant rung scheduler
  (``automl.scheduler.TrialRuntime``) over the same leased devices:
  mid-training reports, pause/resume via checkpoint, retry-with-backoff,
  SIGTERM study preemption + manifest resume.
"""

from __future__ import annotations

import logging
import threading
import time
import traceback
from concurrent.futures import CancelledError, ThreadPoolExecutor, as_completed
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ...common.context import local_devices
from .. import hp as hp_dsl

logger = logging.getLogger("analytics_zoo_tpu_torch")

# "parameter not passed" sentinel: keep_model_states=None is a meaningful
# value (keep every state), so compile()/fit() can't use None for "inherit"
UNSET = object()


@dataclass
class Trial:
    trial_id: int
    config: Dict[str, Any]
    metric_value: Optional[float] = None
    metrics: Dict[str, float] = field(default_factory=dict)
    state: str = "pending"  # pending | running | paused | done | error | cancelled
    error: Optional[str] = None
    duration_s: float = 0.0
    model_state: Any = None
    device: Any = None
    # scheduler bookkeeping (stays at defaults on the non-scheduler paths)
    epochs_trained: int = 0
    rung: int = -1
    retries: int = 0


class SearchEngine:
    """(reference base: pyzoo/zoo/automl/search/base.py:25)"""

    def compile(self, *args, **kwargs):
        raise NotImplementedError

    def run(self) -> List[Trial]:
        raise NotImplementedError

    def get_best_trial(self) -> Trial:
        raise NotImplementedError


class TPUSearchEngine(SearchEngine):
    def __init__(self, max_concurrent: Optional[int] = None,
                 name: str = "auto_estimator", seed: int = 42,
                 logs_dir: Optional[str] = None,
                 scheduler: Optional[str] = None,
                 scheduler_params: Optional[Dict[str, Any]] = None,
                 keep_model_states: Optional[int] = 1, device=None):
        self.devices = local_devices(device)
        self.name = name
        self.seed = seed
        self.max_concurrent = max_concurrent
        self.logs_dir = logs_dir
        self.scheduler = scheduler
        self.scheduler_params = scheduler_params
        self.keep_model_states = keep_model_states
        self._trials: List[Trial] = []
        self._compiled = False
        self._leases_utilization: Optional[Dict[str, Any]] = None
        self._scheduler_summary: Optional[Dict[str, Any]] = None
        self._state_lock = threading.Lock()

    def compile(self, data, model_builder: Callable[[Dict], Any],
                search_space: Dict[str, Any], n_sampling: int = 1,
                epochs: int = 1, validation_data=None, metric: str = "mse",
                metric_mode: str = "min", batch_size_key: str = "batch_size",
                search_alg: Optional[str] = None,
                stop_score: Optional[float] = None,
                scheduler: Optional[str] = None,
                scheduler_params: Optional[Dict[str, Any]] = None,
                keep_model_states: Any = UNSET):
        """model_builder(config, device) -> object with
        fit_eval(data, validation_data, epochs, metric) -> (score, metrics,
        state). The runtime also understands the extended fit_eval
        protocol (``state=`` / ``trial_context=`` kwargs, detected by
        signature) — see automl/scheduler/runtime.py.

        ``search_alg="bayes"`` switches run() to a sequential GP-EI loop
        over the continuous axes (reference: ray_tune_search_engine.py:176
        wires the 'bayesopt' searcher; here search/bayes.py supplies a
        dependency-free picker).

        ``stop_score``: early-stop threshold (the reference recipes'
        ``reward_metric`` wired into tune's stop condition) — sequential
        runs stop launching trials once a completed trial reaches it
        (<= for metric_mode 'min', >= for 'max'); concurrent runs cancel
        every not-yet-started trial (marked ``cancelled``); the ASHA
        scheduler checkpoints running trials and halts the study.

        ``scheduler="asha"``: execute through the fault-tolerant rung
        scheduler; ``epochs`` becomes the max per-trial budget (max_t) and
        ``scheduler_params`` may set eta, grace_period, max_trial_retries,
        retry_backoff_s.

        ``keep_model_states``: retain trained ``model_state`` only for the
        current top-k completed trials (default 1 — enough for
        ``get_best_model``); others are dropped eagerly to bound host
        memory. ``None`` keeps every state."""
        self.data = data
        self.validation_data = validation_data
        self.model_builder = model_builder
        self.search_space = search_space
        self.n_sampling = n_sampling
        self.epochs = epochs
        self.metric = metric
        assert metric_mode in ("min", "max")
        self.metric_mode = metric_mode
        if search_alg not in (None, "bayes"):
            raise ValueError(f"unknown search_alg {search_alg!r} "
                             "(supported: None, 'bayes')")
        self.search_alg = search_alg
        self.stop_score = stop_score
        if scheduler is not None:
            self.scheduler = scheduler
        if scheduler_params is not None:
            self.scheduler_params = scheduler_params
        if keep_model_states is not UNSET:
            self.keep_model_states = keep_model_states
        if self.scheduler not in (None, "asha"):
            raise ValueError(f"unknown scheduler {self.scheduler!r} "
                             "(supported: None, 'asha')")
        if self.scheduler and self.search_alg == "bayes":
            raise ValueError(
                "scheduler='asha' and search_alg='bayes' are exclusive: the "
                "GP-EI loop needs sequential full-fidelity observations")
        # grid axes expand; the remaining axes are sampled n_sampling times
        grid = hp_dsl.grid_configs(search_space)
        rng = np.random.RandomState(self.seed)
        configs = []
        for g in grid:
            for _ in range(self.n_sampling):
                configs.append(hp_dsl.sample_config(g, rng))
        self._trials = [Trial(i, c) for i, c in enumerate(configs)]
        self._compiled = True
        return self

    # --- model_state retention (memory bound) -------------------------------
    def _retain_model_states(self, _trial=None):
        """Keep ``model_state`` only for the current top-k completed trials;
        drop the rest eagerly (errored/pruned trials' states, and previous
        leaders displaced by a better completion)."""
        k = self.keep_model_states
        if k is None:
            return
        with self._state_lock:
            done = sorted(
                [t for t in self._trials
                 if t.state == "done" and t.metric_value is not None],
                key=lambda t: t.metric_value,
                reverse=self.metric_mode == "max")
            keep = {id(t) for t in done[:max(int(k), 0)]}
            for t in self._trials:
                if t.model_state is not None and id(t) not in keep:
                    t.model_state = None

    def run(self, resume="auto") -> List[Trial]:
        assert self._compiled, "call compile() first"
        if self.scheduler == "asha":
            return self._run_asha(resume)
        from ..scheduler.lease import DeviceLeaseManager, current_device

        leases = DeviceLeaseManager(self.devices)
        workers = self.max_concurrent or len(leases)
        stop_flag = threading.Event()

        def run_trial(trial: Trial):
            trial.state = "running"
            t0 = time.time()
            try:
                # exclusive device lease (pinning by devices[id % n]
                # double-books devices whenever max_concurrent > len(devices))
                with leases.acquire(owner=trial.trial_id) as lease, \
                        current_device(lease.device):
                    if stop_flag.is_set():
                        # stop_score was reached while this trial waited for
                        # a device (future.cancel() can't reach futures
                        # already claimed by a pool worker) — drop it
                        # untrained
                        trial.state = "cancelled"
                        return trial
                    trial.device = str(lease.device)
                    model = self.model_builder(trial.config, lease.device)
                    score, metrics, state = model.fit_eval(
                        self.data, self.validation_data, epochs=self.epochs,
                        metric=self.metric)
                trial.metric_value = float(score)
                trial.metrics = metrics
                trial.model_state = state
                trial.epochs_trained = self.epochs
                trial.state = "done"
                self._retain_model_states()
            except Exception as e:  # noqa: BLE001 — a failed trial is a result
                trial.state = "error"
                trial.error = f"{e}\n{traceback.format_exc()}"
                logger.warning("trial %d failed: %s", trial.trial_id, e)
            trial.duration_s = time.time() - t0
            return trial

        def reached_stop(trial):
            if self.stop_score is None or trial.state != "done":
                return False
            if self.metric_mode == "min":
                return trial.metric_value <= self.stop_score
            return trial.metric_value >= self.stop_score

        if getattr(self, "search_alg", None) == "bayes":
            # sequential by construction: each proposal conditions on every
            # completed trial (grid/choice axes keep per-trial random draws)
            from .bayes import GPEIPicker, SpaceCodec

            codec = SpaceCodec(self.search_space)
            picker = GPEIPicker(max(codec.dim, 1))
            rng = np.random.RandomState(self.seed + 1)
            n_init = max(2, len(self._trials) // 3)
            sign = 1.0 if self.metric_mode == "min" else -1.0
            for i, trial in enumerate(self._trials):
                if codec.dim and i >= n_init:
                    resampled = hp_dsl.sample_config(self.search_space, rng)
                    trial.config = codec.decode_into(
                        picker.suggest(rng), resampled)
                run_trial(trial)
                if codec.dim:
                    score = (trial.metric_value if trial.state == "done"
                             else float("inf"))
                    picker.observe(codec.encode(trial.config),
                                   sign * score)
                if reached_stop(trial):
                    self._trials = self._trials[:i + 1]
                    break
        elif workers <= 1 or len(self._trials) <= 1:
            for i, t in enumerate(self._trials):
                run_trial(t)
                if reached_stop(t):
                    self._trials = self._trials[:i + 1]
                    break
        else:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                futs = {pool.submit(run_trial, t): t for t in self._trials}
                stopping = False
                for fut in as_completed(futs):
                    try:
                        t = fut.result()
                    except CancelledError:
                        continue
                    if not stopping and reached_stop(t):
                        # threshold hit: cancel everything not yet training.
                        # future.cancel() reaps futures the pool hasn't
                        # claimed; the stop_flag reaps trials already claimed
                        # but still waiting on a device lease. Trials actually
                        # training run to completion — threads can't be
                        # interrupted mid-step.
                        stopping = True
                        stop_flag.set()
                        n_cancelled = 0
                        for other, ot in futs.items():
                            if other.cancel():
                                ot.state = "cancelled"
                                n_cancelled += 1
                        logger.info(
                            "stop_score %.6g reached by trial %d; "
                            "cancelled %d queued trials (device-waiters "
                            "drop at lease time)",
                            self.stop_score, t.trial_id, n_cancelled)
        self._leases_utilization = leases.utilization()
        done = [t for t in self._trials if t.state == "done"]
        logger.info("search finished: %d/%d trials succeeded",
                    len(done), len(self._trials))
        if not done:
            errs = "\n".join(t.error or "?" for t in self._trials[:3])
            raise RuntimeError(f"all trials failed; first errors:\n{errs}")
        return self._trials

    def _run_asha(self, resume="auto") -> List[Trial]:
        from ..scheduler.runtime import TrialRuntime

        params = dict(self.scheduler_params or {})
        runtime = TrialRuntime(
            trials=self._trials, model_builder=self.model_builder,
            data=self.data, validation_data=self.validation_data,
            metric=self.metric, metric_mode=self.metric_mode,
            max_t=self.epochs, eta=params.get("eta", 3),
            grace_period=params.get("grace_period", 1),
            max_concurrent=self.max_concurrent,
            max_trial_retries=params.get("max_trial_retries", 2),
            retry_backoff_s=params.get("retry_backoff_s", 0.5),
            logs_dir=self.logs_dir, name=self.name,
            stop_score=self.stop_score, devices=self.devices,
            on_trial_done=self._retain_model_states)
        self._runtime = runtime
        runtime.run(resume=resume)
        self._scheduler_summary = runtime.summary()
        done = [t for t in self._trials if t.state == "done"]
        logger.info(
            "asha study %s: %d/%d trials done, %d epochs trained "
            "(exhaustive: %d)", runtime._status, len(done), len(self._trials),
            self._scheduler_summary["epochs"]["trained"],
            self._scheduler_summary["epochs"]["exhaustive"])
        if not done and runtime._status == "completed":
            errs = "\n".join(t.error or "?" for t in self._trials[:3])
            raise RuntimeError(f"all trials failed; first errors:\n{errs}")
        return self._trials

    def summary(self) -> Dict[str, Any]:
        """Study telemetry: the scheduler's full summary (rungs, counters,
        device utilization, epoch savings) when scheduler='asha' ran, else
        trials by state, epochs trained, and the device leases'
        utilization of the last run."""
        if self._scheduler_summary is not None:
            return self._scheduler_summary
        by_state: Dict[str, int] = {}
        for t in self._trials:
            by_state[t.state] = by_state.get(t.state, 0) + 1
        return {"study": self.name, "trials": {"total": len(self._trials),
                                               **by_state},
                "epochs": {"trained": sum(t.epochs_trained
                                          for t in self._trials)},
                "devices": self._leases_utilization}

    def get_best_trial(self) -> Trial:
        done = [t for t in self._trials
                if t.state == "done" and t.metric_value is not None]
        key = (min if self.metric_mode == "min" else max)
        return key(done, key=lambda t: t.metric_value)

    def get_best_trials(self, k: int = 1) -> List[Trial]:
        done = sorted([t for t in self._trials
                       if t.state == "done" and t.metric_value is not None],
                      key=lambda t: t.metric_value,
                      reverse=self.metric_mode == "max")
        return done[:k]

