"""TrialRuntime — fault-tolerant, device-leased ASHA trial execution
(counterpart of ``analytics_zoo_tpu/automl/scheduler/runtime.py``, the
same behaviour over torch devices).

Where ``TPUSearchEngine.run()`` maps fully-trained trials over a thread
pool, the runtime treats trials as *schedulable, pausable jobs* over a
device inventory, the way large accelerator-pod efforts treat many
concurrent training runs as a resource problem (arXiv:1909.09756) rather
than a static map:

* **Devices are leased**, never modulo-assigned: ``DeviceLeaseManager``
  guarantees one running trial per device even when ``max_concurrent``
  exceeds the device count. The model builder gets the lease's torch
  device (``model_builder(config, device)``; the JAX runtime passes a
  one-chip mesh), and the slice runs with it as the current CUDA device.
* **Rungs, not full runs**: trials report metrics mid-training through
  ``TrialContext.report(step, metric)``; the ``AshaBracket`` promotes
  the top ``1/eta`` at each rung and pauses the rest via checkpoint.
  Promoted trials **resume from their checkpoint** instead of
  retraining.
* **Failures are transient until proven fatal**: a crashed trial slice
  retries with exponential backoff up to ``max_trial_retries``, resuming
  from its last checkpoint (the same retry-from-snapshot contract as
  ``TPUEstimator.fit``).
* **SIGTERM is a checkpoint, not a kill**: ``PreemptionWatcher`` turns a
  preemption notice into checkpoint-all-running-trials + a study-state
  JSON manifest under ``logs_dir``; a later ``run()`` resumes the study
  from the manifest with every trial accounted for.
* **Telemetry**: per-trial/per-rung timings, device utilization and
  promote/pause/retry counters via ``summary()``; every transition is a
  line in ``logs_dir/study_events.jsonl``, with the JAX package's event
  names and fields (a lease's index is its ``chip``).
* **No compile cache**: the port has no compile plane (ROADMAP A12).
  ``compile_cache`` is kept so the constructor matches the JAX runtime's;
  ``None`` and ``False`` both mean no cache (``summary()["compile"]`` is
  ``{}``, as the JAX runtime's is under ``compile_cache=False``), a cache
  object raises ``NotImplementedError``, and builders are called as
  ``model_builder(config, device)``.

The ``fit_eval`` protocol is extended, not replaced — capabilities are
detected by signature so existing model builders keep working unchanged:

* legacy: ``fit_eval(data, validation_data, epochs, metric)`` — the
  runtime drives it rung-by-rung with a cumulative epoch budget
  (pausing re-trains from scratch on resume).
* ``+ state=None``: state-in/state-out — ``epochs`` becomes a
  *cumulative* target and a paused trial resumes from the returned
  state instead of retraining.
* ``+ trial_context=None``: the model reports mid-training through
  ``TrialContext`` and the scheduler pauses it *inside* ``fit_eval``
  (raising ``TrialPaused``), giving rung-granularity preemption.
"""

from __future__ import annotations

import hashlib
import heapq
import inspect
import json
import logging
import os
import threading
import time
import traceback
from collections import deque
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Any, Callable, Dict, List, Optional

from ...obs import trace as _trace
from ...orca.learn import graphs as _graphs
from .asha import AshaBracket
from .events import EventLog, _jsonable
from .lease import DeviceLeaseManager, current_device

logger = logging.getLogger("analytics_zoo_tpu_torch")

__all__ = ["TrialRuntime", "TrialContext", "TrialPaused", "TrialPreempted"]

MANIFEST_NAME = "study_state.json"


class TrialPaused(Exception):
    """Raised inside fit_eval when the scheduler pauses the trial at a rung."""

    def __init__(self, rung: int):
        super().__init__(f"paused at rung {rung}")
        self.rung = rung


class TrialPreempted(Exception):
    """Raised inside fit_eval when the study is halting (SIGTERM/stop_score);
    the trial checkpoints and yields its device."""


def _fit_eval_caps(fn: Callable) -> Dict[str, bool]:
    """Which extended-protocol kwargs this fit_eval explicitly accepts.
    ``**kwargs`` is deliberately NOT trusted — a legacy builder swallowing
    ``state=`` silently would retrain while the runtime believes it
    resumed."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return {"state": False, "trial_context": False}
    return {"state": "state" in params,
            "trial_context": "trial_context" in params}


class TrialContext:
    """Handed to capability-aware ``fit_eval`` implementations; the trial's
    one channel back into the scheduler. ``report(step, metric)`` records a
    (cumulative-epoch, score) observation — at rung boundaries it carries
    the ASHA decision, raising ``TrialPaused`` when the trial loses its
    rung. ``heartbeat()`` between training segments gives the scheduler a
    safe point to preempt (``TrialPreempted``)."""

    def __init__(self, runtime: "TrialRuntime", trial, epochs_done: int = 0):
        self.trial_id = trial.trial_id
        self.max_t = runtime.max_t
        self.epochs_done = int(epochs_done)
        self.reports: List = []
        self.checkpoint = None
        self._runtime = runtime
        self._trial = trial
        self._state_fn: Optional[Callable[[], Any]] = None

    def set_state_fn(self, fn: Callable[[], Any]):
        """Register how to snapshot this trial's training state; called by
        the scheduler at pause/preemption time."""
        self._state_fn = fn

    def next_boundary(self, epochs_done: Optional[int] = None) -> Optional[int]:
        """The next cumulative-epoch rung boundary (None past the last)."""
        done = self.epochs_done if epochs_done is None else int(epochs_done)
        return self._runtime.bracket.next_boundary(done)

    def should_report(self, epochs_done: int) -> bool:
        return int(epochs_done) in self._runtime.bracket.rungs

    def _capture(self):
        if self._state_fn is not None:
            self.checkpoint = self._state_fn()

    def heartbeat(self, epochs_done: Optional[int] = None):
        """Cheap safe-point between training segments: raises
        ``TrialPreempted`` (after capturing a checkpoint) when the study is
        halting."""
        if epochs_done is not None:
            self.epochs_done = int(epochs_done)
        rt = self._runtime
        if rt._halt.is_set():
            self._capture()
            raise TrialPreempted(rt._halt_reason)

    def report(self, step: int, metric: float) -> str:
        """Report a score at ``step`` cumulative epochs. Returns
        ``"continue"`` / ``"stop"`` (final rung); raises ``TrialPaused`` or
        ``TrialPreempted`` when the device must be yielded."""
        step = int(step)
        metric = float(metric)
        self.epochs_done = step
        self.reports.append((step, metric))
        rt = self._runtime
        rt._ev.emit("report", trial=self.trial_id, epochs=step, metric=metric)
        if rt._halt.is_set():
            self._capture()
            raise TrialPreempted(rt._halt_reason)
        try:
            rung = rt.bracket.rungs.index(step)
        except ValueError:
            return "continue"          # telemetry-only report between rungs
        decision = rt.bracket.report(self.trial_id, rung, metric)
        rt._on_decision(self._trial, rung, metric, decision)
        if decision == "pause":
            self._capture()
            raise TrialPaused(rung)
        return "continue" if decision == "promote" else "stop"


class TrialRuntime:
    """Drives a set of ``Trial``s to ASHA completion over leased devices."""

    def __init__(self, trials: List, model_builder: Callable, data,
                 validation_data=None, metric: str = "mse",
                 metric_mode: str = "min", max_t: int = 1, eta: int = 3,
                 grace_period: int = 1, max_concurrent: Optional[int] = None,
                 max_trial_retries: int = 2, retry_backoff_s: float = 0.5,
                 logs_dir: Optional[str] = None, name: str = "study",
                 stop_score: Optional[float] = None,
                 devices: Optional[List] = None,
                 on_trial_done: Optional[Callable] = None,
                 compile_cache=None, retry_policy=None):
        from ...resilience.retry import RetryPolicy
        if compile_cache is not None and compile_cache is not False:
            raise NotImplementedError(
                "compile_cache: the port has no compile plane yet (ROADMAP "
                "A12); pass None or False")
        self.trials = trials
        self.model_builder = model_builder
        self.data = data
        self.validation_data = validation_data
        self.metric = metric
        self.metric_mode = metric_mode
        self.max_t = int(max_t)
        self.stop_score = stop_score
        self.max_trial_retries = int(max_trial_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        # trial retry backoff rides the shared resilience RetryPolicy (the
        # same exponential schedule the old hand-rolled 2**n loop computed;
        # jitter 0 keeps study replays deterministic). The runtime drives
        # the schedule itself — delay_for(attempt) — because a failed trial
        # is re-queued, not re-invoked in place.
        self.retry_policy = retry_policy if retry_policy is not None else \
            RetryPolicy(max_attempts=self.max_trial_retries + 1,
                        base_delay_s=self.retry_backoff_s,
                        max_delay_s=300.0, jitter_frac=0.0,
                        name="trial.retry")
        self.logs_dir = logs_dir
        self.name = name
        self.on_trial_done = on_trial_done
        self.bracket = AshaBracket(self.max_t, eta=eta,
                                   grace_period=grace_period,
                                   metric_mode=metric_mode)
        self.leases = DeviceLeaseManager(devices)
        self.workers = max(1, min(max_concurrent or len(self.leases),
                                  len(self.leases)))
        self._ev = EventLog(logs_dir)
        self._lock = threading.Lock()
        self._halt = threading.Event()
        self._halt_reason: Optional[str] = None
        self._states: Dict[int, Any] = {}      # RAM checkpoints (fallback)
        self._ckpt_plane = None                # lazy (see ckpt_plane)
        self._study_fp_cache: Optional[str] = None
        self._rec: Dict[int, Dict[str, Any]] = {
            t.trial_id: {"status": "pending", "epochs_done": 0,
                         "epochs_spent": 0, "rung": -1, "rung_scores": {},
                         "promoted_through": -1, "retries": 0, "runnable": True,
                         "ckpt": None, "slices": [], "error": None}
            for t in trials}
        self._counters = {"late_promotions": 0, "forced_promotions": 0,
                          "retries": 0, "preempted_slices": 0}
        self._wall_s = 0.0
        self._status = "created"

    # --- checkpoint plumbing ------------------------------------------------
    @property
    def ckpt_plane(self):
        """The study's checkpoint plane (the port's ``ckpt``), rooted at
        ``logs_dir/trial_ckpts``. Every trial checkpoints into ONE shared
        content-addressed blob store, so a rung of trials sharing leaves
        (frozen embeddings, identical init) writes them once; per-trial
        retention keeps the last 2 committed checkpoints (the newest plus
        a fallback past a checksum mismatch). None without a logs_dir."""
        if not self.logs_dir:
            return None
        if self._ckpt_plane is None:
            from ...ckpt import CheckpointPlane
            self._ckpt_plane = CheckpointPlane(
                os.path.join(self.logs_dir, "trial_ckpts"),
                keep_last_k=2, async_save=True, max_inflight=2)
        return self._ckpt_plane

    def _trial_ckpt_name(self, trial_id) -> str:
        """Per-trial checkpoint namespace, scoped by the STUDY fingerprint:
        logs_dir is commonly reused across studies (fixed /tmp defaults),
        and without the scope a stale study's higher-step checkpoints
        would shadow this study's in per-name retention. Blobs stay shared
        across studies — dedup is content-addressed, not name-addressed."""
        if self._study_fp_cache is None:
            self._study_fp_cache = self._fingerprint()[:10]
        return f"study-{self._study_fp_cache}/trial_{trial_id}"

    def _save_state(self, trial_id, state,
                    stash_on_fail: bool = True) -> Optional[str]:
        """Durable checkpoint through the plane when possible; RAM
        otherwise (some model states — live estimator objects — don't
        pickle). Disk success frees the RAM copy, so paused trials don't
        accumulate host memory. The plane's save is async (blob hashing +
        IO drain on its writer thread) and atomic — a crash mid-write
        leaves the previous committed checkpoint as the resume point.
        ``stash_on_fail=False`` makes the disk write purely best-effort
        (used for completed trials, whose state already lives on the
        Trial)."""
        if state is None:
            return None
        plane = self.ckpt_plane
        if plane is not None:
            try:
                # the skeleton pickle runs synchronously inside save(), so
                # unpicklable states fail HERE and fall back to RAM. The
                # RAM copy is stashed FIRST and released only from the
                # writer's on_done callback — an async IO failure (disk
                # full, permission) must leave the state recoverable, like
                # the old inline-pickle path did
                rec = self._rec[trial_id]
                if stash_on_fail:
                    with self._lock:
                        self._states[trial_id] = state

                def _written(err, tid=trial_id, st=state,
                             keep=stash_on_fail):
                    if err is None:
                        with self._lock:
                            # a newer stash may have replaced ours — only
                            # release the exact state this save made durable
                            if self._states.get(tid) is st:
                                self._states.pop(tid, None)
                    elif keep:
                        logger.warning(
                            "trial %s checkpoint write failed (%s); "
                            "keeping the state in memory", tid, err)

                return plane.save(state, rec["epochs_done"],
                                  name=self._trial_ckpt_name(trial_id),
                                  on_done=_written)
            except Exception as e:     # noqa: BLE001 — fall back to RAM
                if stash_on_fail:
                    logger.warning("trial %s checkpoint not picklable (%s); "
                                   "keeping it in memory", trial_id, e)
        if stash_on_fail:
            self._states[trial_id] = state
        return None

    def _load_state(self, trial_id):
        state = self._states.get(trial_id)
        if state is not None:
            return state
        path = self._rec[trial_id]["ckpt"]
        if not path:
            return None
        try:
            # checkpoint-plane dir (manifest + blobs): load EXACTLY the
            # recorded dir, digest-verified, after flushing pending writes.
            # Never "newest step under this trial's name" — logs_dir is
            # commonly reused across studies (the AutoEstimator default is
            # a fixed /tmp path), and a stale higher-step checkpoint from a
            # previous study would masquerade as this trial's future,
            # silently skipping its remaining training. Any other recorded
            # path is unreadable: the trial restarts from scratch.
            if self._ckpt_plane is not None:
                self._ckpt_plane.flush()
            from ...ckpt import load_checkpoint_dir
            return load_checkpoint_dir(path)
        except Exception as e:          # noqa: BLE001
            logger.warning("trial %s checkpoint unreadable (%s); "
                           "restarting from scratch", trial_id, e)
        return None

    # --- study manifest -----------------------------------------------------
    def _fingerprint(self) -> str:
        payload = [self.name, self.max_t, self.bracket.eta,
                   self.bracket.rungs, self.metric, self.metric_mode,
                   [_jsonable(t.config) for t in self.trials]]
        return hashlib.sha1(json.dumps(
            payload, sort_keys=True, default=repr).encode()).hexdigest()

    def _manifest_path(self) -> Optional[str]:
        return (os.path.join(self.logs_dir, MANIFEST_NAME)
                if self.logs_dir else None)

    def _save_manifest(self, status: str):
        path = self._manifest_path()
        if path is None:
            return
        with self._lock:
            doc = {"name": self.name, "status": status,
                   "fingerprint": self._fingerprint(),
                   "updated": round(time.time(), 3),
                   "max_t": self.max_t, "eta": self.bracket.eta,
                   "rungs": self.bracket.rungs, "metric": self.metric,
                   "metric_mode": self.metric_mode,
                   "trials": [self._trial_doc(t) for t in self.trials]}
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)

    def _trial_doc(self, trial) -> Dict[str, Any]:
        rec = self._rec[trial.trial_id]
        return {"id": trial.trial_id, "config": _jsonable(trial.config),
                "status": rec["status"], "epochs_done": rec["epochs_done"],
                "epochs_spent": rec["epochs_spent"], "rung": rec["rung"],
                "rung_scores": {str(k): v
                                for k, v in rec["rung_scores"].items()},
                "promoted_through": rec["promoted_through"],
                "runnable": rec["runnable"], "retries": rec["retries"],
                "score": trial.metric_value, "metrics": _jsonable(trial.metrics),
                "ckpt": rec["ckpt"], "error": rec["error"],
                "duration_s": round(trial.duration_s, 3)}

    def _try_adopt_manifest(self, resume) -> bool:
        """Adopt a prior study's manifest when resuming. ``resume`` is
        ``"auto"`` (adopt an *incomplete* matching study), ``True`` (adopt
        any matching study) or ``False`` (always start fresh)."""
        path = self._manifest_path()
        if not resume or path is None or not os.path.exists(path):
            return False
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
        except Exception:               # noqa: BLE001 — corrupt manifest
            logger.warning("unreadable study manifest %s; starting fresh",
                           path)
            return False
        if doc.get("fingerprint") != self._fingerprint():
            logger.info("study manifest %s belongs to a different study; "
                        "starting fresh", path)
            return False
        if resume == "auto" and doc.get("status") == "completed":
            return False                # finished study re-run = new study
        by_id = {t["id"]: t for t in doc.get("trials", [])}
        for trial in self.trials:
            entry = by_id.get(trial.trial_id)
            if entry is None:
                continue
            rec = self._rec[trial.trial_id]
            rec.update({k: entry[k] for k in
                        ("status", "epochs_done", "epochs_spent", "rung",
                         "promoted_through", "runnable", "retries", "ckpt",
                         "error") if k in entry})
            rec["rung_scores"] = {int(k): float(v) for k, v in
                                  entry.get("rung_scores", {}).items()}
            if rec["status"] == "running":
                # a hard crash (kill -9 / OOM) snapshots in-flight slices as
                # "running"; re-queue them from their last checkpoint so the
                # resumed study accounts for every trial
                rec["status"] = "paused" if rec["epochs_done"] else "pending"
                rec["runnable"] = True
            trial.rung = rec["rung"]
            trial.epochs_trained = rec["epochs_spent"]
            trial.retries = rec["retries"]
            trial.duration_s = entry.get("duration_s", 0.0)
            if rec["status"] == "done":
                trial.state = "done"
                trial.metric_value = entry.get("score")
                trial.metrics = entry.get("metrics") or {}
            elif rec["status"] == "error":
                trial.state = "error"
                trial.error = rec["error"]
            else:
                trial.state = "pending"
            if rec["rung_scores"]:
                self.bracket.adopt(trial.trial_id, rec["rung_scores"],
                                   promoted_through=rec["promoted_through"])
            if rec["status"] == "error":
                self.bracket.retire(trial.trial_id)
        self._ev.emit("study_resume", name=self.name,
                      adopted=len(by_id), manifest=path)
        return True

    # --- decisions ----------------------------------------------------------
    def _on_decision(self, trial, rung: int, score: float, decision: str):
        rec = self._rec[trial.trial_id]
        with self._lock:
            rec["rung_scores"][rung] = score
            rec["rung"] = rung
            trial.rung = rung
            if decision == "promote":
                rec["promoted_through"] = rung
        self._ev.emit(decision if decision != "stop" else "final_rung",
                      trial=trial.trial_id, rung=rung, metric=score)

    def _reached_stop_score(self, trial) -> bool:
        if self.stop_score is None or trial.metric_value is None:
            return False
        if self.metric_mode == "min":
            return trial.metric_value <= self.stop_score
        return trial.metric_value >= self.stop_score

    def _halt_study(self, reason: str):
        if not self._halt.is_set():
            self._halt_reason = reason
            self._halt.set()
            self._ev.emit("study_halt", reason=reason)

    # --- one scheduling slice (runs on a worker thread) ---------------------
    def _run_slice(self, trial) -> Dict[str, Any]:
        # per-trial trace id (obs plane): every study event emitted on this
        # worker thread — trial_start, reports, pause/retry, trial_done —
        # is stamped with it in study_events.jsonl (EventLog.emit), and the
        # trial's fit/infeed/ckpt spans all chain under it
        with _trace.span("trial", trial=trial.trial_id):
            return self._run_slice_traced(trial)

    def _run_slice_traced(self, trial) -> Dict[str, Any]:
        rec = self._rec[trial.trial_id]
        t0 = time.perf_counter()
        start_done = rec["epochs_done"]
        ctx = TrialContext(self, trial, epochs_done=start_done)
        lease = self.leases.acquire(owner=trial.trial_id)
        outcome: Dict[str, Any] = {"trial": trial, "ctx": ctx}
        try:
            # everything after acquire lives inside the try: an exception
            # anywhere (even the event-log write) must still release the
            # device
            trial.device = str(lease.device)
            trial.state = "running"
            rec["status"] = "running"
            self._ev.emit(
                "trial_start" if start_done == 0 else "trial_resume",
                trial=trial.trial_id, chip=lease.index,
                epochs_done=start_done)
            with current_device(lease.device):
                score, metrics, state = self._train_slice(
                    trial, ctx, lease.device, start_done)
            outcome.update(kind="done", score=float(score), metrics=metrics,
                           state=state)
        except TrialPaused as p:
            self._account_remainder(rec, ctx)
            outcome.update(kind="paused", rung=p.rung,
                           checkpoint=ctx.checkpoint)
        except TrialPreempted:
            self._account_remainder(rec, ctx)
            outcome.update(kind="preempted", checkpoint=ctx.checkpoint)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:          # noqa: BLE001 — retried by the loop
            self._account_remainder(rec, ctx)
            outcome.update(kind="failed", exc=e,
                           tb=traceback.format_exc(),
                           checkpoint=ctx.checkpoint)
        finally:
            lease.release()
            dt = time.perf_counter() - t0
            trial.duration_s += dt
            with self._lock:
                rec["slices"].append(
                    {"chip": lease.index, "start_epochs": start_done,
                     "end_epochs": ctx.epochs_done, "kind":
                     outcome.get("kind", "?"), "duration_s": round(dt, 3)})
        return outcome

    def _train_slice(self, trial, ctx: TrialContext, device,
                     start_done: int):
        """One slice of a trial's training on its leased device; the CUDA
        graphs its fits captured go when it returns, so concurrent trials
        each hold only their own and a long study accumulates none."""
        with _graphs.released_on_exit():
            return self._fit_slice(trial, ctx, device, start_done)

    def _fit_slice(self, trial, ctx: TrialContext, device, start_done: int):
        rec = self._rec[trial.trial_id]
        model = self.model_builder(trial.config, device)
        caps = _fit_eval_caps(model.fit_eval)
        state_in = self._load_state(trial.trial_id) if start_done else None
        if caps["state"] is False and state_in is not None:
            state_in = None         # legacy builder: re-trains from scratch
        if not caps["trial_context"]:
            return self._drive_rungs(trial, ctx, model, caps, state_in)
        kwargs: Dict[str, Any] = {"trial_context": ctx}
        if caps["state"]:
            kwargs["state"] = state_in
        score, metrics, state = model.fit_eval(
            self.data, self.validation_data, epochs=self.max_t,
            metric=self.metric, **kwargs)
        spent = (ctx.epochs_done - start_done if caps["state"]
                 else ctx.epochs_done)
        self._account(rec, spent, ctx.epochs_done)
        return score, metrics, state


    def _account(self, rec, spent: int, epochs_done: int):
        with self._lock:
            rec["epochs_spent"] += max(int(spent), 0)
            rec["epochs_done"] = int(epochs_done)

    def _account_remainder(self, rec, ctx: TrialContext):
        """Account only progress not yet recorded for this slice. The
        _drive_rungs path accounts segment-by-segment as it goes (so
        rec['epochs_done'] already equals ctx.epochs_done when an exception
        escapes it); the trial_context path accounts nothing until the
        slice ends. Charging ctx-vs-rec delta covers both without double
        counting."""
        self._account(rec, ctx.epochs_done - rec["epochs_done"],
                      ctx.epochs_done)

    def _drive_rungs(self, trial, ctx: TrialContext, model, caps, state):
        """Rung loop for fit_eval implementations without trial_context
        support: call them once per rung with a cumulative epoch budget.
        With ``state`` support each call continues training; without it the
        model re-trains from scratch to each budget (still cheaper than the
        exhaustive path for pruned trials)."""
        rec = self._rec[trial.trial_id]
        score = metrics = None
        while True:
            ctx.heartbeat()
            boundary = self.bracket.next_boundary(ctx.epochs_done)
            if boundary is None:
                break
            kwargs = {"state": state} if caps["state"] else {}
            score, metrics, state = model.fit_eval(
                self.data, self.validation_data, epochs=boundary,
                metric=self.metric, **kwargs)
            spent = (boundary - ctx.epochs_done
                     if caps["state"] or ctx.epochs_done == 0 else boundary)
            self._account(rec, spent, boundary)
            ctx.set_state_fn(lambda s=state: s)
            if ctx.report(boundary, float(score)) == "stop":
                break
        if score is None:
            # resumed exactly at max_t (e.g. preempted after the last
            # segment): one evaluation-only call for the final score
            kwargs = {"state": state} if caps["state"] else {}
            score, metrics, state = model.fit_eval(
                self.data, self.validation_data, epochs=self.max_t,
                metric=self.metric, **kwargs)
        return score, metrics, state

    # --- outcome handling (main thread) -------------------------------------
    def _finish_trial(self, outcome):
        trial = outcome["trial"]
        rec = self._rec[trial.trial_id]
        kind = outcome["kind"]
        if kind == "done":
            trial.state = "done"
            trial.metric_value = outcome["score"]
            trial.metrics = outcome["metrics"] or {}
            trial.model_state = outcome["state"]
            trial.epochs_trained = rec["epochs_spent"]
            rec["status"] = "done"
            rec["runnable"] = False
            rec["ckpt"] = self._save_state(trial.trial_id, outcome["state"],
                                           stash_on_fail=False) or rec["ckpt"]
            self._states.pop(trial.trial_id, None)
            self._ev.emit("trial_done", trial=trial.trial_id,
                          metric=trial.metric_value,
                          epochs_spent=rec["epochs_spent"])
            if self.on_trial_done is not None:
                self.on_trial_done(trial)
            if self._reached_stop_score(trial):
                self._halt_study("stop_score")
            return None
        if kind in ("paused", "preempted"):
            trial.state = "paused"
            trial.epochs_trained = rec["epochs_spent"]
            rec["status"] = "paused"
            rec["runnable"] = kind == "preempted"
            rec["ckpt"] = self._save_state(
                trial.trial_id, outcome.get("checkpoint")) or rec["ckpt"]
            if kind == "preempted":
                self._counters["preempted_slices"] += 1
            self._ev.emit("trial_" + kind, trial=trial.trial_id,
                          epochs_done=rec["epochs_done"])
            return None
        # failed: transient until retries are exhausted
        exc, tb = outcome["exc"], outcome["tb"]
        if outcome.get("checkpoint") is not None:
            rec["ckpt"] = self._save_state(
                trial.trial_id, outcome["checkpoint"]) or rec["ckpt"]
        if self._halt.is_set() and rec["retries"] < self.max_trial_retries:
            # study is halting: park the trial runnable WITHOUT consuming a
            # retry — the resumed study gives it a live retry-with-backoff
            # from its last checkpoint (repeated preempt+fail cycles must
            # not drain the budget without a single real retry)
            rec["status"] = "paused"
            rec["runnable"] = True
            trial.state = "paused"
            self._ev.emit("trial_retry_deferred", trial=trial.trial_id,
                          retries_used=rec["retries"], error=repr(exc))
            return None
        rec["retries"] += 1
        trial.retries = rec["retries"]
        if rec["retries"] <= self.max_trial_retries:
            backoff = self.retry_policy.delay_for(rec["retries"])
            self._counters["retries"] += 1
            self._ev.emit("trial_retry", trial=trial.trial_id,
                          attempt=rec["retries"], backoff_s=backoff,
                          error=repr(exc))
            logger.warning("trial %s failed (%s); retry %d/%d in %.1fs",
                           trial.trial_id, exc, rec["retries"],
                           self.max_trial_retries, backoff)
            rec["status"] = "pending"
            trial.state = "pending"
            return backoff
        trial.state = "error"
        trial.error = f"{exc}\n{tb}"
        rec["status"] = "error"
        rec["error"] = repr(exc)
        rec["runnable"] = False
        self.bracket.retire(trial.trial_id)
        self._ev.emit("trial_error", trial=trial.trial_id, error=repr(exc))
        logger.warning("trial %s failed permanently after %d retries: %s",
                       trial.trial_id, rec["retries"] - 1, exc)
        return None

    # --- main loop ----------------------------------------------------------
    def run(self, resume="auto") -> List:
        t_start = time.perf_counter()
        adopted = self._try_adopt_manifest(resume)
        self._status = "running"
        self._ev.emit("study_start", name=self.name, trials=len(self.trials),
                      max_t=self.max_t, rungs=self.bracket.rungs,
                      chips=len(self.leases), workers=self.workers,
                      resumed=adopted)
        queue: deque = deque()
        delayed: List = []              # (ready_time, seq, trial)
        seq = 0
        for trial in self.trials:
            rec = self._rec[trial.trial_id]
            if rec["status"] == "pending" or (rec["status"] == "paused"
                                              and rec["runnable"]):
                queue.append(trial)
        self._run_pool(queue, delayed, seq)
        self._finalize()
        if self._ckpt_plane is not None:
            # the manifest below records ckpt paths as durable facts; every
            # queued trial checkpoint must be committed before it says so
            # (this is also the SIGTERM grace-window flush: run() unwinds
            # here on a preemption halt)
            self._ckpt_plane.flush()
        self._wall_s = time.perf_counter() - t_start
        self._save_manifest(self._status)
        self._ev.emit("study_" + self._status, name=self.name,
                      wall_s=round(self._wall_s, 3))
        return self.trials

    def _run_pool(self, queue: deque, delayed: List, seq: int):
        from ...orca.learn.preemption import PreemptionWatcher

        with PreemptionWatcher() as watcher, \
                ThreadPoolExecutor(max_workers=self.workers,
                                   thread_name_prefix="trial") as pool:
            inflight: Dict = {}
            while True:
                if watcher.triggered:
                    self._halt_study("preempted")
                now = time.monotonic()
                while delayed and delayed[0][0] <= now:
                    queue.append(heapq.heappop(delayed)[2])
                while (queue and len(inflight) < self.workers
                       and not self._halt.is_set()):
                    trial = queue.popleft()
                    inflight[pool.submit(self._run_slice, trial)] = trial
                # late/forced promotions only when a worker is free, and only
                # for trials whose pause outcome has been processed on this
                # thread (status "paused", not mid-flight): the bracket
                # learns of a pause before the pausing slice has saved its
                # checkpoint or released its device
                if (not queue and len(inflight) < self.workers
                        and not self._halt.is_set()):
                    settled = {t.trial_id for t in self.trials
                               if self._rec[t.trial_id]["status"] == "paused"}
                    promo = self.bracket.promotable(settled)
                    if promo is None and not inflight and not delayed \
                            and not self._completed_exists():
                        promo = self._force_promote()
                    if promo is not None:
                        tid, rung = promo
                        rec = self._rec[tid]
                        rec["promoted_through"] = max(
                            rec["promoted_through"], rung)
                        self._counters["late_promotions"] += 1
                        trial = self._trial_by_id(tid)
                        self._ev.emit("promote", trial=tid, rung=rung,
                                      late=True)
                        inflight[pool.submit(self._run_slice, trial)] = trial
                        continue
                if not inflight:
                    if self._halt.is_set() or (not queue and not delayed):
                        break
                    if delayed:         # only backoff timers left
                        time.sleep(min(0.05, max(0.0,
                                                 delayed[0][0] - now)))
                    continue
                done, _ = wait(list(inflight), timeout=0.25,
                               return_when=FIRST_COMPLETED)
                for fut in done:
                    trial = inflight.pop(fut)
                    backoff = self._finish_trial(fut.result())
                    if backoff is not None:
                        seq += 1
                        heapq.heappush(
                            delayed, (time.monotonic() + backoff, seq, trial))
                    self._save_manifest("running")

    def _trial_by_id(self, tid):
        for t in self.trials:
            if t.trial_id == tid:
                return t
        raise KeyError(tid)

    def _completed_exists(self) -> bool:
        return any(self._rec[t.trial_id]["status"] == "done"
                   for t in self.trials)

    def _force_promote(self):
        """Small-study guard: with fewer than ``eta`` trials at a rung the
        top-1/eta set is empty and pure ASHA would pause everything forever.
        When the study would otherwise end with NO fully-trained trial,
        promote the best paused one so ``get_best_trial`` always reflects a
        max_t-budget winner."""
        best = None
        for trial in self.trials:
            rec = self._rec[trial.trial_id]
            if rec["status"] != "paused" or rec["rung"] < 0:
                continue
            score = rec["rung_scores"].get(rec["rung"])
            if score is None:
                continue
            if best is None or (score < best[1] if self.metric_mode == "min"
                                else score > best[1]):
                best = (trial.trial_id, score, rec["rung"])
        if best is None:
            return None
        tid, _, rung = best
        self.bracket.force_promote(tid, rung)
        self._counters["forced_promotions"] += 1
        return tid, rung

    def _finalize(self):
        if self._halt.is_set():
            self._status = ("preempted" if self._halt_reason == "preempted"
                            else "stopped")
            return
        self._status = "completed"
        # a trial still paused when the study completes was pruned: its last
        # rung score is its result (matching how Ray Tune's ASHA reports
        # early-stopped trials), with epochs_trained recording how little
        # budget it actually consumed
        pruned = [t for t in self.trials
                  if self._rec[t.trial_id]["status"] == "paused"]
        # best-first so checkpoint loading can stop early: once the
        # retention callback drops a loaded state, every worse trial's
        # would be dropped too — don't unpickle n_pruned full parameter
        # trees just to discard all but the top-k
        pruned.sort(key=lambda t: self._rec[t.trial_id]["rung_scores"].get(
            self._rec[t.trial_id]["rung"], float("inf")),
            reverse=self.metric_mode == "max")
        stop_loading = False
        for trial in pruned:
            rec = self._rec[trial.trial_id]
            score = rec["rung_scores"].get(rec["rung"])
            trial.state = "done"
            trial.metric_value = score
            trial.metrics = dict(trial.metrics or {})
            trial.metrics.setdefault(self.metric, score)
            trial.epochs_trained = rec["epochs_spent"]
            # surface the checkpointed weights: a pruned trial can still win
            # get_best_trial() on a noisy metric, and get_best_model()/
            # TSPipeline need its state
            loaded = None
            if not stop_loading:
                loaded = self._load_state(trial.trial_id)
                trial.model_state = loaded
            rec["status"] = "done"
            self._ev.emit("trial_pruned", trial=trial.trial_id,
                          rung=rec["rung"], metric=score)
            if self.on_trial_done is not None:
                self.on_trial_done(trial)
                if loaded is not None and trial.model_state is None:
                    stop_loading = True

    # --- telemetry ----------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        by_status: Dict[str, int] = {}
        spent = 0
        per_trial = []
        with self._lock:
            for trial in self.trials:
                rec = self._rec[trial.trial_id]
                by_status[rec["status"]] = by_status.get(rec["status"], 0) + 1
                spent += rec["epochs_spent"]
                per_trial.append(
                    {"id": trial.trial_id, "status": rec["status"],
                     "epochs_done": rec["epochs_done"],
                     "epochs_spent": rec["epochs_spent"],
                     "rung": rec["rung"], "retries": rec["retries"],
                     "score": trial.metric_value,
                     "duration_s": round(trial.duration_s, 3),
                     "slices": list(rec["slices"])})
        exhaustive = len(self.trials) * self.max_t
        from ...resilience.stats import resilience_snapshot
        return {"study": self.name, "status": self._status,
                "resilience": resilience_snapshot(),
                "compile": {},
                "ckpt": (self._ckpt_plane.stats.snapshot()
                         if self._ckpt_plane is not None else {}),
                "wall_s": round(self._wall_s, 3),
                "max_t": self.max_t, "eta": self.bracket.eta,
                "rungs": self.bracket.snapshot(),
                "trials": {"total": len(self.trials), **by_status},
                "counters": {"promotions": self.bracket.promotions,
                             "pauses": self.bracket.pauses,
                             **self._counters},
                "epochs": {"trained": spent, "exhaustive": exhaustive,
                           "saved_frac": round(1 - spent / exhaustive, 4)
                           if exhaustive else 0.0},
                "chips": self.leases.utilization(),
                "events": dict(self._ev.counts)}
