"""Training supervisor — checkpoint-backed automatic recovery for fit()
(counterpart of ``analytics_zoo_tpu/resilience/supervisor.py``).

Checkpoints are async, atomic and nearly free; this is the layer that
*uses* them. The supervisor drives a training run as per-epoch segments
of ``TPUEstimator.fit`` (``fit(epochs=1, initial_epoch=i)`` re-aligns
the shuffle seed, the step counter rides the checkpoint, so N segments
== one uninterrupted N-epoch fit, bit for bit wherever the steps are
deterministic). Around each segment it arms:

* a :class:`~analytics_zoo_tpu_torch.resilience.watchdog.DispatchWatchdog`
  bounding every device dispatch and the host's waits on the card
  (``ZOO_DISPATCH_TIMEOUT_S``) — a wedged card becomes a classified
  *hang* instead of an eternal wait;
* a :class:`~analytics_zoo_tpu_torch.orca.learn.preemption.
  PreemptionWatcher` with the shared ``on_signal`` entry point, so
  SIGTERM checkpoints and returns a clean report.

On a hang, injected device loss, or unhandled step exception the
supervisor: flushes the checkpoint plane (queued ≠ durable is not
acceptable when the estimator is about to be torn down), shuts the
estimator down, rebuilds it from its factory, restores the newest
*committed* supervisor checkpoint (``ckpt.format.loadable_step_dirs``
candidacy — torn writes can never be the resume point), and resumes at
the recorded epoch boundary. The restart budget is bounded; exhausting
it raises :class:`SupervisorGiveUp` carrying a structured failure report
instead of a bare traceback soup.

One difference from the JAX supervisor, kept on purpose: JAX can drop
its cached backend in-process (``ZOO_SUPERVISOR_REINIT_BACKEND=1``) and
re-probe the device; CUDA cannot replace a context after a sticky error
(an illegal address, a device-side assert, a lost card): every later
call in the process fails. So a real CUDA error classified as device
loss is not restarted in-process: the supervisor gives up at once, its
report carrying ``process_restart_required`` and the error, and a new
process resumes from the last committed epoch. A device loss injected
through ``resilience/faults.py`` (an ``InjectedFault``) and a watchdog
hang restart in-process, as in JAX.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, Optional

from ..obs import trace as _trace
from . import watchdog as wd_mod
from .faults import InjectedFault
from .retry import RetryPolicy
from .stats import STATS
from .watchdog import DispatchTimeout, DispatchWatchdog, classify

logger = logging.getLogger("analytics_zoo_tpu_torch")

__all__ = ["TrainingSupervisor", "SupervisorGiveUp"]

#: messages of errors after which the process's CUDA context is unusable
_CUDA_LOSS_MARKERS = ("CUDA error", "cudaError",
                      "device-side assert", "illegal memory access",
                      "illegal address", "unspecified launch failure",
                      "uncorrectable ECC", "device lost",
                      "no CUDA-capable device")


class SupervisorGiveUp(RuntimeError):
    """Restart budget exhausted; ``.report`` is the structured failure
    report (attempt history, classifications, last checkpoint)."""

    def __init__(self, report: Dict[str, Any]):
        msg = (f"training supervisor gave up after "
               f"{report['restarts']} restart(s); last failure: "
               f"{report['failures'][-1]['error'] if report['failures'] else '?'}")
        if report.get("process_restart_required"):
            msg += ("; the card's CUDA context is lost, so the process "
                    "must restart and resume from the last committed "
                    f"checkpoint {report.get('last_checkpoint')}")
        super().__init__(msg)
        self.report = report


class TrainingSupervisor:
    """Wraps ``TPUEstimator.fit`` with watchdog + auto-recovery.

    Parameters
    ----------
    estimator_factory : zero-arg callable returning a *fresh*
        ``TPUEstimator`` (same module/optimizer/seed each time — recovery
        rebuilds the engine through it). A bare estimator instance is
        accepted for convenience; recovery then reuses it (fine for step
        failures, insufficient for a genuinely lost backend).
    model_dir : checkpoint root (defaults to the estimator's own).
    max_restarts : recovery budget across the whole fit.
    dispatch_timeout_s : per-dispatch hang bound (default
        ``ZOO_DISPATCH_TIMEOUT_S``; None = no hang detection).
    retry_policy : backoff between restarts (default: 1s base, x2,
        capped 30s, deterministic).
    """

    def __init__(self, estimator_factory, *, model_dir: Optional[str] = None,
                 max_restarts: int = 3,
                 dispatch_timeout_s: Optional[float] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 poll_s: float = 0.05):
        if callable(estimator_factory):
            self._factory = estimator_factory
        else:
            est = estimator_factory
            self._factory = lambda: est
        self.model_dir = model_dir
        self.max_restarts = int(max_restarts)
        self.dispatch_timeout_s = dispatch_timeout_s
        self.poll_s = float(poll_s)
        self.retry_policy = retry_policy if retry_policy is not None else \
            RetryPolicy(max_attempts=self.max_restarts + 1, base_delay_s=1.0,
                        max_delay_s=30.0, jitter_frac=0.0,
                        name="supervisor.restart")
        self.report: Optional[Dict[str, Any]] = None

    # --- resume bookkeeping -------------------------------------------------
    @staticmethod
    def _latest_supervised(model_dir: str):
        """Newest committed checkpoint carrying the supervisor's epoch
        meta, as (step, epoch) — fit-internal trigger checkpoints (no
        meta) coexist but never drive epoch accounting."""
        import os

        from ..ckpt import format as fmt
        if not model_dir or not os.path.isdir(model_dir):
            return None, 0
        for step, path in reversed(fmt.loadable_step_dirs(model_dir)):
            if not fmt.is_plane_dir(path):
                continue
            try:
                meta = fmt.read_manifest(path).get("meta") or {}
            except Exception:       # noqa: BLE001 — torn/foreign manifest
                continue
            if "supervisor_epoch" in meta:
                return step, int(meta["supervisor_epoch"])
        return None, 0

    def _resume(self, est) -> int:
        step, epoch = self._latest_supervised(self.model_dir)
        if step is None:
            return 0
        path = est.load_checkpoint(self.model_dir, step=step)
        logger.info("supervisor: resuming from %s (epoch %d, step %d)",
                    path, epoch, step)
        return epoch

    # --- one epoch segment --------------------------------------------------
    def _run_segment(self, est, data, epoch: int, batch_size: int,
                     fit_kwargs: Dict, wd: DispatchWatchdog) -> Dict:
        """Run fit(epochs=1, initial_epoch=epoch) on a worker thread while
        the main thread watches for a watchdog trip. Returns
        {"stats": [...]} on success or {"error": exc, "kind": hang|crash};
        on a hang the worker thread is abandoned (the stuck dispatch holds
        it — recovery rebuilds the estimator, so its late writes land on a
        discarded engine)."""
        box: Dict[str, Any] = {}
        # trace handoff: the segment runs on a worker thread; adopting the
        # supervisor's token keeps fit's spans on the supervised trace
        tok = _trace.token()

        def target():
            try:
                with _trace.adopt(tok):
                    box["stats"] = est.fit(
                        data, epochs=1, batch_size=batch_size,
                        initial_epoch=epoch, max_failure_retries=0,
                        verbose=False, **fit_kwargs)
            except BaseException as e:      # noqa: BLE001 — classified
                box["error"] = e

        t = threading.Thread(target=target, daemon=True,
                             name=f"zoo-supervised-fit-ep{epoch}")
        t.start()
        while t.is_alive():
            t.join(self.poll_s)
            if wd.tripped.is_set() and t.is_alive():
                label, elapsed = wd.trips[-1] if wd.trips else ("?", 0.0)
                return {"error": DispatchTimeout(
                    label, elapsed, wd.timeout_s or 0.0), "kind": "hang"}
        if "error" in box:
            return {"error": box["error"], "kind": classify(box["error"])}
        return {"stats": box.get("stats") or []}

    # --- recovery -----------------------------------------------------------
    @staticmethod
    def _needs_process_restart(exc: BaseException) -> bool:
        """A real device loss (not a hang, not an injected fault) on the
        card: the CUDA context is gone for this process."""
        import torch
        if isinstance(exc, (DispatchTimeout, InjectedFault)):
            return False
        # torch >= 2.8 raises AcceleratorError for CUDA errors
        accel_error = getattr(torch, "AcceleratorError", ())
        return (isinstance(exc, accel_error)
                or any(m in str(exc) for m in _CUDA_LOSS_MARKERS))

    def _teardown(self, est, err: BaseException):
        """Flush + shut down the failed estimator (no backend re-init: see
        the module docstring)."""
        try:
            est.flush_checkpoints(timeout=30)
        except Exception:           # noqa: BLE001 — flush is best-effort here
            logger.exception("supervisor: checkpoint flush failed during "
                             "teardown")
        try:
            est.shutdown()
        except Exception:           # noqa: BLE001
            logger.exception("supervisor: estimator shutdown failed")

    # --- public -------------------------------------------------------------
    def fit(self, data, epochs: int = 1, batch_size: int = 32,
            **fit_kwargs) -> Dict[str, Any]:
        """Supervised training run. Returns a report::

            {"epoch_stats": [...], "completed": bool, "preempted": bool,
             "restarts": n, "hangs": n, "crashes": n,
             "downtime_s": s, "steps_replayed": n, "failures": [...]}

        Raises :class:`SupervisorGiveUp` (report attached) when the
        restart budget is exhausted."""
        from ..orca.learn.preemption import PreemptionWatcher

        est = self._factory()
        model_dir = self.model_dir or est.model_dir
        if model_dir is None:
            raise ValueError("TrainingSupervisor needs a model_dir "
                             "(supervisor arg or estimator model_dir)")
        self.model_dir = model_dir
        wd = DispatchWatchdog(timeout_s=self.dispatch_timeout_s)
        prev_wd = wd_mod.active()
        wd_mod.set_active(wd)
        report: Dict[str, Any] = {
            "epoch_stats": [], "completed": False, "preempted": False,
            "restarts": 0, "hangs": 0, "crashes": 0, "downtime_s": 0.0,
            "steps_replayed": 0, "failures": []}
        self.report = report
        preempted = threading.Event()
        watcher = PreemptionWatcher(
            on_signal=lambda signum: preempted.set())
        self.estimator = est
        try:
            with watcher, _trace.span("supervisor.fit", epochs=epochs):
                epoch = self._resume(est)
                while epoch < epochs:
                    wd.reset()
                    outcome = self._run_segment(est, data, epoch, batch_size,
                                                fit_kwargs, wd)
                    if "error" not in outcome:
                        report["epoch_stats"].extend(outcome["stats"])
                        est.save_checkpoint(
                            model_dir,
                            meta={"supervisor_epoch": epoch + 1})
                        epoch += 1
                        if (preempted.is_set() or watcher.triggered) and \
                                epoch < epochs:
                            # SIGTERM grace window: make the boundary
                            # checkpoint durable and return cleanly — the
                            # next supervised run resumes at this epoch
                            est.flush_checkpoints()
                            report["preempted"] = True
                            logger.warning(
                                "supervisor: preemption notice — stopping "
                                "after epoch %d (checkpoint committed)",
                                epoch)
                            break
                        continue
                    err, kind = outcome["error"], outcome["kind"]
                    failed_step = getattr(
                        getattr(est, "engine", None), "step", 0)
                    # restart span annotated with the classified fault
                    # kind (hang|crash) + cause: teardown → rebuild →
                    # backoff → restore, all one segment on the timeline
                    with _trace.span("supervisor.restart", kind=kind,
                                     step=int(failed_step),
                                     cause=type(err).__name__):
                        self._teardown(est, err)
                        if self._needs_process_restart(err):
                            self._give_up_lost_device(err, kind,
                                                      failed_step, report)
                        est = self._factory()
                        epoch = self._recover(est, err, kind, failed_step,
                                              report)
                self.estimator = est
                report["completed"] = not report["preempted"] and \
                    epoch >= epochs
                if report["completed"] or report["preempted"]:
                    est.flush_checkpoints()
                return report
        finally:
            if prev_wd is not None:
                wd_mod.set_active(prev_wd)
            else:
                wd_mod.clear_active()
            wd.close()

    def _give_up_lost_device(self, err: BaseException, kind: str,
                             failed_step: int, report: Dict[str, Any]):
        """A real CUDA device loss: record it and raise
        :class:`SupervisorGiveUp` naming it; no in-process restart."""
        report["failures"].append(
            {"kind": kind, "error": f"{type(err).__name__}: {err}",
             "step": int(failed_step), "time": time.time(),
             "device_loss": True})
        step, ep = self._latest_supervised(self.model_dir)
        report["last_checkpoint"] = {"step": step, "epoch": ep}
        report["process_restart_required"] = True
        STATS.add("supervisor.device_loss")
        logger.error(
            "supervisor: device loss at step %s (%s: %s); the CUDA context "
            "cannot be replaced in-process — restart the process to resume "
            "from epoch %d", failed_step, type(err).__name__, err, ep)
        raise SupervisorGiveUp(report) from err

    def _recover(self, est, err: BaseException, kind: str,
                 failed_step: int, report: Dict[str, Any]) -> int:
        """Bookkeep one failure, enforce the restart budget, back off, and
        restore the fresh estimator to the last supervised epoch boundary.
        Returns the epoch to resume at."""
        t0 = time.perf_counter()
        report["restarts"] += 1
        plural = "hangs" if kind == "hang" else "crashes"
        report[plural] = report.get(plural, 0) + 1
        STATS.add("supervisor.restarts")
        STATS.add(f"supervisor.{plural}")
        report["failures"].append(
            {"kind": kind, "error": f"{type(err).__name__}: {err}",
             "step": int(failed_step), "time": time.time()})
        if report["restarts"] > self.max_restarts:
            report["downtime_s"] += time.perf_counter() - t0
            step, ep = self._latest_supervised(self.model_dir)
            report["last_checkpoint"] = {"step": step, "epoch": ep}
            logger.error(
                "supervisor: restart budget (%d) exhausted; escalating. "
                "failures: %s", self.max_restarts,
                [f["error"] for f in report["failures"]])
            raise SupervisorGiveUp(report) from err
        delay = self.retry_policy.delay_for(report["restarts"])
        logger.warning(
            "supervisor: %s at step %s (%s: %s); restart %d/%d in %.1fs",
            kind, failed_step, type(err).__name__, err,
            report["restarts"], self.max_restarts, delay)
        time.sleep(delay)
        epoch = self._resume(est)
        restored_step = getattr(est.engine, "step", 0)
        report["steps_replayed"] += max(
            0, int(failed_step) - int(restored_step))
        report["downtime_s"] += time.perf_counter() - t0
        return epoch
