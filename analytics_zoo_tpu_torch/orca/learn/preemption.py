"""Preemption watcher — checkpoint-and-stop on SIGTERM (a copy of
``analytics_zoo_tpu/orca/learn/preemption.py``).

SURVEY §5 names preemption handling as the piece the reference never
needed (Spark rescheduled its executors) but a cloud deployment does:
preemptible/spot accelerator VMs receive SIGTERM with a short grace
window before the host dies. The watcher turns that signal into a clean
save-checkpoint-and-return from ``fit`` instead of a killed process,
so the next run resumes from ``load_checkpoint`` at the step the
preemption hit rather than the last periodic trigger.

Used by ``TPUEstimator.fit`` automatically when a ``model_dir`` +
checkpoint trigger/retry opt-in is active; usable standalone around any
loop:

    with PreemptionWatcher() as w:
        for step in range(n):
            train_step()
            if w.triggered:
                save(); break
"""

from __future__ import annotations

import logging
import signal
import threading

logger = logging.getLogger("analytics_zoo_tpu_torch")


class PreemptionWatcher:
    """Context manager that latches SIGTERM (and optionally SIGINT) into a
    flag instead of killing the process. The previous handler is chained
    on exit and re-raised delivery is NOT suppressed for a second signal —
    a repeated SIGTERM falls through to the prior handler so an operator
    can still force-stop."""

    def __init__(self, signals=(signal.SIGTERM,), on_signal=None):
        """``on_signal(signum)``: invoked from the handler on the FIRST
        signal, after the flag latches — the one SIGTERM entry point the
        training supervisor (checkpoint-and-stop) and the serving drain
        path (stop accepting, finish in-flight) share. Runs in signal
        context: keep it non-blocking (set an event, start a thread)."""
        self._signals = tuple(signals)
        self._on_signal = on_signal
        self._prev = {}
        self._event = threading.Event()
        self._installed = False

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def _handler(self, signum, frame):
        if self._event.is_set():
            # second signal: defer to the original handler (force stop)
            prev = self._prev.get(signum)
            if callable(prev):
                prev(signum, frame)
            else:
                signal.signal(signum, prev or signal.SIG_DFL)
                signal.raise_signal(signum)
            return
        logger.warning(
            "received signal %d (preemption notice): finishing the current "
            "step, checkpointing, and stopping", signum)
        self._event.set()
        if self._on_signal is not None:
            try:
                self._on_signal(signum)
            except Exception:   # noqa: BLE001 — a callback bug must not
                logger.exception(   # turn a clean preemption into a crash
                    "preemption on_signal callback failed")

    def __enter__(self) -> "PreemptionWatcher":
        if threading.current_thread() is not threading.main_thread():
            # signal handlers can only be installed from the main thread
            # (e.g. AutoML trials run estimators on worker threads) — run
            # unarmed; .triggered stays False
            return self
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        self._installed = True
        return self

    def __exit__(self, *exc):
        if self._installed:
            for s, prev in self._prev.items():
                signal.signal(s, prev)
            self._installed = False
        return False
