"""Dispatch watchdog — bound the waits a wedged device turns infinite
(a host-only copy of ``analytics_zoo_tpu/resilience/watchdog.py``).

A hung kernel or lost card does not raise: a launch returns at once and
the host's next read of a result (``.cpu()``, ``.item()``, a
synchronize) simply never returns, and at pod scale one wedged worker
stalls the whole job silently (the failure mode Horovod's timeline and
MLPerf pod runs both call out). The watchdog turns "never returns" into
a *classified, bounded* event:

* hot paths wrap their device waits in :meth:`DispatchWatchdog.enter` /
  :meth:`~DispatchWatchdog.exit` sections (the engine's train dispatch,
  and, since a torch launch returns before the card finishes, the
  estimator's host reads of losses and predictions through
  :func:`watched` — armed only when a watchdog is active, one global
  read otherwise);
* a monitor thread trips any section older than ``timeout_s``
  (``ZOO_DISPATCH_TIMEOUT_S``), records it, and notifies ``on_trip`` —
  the supervisor's signal to abandon the stuck thread and recover from
  the last committed checkpoint;
* :meth:`DispatchWatchdog.run` runs a callable on a worker thread with a
  deadline, raising :class:`DispatchTimeout` on expiry — hang vs crash is
  the exception class (``DispatchTimeout`` = hang, anything else = crash,
  see :func:`classify`).

The monitor cannot interrupt a thread stuck inside a C extension — no
Python mechanism can. What it *can* do is make the hang observable and
bounded so the layer above replaces the whole backend instead of waiting
forever; that is exactly how the training supervisor uses it.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .stats import STATS

logger = logging.getLogger("analytics_zoo_tpu_torch")

__all__ = ["DispatchTimeout", "DispatchWatchdog", "classify",
           "default_timeout_s", "set_active", "active", "clear_active",
           "watched"]

TIMEOUT_ENV = "ZOO_DISPATCH_TIMEOUT_S"


def default_timeout_s() -> Optional[float]:
    """``ZOO_DISPATCH_TIMEOUT_S`` (seconds), or None = unbounded."""
    env = os.environ.get(TIMEOUT_ENV, "").strip()
    return float(env) if env else None


class DispatchTimeout(RuntimeError):
    """A watched dispatch exceeded its bound — the *hang* classification
    (a crash keeps its original exception class)."""

    def __init__(self, label: str, elapsed_s: float, timeout_s: float):
        super().__init__(
            f"dispatch {label!r} exceeded {timeout_s:.1f}s "
            f"(waited {elapsed_s:.1f}s) — device hang suspected")
        self.label = label
        self.elapsed_s = elapsed_s
        self.timeout_s = timeout_s


def classify(exc: BaseException) -> str:
    """``hang`` (watchdog bound exceeded) vs ``crash`` (the step raised)."""
    return "hang" if isinstance(exc, DispatchTimeout) else "crash"


class DispatchWatchdog:
    """Monitor thread bounding named wait sections.

    ``timeout_s=None`` (and no ``ZOO_DISPATCH_TIMEOUT_S``) disables the
    monitor entirely — sections become free bookkeeping no-ops."""

    def __init__(self, timeout_s: Optional[float] = None,
                 poll_s: float = 0.05,
                 on_trip: Optional[Callable[[str, float], None]] = None):
        self.timeout_s = (default_timeout_s() if timeout_s is None
                          else float(timeout_s))
        self.poll_s = float(poll_s)
        self.on_trip = on_trip
        self.tripped = threading.Event()
        self.trips: List[Tuple[str, float]] = []
        self._lock = threading.Lock()
        self._sections: Dict[int, Tuple[str, float, bool]] = {}
        self._ids = itertools.count()
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None

    # --- sections (hot-path API: two dict ops, no context manager) ----------
    def enter(self, label: str) -> Optional[int]:
        if self.timeout_s is None:
            return None
        token = next(self._ids)
        with self._lock:
            self._sections[token] = (label, time.monotonic(), False)
        self._ensure_monitor()
        return token

    def exit(self, token: Optional[int]):
        if token is None:
            return
        with self._lock:
            self._sections.pop(token, None)

    def _ensure_monitor(self):
        if self._monitor is None or not self._monitor.is_alive():
            with self._lock:
                if self._monitor is None or not self._monitor.is_alive():
                    self._monitor = threading.Thread(
                        target=self._watch, name="zoo-dispatch-watchdog",
                        daemon=True)
                    self._monitor.start()

    def _watch(self):
        while not self._stop.wait(self.poll_s):
            now = time.monotonic()
            fired: List[Tuple[str, float]] = []
            with self._lock:
                for token, (label, t0, tripped) in self._sections.items():
                    if tripped or now - t0 <= self.timeout_s:
                        continue
                    self._sections[token] = (label, t0, True)
                    fired.append((label, now - t0))
            for label, elapsed in fired:
                self._record_trip(label, elapsed)

    def _record_trip(self, label: str, elapsed: float):
        with self._lock:
            self.trips.append((label, elapsed))
        self.tripped.set()
        STATS.add("watchdog.trips")
        STATS.add(f"watchdog.trip.{label}")
        logger.error("watchdog: dispatch %r has been blocked %.1fs "
                     "(timeout %.1fs) — hang suspected", label, elapsed,
                     self.timeout_s)
        if self.on_trip is not None:
            try:
                self.on_trip(label, elapsed)
            except Exception:           # noqa: BLE001 — observer bug must
                logger.exception("watchdog on_trip callback failed")

    # --- bounded call (waits the caller owns end-to-end) --------------------
    def run(self, fn: Callable, *args, label: str = "call",
            timeout_s: Optional[float] = None, **kwargs):
        """Run ``fn`` on a worker thread, bounded by ``timeout_s`` (default
        the watchdog's own). On expiry the worker is abandoned (daemon) and
        :class:`DispatchTimeout` raises — classification *hang*; an
        exception from ``fn`` re-raises unchanged — classification
        *crash*."""
        bound = self.timeout_s if timeout_s is None else float(timeout_s)
        if bound is None:
            return fn(*args, **kwargs)
        result: list = []
        error: list = []

        def target():
            try:
                result.append(fn(*args, **kwargs))
            except BaseException as e:  # noqa: BLE001 — re-raised below
                error.append(e)

        t0 = time.monotonic()
        t = threading.Thread(target=target, daemon=True,
                             name=f"zoo-watchdog-{label}")
        t.start()
        t.join(bound)
        if t.is_alive():
            elapsed = time.monotonic() - t0
            self._record_trip(label, elapsed)
            raise DispatchTimeout(label, elapsed, bound)
        if error:
            raise error[0]
        return result[0]

    def reset(self):
        """Clear the trip latch between recovery attempts."""
        self.tripped.clear()

    def close(self):
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=2)

    def snapshot(self) -> dict:
        with self._lock:
            return {"timeout_s": self.timeout_s, "trips": len(self.trips),
                    "by_label": {lbl: sum(1 for l, _ in self.trips
                                          if l == lbl)
                                 for lbl, _ in self.trips},
                    "open_sections": len(self._sections)}


def watched(label: str, fn: Callable, *args, **kwargs):
    """Run ``fn`` inside a section of the active watchdog (plain call when
    none is armed). For the host-side waits where a wedged device actually
    blocks — a card tensor's ``.cpu()`` / ``.item()``, a synchronize —
    since a CUDA launch returns asynchronously and the hang surfaces at
    the sync point."""
    wd = _active
    if wd is None:
        return fn(*args, **kwargs)
    token = wd.enter(label)
    try:
        return fn(*args, **kwargs)
    finally:
        wd.exit(token)


# --- process-wide active watchdog (the hot paths' one global read) ----------

_active: Optional[DispatchWatchdog] = None


def set_active(wd: DispatchWatchdog) -> DispatchWatchdog:
    global _active
    _active = wd
    return wd


def active() -> Optional[DispatchWatchdog]:
    return _active


def clear_active():
    global _active
    _active = None
