"""Shared retry/backoff policy + circuit breaker.

Every layer of the stack used to hand-roll its own retry loop — bench.py's
``BENCH_INIT_RETRIES`` runtime-init probe, TrialRuntime's
``retry_backoff_s * 2**n`` trial backoff, the estimator's
one-blocking-retry checkpoint path. :class:`RetryPolicy` is the one
implementation: bounded exponential backoff with optional deterministic
jitter, and a transient/fatal classification so a genuinely fatal error
(bad config, corrupt input) never burns the budget that a flaky runtime or
dropped socket deserves.

:class:`CircuitBreaker` is the serving-side complement: after
``threshold`` consecutive failures it *opens* (requests are shed without
touching the wedged model/device), after ``cooldown_s`` it *half-opens*
and admits exactly one probe; the probe's outcome closes or re-opens it.
"""

from __future__ import annotations

import logging
import random
import time
from typing import Callable, Optional, Tuple, Type, Union

from .faults import InjectedFault
from .stats import STATS

logger = logging.getLogger("analytics_zoo_tpu_torch")

__all__ = ["RetryPolicy", "RetryBudgetExceeded", "CircuitBreaker",
           "DEFAULT_TRANSIENT"]

#: error classes retried by default: dropped connections, timeouts, IO
#: errors, and injected chaos faults (which model exactly those)
DEFAULT_TRANSIENT: Tuple[Type[BaseException], ...] = (
    ConnectionError, TimeoutError, OSError, InjectedFault)

#: substrings marking a transient accelerator-runtime error (the JAX/PJRT
#: runtime surfaces chip contention and resets as RuntimeError text)
_TRANSIENT_MARKERS = ("UNAVAILABLE", "DEADLINE_EXCEEDED",
                      "RESOURCE_EXHAUSTED", "ABORTED", "device lost")


class RetryBudgetExceeded(RuntimeError):
    """All attempts failed; ``__cause__`` carries the last error."""


class RetryPolicy:
    """Bounded exponential backoff with classification.

    Parameters
    ----------
    max_attempts : total tries, including the first (1 = no retry).
    base_delay_s / multiplier / max_delay_s : attempt ``n`` (1-based)
        waits ``min(base * multiplier**(n-1), max)`` before retrying.
    jitter_frac : ± fraction of the delay drawn from ``rng`` (seedable,
        so tests and the AutoML scheduler stay deterministic at 0).
    transient : exception classes (or a predicate) worth retrying;
        defaults to :data:`DEFAULT_TRANSIENT` plus anything whose message
        carries a transient accelerator-runtime marker (UNAVAILABLE, ...).
    fatal : classes never retried even when ``transient`` matches.
    """

    def __init__(self, max_attempts: int = 3, base_delay_s: float = 0.5,
                 max_delay_s: float = 30.0, multiplier: float = 2.0,
                 jitter_frac: float = 0.1,
                 transient: Union[None, Callable, Tuple, Type] = None,
                 fatal: Tuple[Type[BaseException], ...] = (),
                 name: Optional[str] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 seed: int = 0):
        self.max_attempts = max(1, int(max_attempts))
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.multiplier = float(multiplier)
        self.jitter_frac = float(jitter_frac)
        self._transient = transient
        self._fatal = tuple(fatal)
        self.name = name or "retry"
        self._sleep = sleep
        self._rng = random.Random(seed)

    # --- classification -----------------------------------------------------
    def is_transient(self, exc: BaseException) -> bool:
        if isinstance(exc, self._fatal) or \
                isinstance(exc, (KeyboardInterrupt, SystemExit)):
            return False
        t = self._transient
        if t is None:
            if isinstance(exc, DEFAULT_TRANSIENT):
                return True
            msg = str(exc)
            return any(m in msg for m in _TRANSIENT_MARKERS)
        if callable(t) and not isinstance(t, (tuple, type)):
            return bool(t(exc))
        return isinstance(exc, t)

    # --- backoff ------------------------------------------------------------
    def delay_for(self, attempt: int) -> float:
        """Seconds to wait after failed attempt ``attempt`` (1-based)."""
        d = min(self.base_delay_s * self.multiplier ** (max(attempt, 1) - 1),
                self.max_delay_s)
        if self.jitter_frac:
            d *= 1.0 + self.jitter_frac * (2.0 * self._rng.random() - 1.0)
        return max(d, 0.0)

    # --- the loop -----------------------------------------------------------
    def call(self, fn: Callable, *args,
             on_retry: Optional[Callable] = None, **kwargs):
        """Run ``fn`` under the policy. ``on_retry(attempt, exc, delay_s)``
        fires before each backoff sleep. A fatal (non-transient) error or
        an exhausted budget raises the last error unchanged — callers keep
        their exception contract."""
        last: Optional[BaseException] = None
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn(*args, **kwargs)
            except BaseException as e:      # noqa: BLE001 — classified below
                last = e
                if not self.is_transient(e) or attempt >= self.max_attempts:
                    raise
                delay = self.delay_for(attempt)
                STATS.add(f"retry.{self.name}")
                logger.warning(
                    "%s: attempt %d/%d failed (%s: %s); retrying in %.2fs",
                    self.name, attempt, self.max_attempts,
                    type(e).__name__, e, delay)
                if on_retry is not None:
                    on_retry(attempt, e, delay)
                self._sleep(delay)
        raise RetryBudgetExceeded(self.name) from last   # pragma: no cover


class CircuitBreaker:
    """closed → (``threshold`` consecutive failures) → open →
    (``cooldown_s``) → half-open → one probe → closed / open.

    Thread-safe; ``allow()`` is the admission check callers run before
    dispatching work to the protected resource, paired with exactly one
    ``record_success()`` / ``record_failure()`` per allowed dispatch."""

    def __init__(self, threshold: int = 5, cooldown_s: float = 30.0,
                 name: str = "breaker",
                 clock: Callable[[], float] = time.monotonic):
        import threading
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self.state = "closed"
        self.consecutive_failures = 0
        self.trips = 0
        self._opened_at = 0.0
        self._probe_inflight = False

    def allow(self) -> bool:
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                if self._clock() - self._opened_at >= self.cooldown_s:
                    self.state = "half_open"
                    self._probe_inflight = True
                    logger.warning("%s: half-open, admitting one probe",
                                   self.name)
                    return True
                return False
            # half_open: exactly one probe at a time
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    def record_success(self):
        with self._lock:
            if self.state != "closed":
                logger.warning("%s: probe succeeded, closing", self.name)
            self.state = "closed"
            self.consecutive_failures = 0
            self._probe_inflight = False

    def record_failure(self):
        with self._lock:
            self.consecutive_failures += 1
            reopen = self.state == "half_open"
            trip = (self.state == "closed"
                    and self.consecutive_failures >= self.threshold)
            if reopen or trip:
                self.state = "open"
                self._opened_at = self._clock()
                self._probe_inflight = False
                self.trips += 1
        if reopen or trip:
            STATS.add(f"breaker.{self.name}.trips")
            logger.warning(
                "%s: OPEN after %d consecutive failures (cooldown %.1fs)",
                self.name, self.consecutive_failures, self.cooldown_s)

    def snapshot(self) -> dict:
        """Read-only view. The reported ``state`` is *effective*: an open
        circuit whose cooldown has elapsed reads as ``half_open`` even
        though the transition itself happens lazily in :meth:`allow` —
        otherwise a readiness probe on an idle (traffic-removed) server
        would see ``open`` forever and never let traffic back to run the
        probe that closes it."""
        with self._lock:
            state = self.state
            remaining = 0.0
            if state == "open":
                remaining = self.cooldown_s - (self._clock()
                                               - self._opened_at)
                if remaining <= 0:
                    state = "half_open"
                    remaining = 0.0
            return {"state": state, "trips": self.trips,
                    "consecutive_failures": self.consecutive_failures,
                    "threshold": self.threshold,
                    "cooldown_s": self.cooldown_s,
                    "cooldown_remaining_s": round(max(remaining, 0.0), 3)}
