"""Resilience plane (counterpart of ``analytics_zoo_tpu/resilience``):
fault injection, retry/backoff, circuit breakers, the dispatch watchdog
and checkpoint-backed training supervision.

Lightweight by construction: this package imports only stdlib at module
load (the hot paths import :mod:`.faults` and :mod:`.watchdog` — their
disabled cost is one global read), and the supervisor pulls the estimator
stack in lazily.
"""

from . import faults  # noqa: F401  (re-exported module: faults.fire etc.)
from .retry import CircuitBreaker, RetryBudgetExceeded, RetryPolicy
from .stats import STATS, ResilienceStats, resilience_snapshot
from .watchdog import (DispatchTimeout, DispatchWatchdog, classify,
                       default_timeout_s)

__all__ = ["faults", "RetryPolicy", "RetryBudgetExceeded", "CircuitBreaker",
           "DispatchTimeout", "DispatchWatchdog", "classify",
           "default_timeout_s", "STATS", "ResilienceStats",
           "resilience_snapshot", "TrainingSupervisor", "SupervisorGiveUp"]


def __getattr__(name):
    # TrainingSupervisor imports the estimator stack — resolve lazily so
    # the engine can import this package without a cycle
    if name in ("TrainingSupervisor", "SupervisorGiveUp"):
        from . import supervisor as _sup
        return getattr(_sup, name)
    raise AttributeError(name)
