"""Resilience plane (counterpart of ``analytics_zoo_tpu/resilience``):
fault injection, retry/backoff and circuit breakers. The dispatch watchdog
and the training supervisor belong to the training slice."""

from . import faults  # noqa: F401  (re-exported module: faults.fire etc.)
from .retry import CircuitBreaker, RetryBudgetExceeded, RetryPolicy
from .stats import STATS, ResilienceStats, resilience_snapshot

__all__ = ["faults", "RetryPolicy", "RetryBudgetExceeded", "CircuitBreaker",
           "STATS", "ResilienceStats", "resilience_snapshot"]
