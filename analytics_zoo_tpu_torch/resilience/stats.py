"""Process-wide resilience counters.

One flat, thread-safe counter table shared by every resilience component:
the fault registry reports fires per site, the watchdog reports trips, the
supervisor reports restarts / replayed steps, RetryPolicy reports retries,
and the serving engine reports shed requests and breaker transitions. The
existing observability surfaces pick the snapshot up —
``estimator.data_pipeline_stats()["resilience"]``, serving
``metrics()["resilience"]`` / HTTP ``/metrics``, and
``TrialRuntime.summary()["resilience"]`` — so a pod operator reads fault
history in the same place as throughput.

Since the observability plane the backing store is the unified
metrics registry: every ``add(key)`` increments the
``zoo_resilience_events_total{event=key}`` counter family in
``analytics_zoo_tpu_torch.obs.registry.REGISTRY``, and :meth:`ResilienceStats.
snapshot` is a *view over the registry* — the dict API is unchanged
(empty until something fires), and the same counters now also serve on
the Prometheus exposition (``/metrics.prom``, ``zoo-metrics dump``).
"""

from __future__ import annotations

from typing import Dict

from ..obs.registry import REGISTRY

__all__ = ["ResilienceStats", "STATS", "resilience_snapshot"]

_FAMILY_NAME = "zoo_resilience_events_total"
_FAMILY_DOC = ("resilience-plane events by kind: fault fires, watchdog "
               "trips, supervisor restarts, retries, serving sheds/drains")


class ResilienceStats:
    """Monotonic named counters; empty snapshot until something happens, so
    surfaces can omit the section on healthy runs. Backed by one registry
    counter family — instances share it (the process-wide :data:`STATS` is
    the only instance the stack creates)."""

    def __init__(self):
        self._family = REGISTRY.counter(_FAMILY_NAME, _FAMILY_DOC,
                                        labelnames=("event",))

    def add(self, key: str, n: float = 1):
        # labels() is itself a get-or-create cache (one dict get when the
        # child exists) — no second cache layer needed
        self._family.labels(event=key).inc(n)

    def snapshot(self) -> Dict[str, float]:
        out = {}
        for labels, child in self._family.samples():
            v = child.value
            if v:
                v = int(v) if float(v).is_integer() else round(v, 6)
                out[labels["event"]] = v
        return dict(sorted(out.items()))

    def reset(self):
        self._family.clear()


#: the process-wide table every resilience component reports into
STATS = ResilienceStats()


def resilience_snapshot() -> Dict[str, float]:
    """Global resilience counters (empty dict when nothing has fired)."""
    return STATS.snapshot()
