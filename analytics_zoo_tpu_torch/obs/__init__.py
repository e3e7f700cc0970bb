"""Observability plane (counterpart of ``analytics_zoo_tpu/obs``).

* :mod:`~analytics_zoo_tpu_torch.obs.registry` — the typed metrics
  registry (Counter/Gauge/Histogram with label sets) the stats surfaces
  register into, keeping their dict-returning APIs.
* :mod:`~analytics_zoo_tpu_torch.obs.trace` — structured spans with
  explicit cross-thread (and cross-payload, for serving) context
  propagation. Disarmed cost is one flag check per site (``ZOO_TRACE`` to
  arm).
* :mod:`~analytics_zoo_tpu_torch.obs.export` — Prometheus text exposition
  (the serving frontend's ``GET /metrics.prom``, ``python -m
  analytics_zoo_tpu_torch.obs dump``) and Chrome/Perfetto ``trace_event``
  JSON step timelines (``... obs perfetto``,
  ``ZOO_TRACE_PERFETTO=<path>``).

The JAX package also registers its compile plane's counters as the
``zoo_compile`` collector; this package has no compile plane yet (ROADMAP
A12), so it registers none.
"""

from . import trace
from .export import perfetto_trace, prometheus_text, write_perfetto
from .registry import REGISTRY, Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["REGISTRY", "Counter", "Gauge", "Histogram", "MetricsRegistry",
           "trace", "prometheus_text", "perfetto_trace", "write_perfetto"]
