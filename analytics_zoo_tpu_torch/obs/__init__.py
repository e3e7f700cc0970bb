"""Observability plane (counterpart of ``analytics_zoo_tpu/obs``): the
metrics registry and structured spans. Exposition and Perfetto export are
not ported yet; this package stays thin so serving imports only what it
uses."""

from . import trace
from .registry import REGISTRY, Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["REGISTRY", "Counter", "Gauge", "Histogram", "MetricsRegistry",
           "trace"]
