"""Streaming-plane telemetry (counterpart of
``analytics_zoo_tpu/streaming/stats.py``).

One thread-safe counter object shared by the source (ingest/window
counters), the trainer (train/commit timers, graph-capture accounting) and
the serving-side reloader (reload count, freshness lag). Registered on
the unified obs registry as the ``zoo_streaming_*`` families — the
plane's headline gauges:

* ``last_freshness_lag_s`` — event-time -> serving-time lag of the
  newest hot-reloaded window (how stale the served weights are, in
  seconds; the streaming plane's SLO number);
* ``last_backlog`` — records sitting in the broker behind the consumer;
* ``last_records_per_s`` — training-side ingest rate over the last
  window.

``freshness_samples`` keeps the per-reload lags so a caller can report
p50/p99 without a histogram family.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict

from ..common import knobs as _knobs
from ..obs.registry import REGISTRY as _REGISTRY

__all__ = ["StreamingStats"]

#: retained per-reload freshness samples (a weeks-long reloader must not
#: grow without bound; p50/p99 over the newest 1024 reloads is the SLO)
MAX_FRESHNESS_SAMPLES = 1024


class StreamingStats:
    """Monotonic counters + last-value gauges for one streaming loop
    (thread-safe; ``last_``-prefixed adds overwrite instead of sum)."""

    _COUNTS = ("records_in", "records_trained", "records_deduped",
               "records_shed", "late_dropped", "late_included",
               "windows", "polls", "acks", "reloads",
               "recompiles_after_warm",
               # guardrail verdicts (guardrail.py): every commit scores
               # exactly one of these before serving may adopt it
               "guard_accepted", "guard_rejected", "guard_insufficient")
    _TIMES = ("ingest_s", "assemble_s", "train_s", "commit_s")

    def __init__(self, register: bool = True):
        self._lock = threading.Lock()
        self.freshness_samples = deque(maxlen=MAX_FRESHNESS_SAMPLES)
        self.reset()
        if register and _knobs.get("ZOO_OBS"):
            # obs plane: weak collector adapter — the exposition follows
            # this object's lifetime, the dict API stays the source
            _REGISTRY.register_object("zoo_streaming", self)

    def reset(self):
        with self._lock:
            for k in self._COUNTS:
                setattr(self, k, 0)
            for k in self._TIMES:
                setattr(self, k, 0.0)
            self.last_backlog = 0
            self.last_freshness_lag_s = None
            self.last_records_per_s = None
            self.last_window = None
            self.last_commit_step = None
            self.last_reload_step = None
            self.freshness_samples.clear()

    def add(self, **kw):
        with self._lock:
            for k, v in kw.items():
                if k.startswith("last_"):
                    setattr(self, k, v)
                else:
                    setattr(self, k, getattr(self, k) + v)

    def observe_freshness(self, lag_s: float):
        with self._lock:
            self.last_freshness_lag_s = round(float(lag_s), 6)
            self.freshness_samples.append(float(lag_s))

    def snapshot(self) -> Dict:
        with self._lock:
            out = {k: getattr(self, k) for k in self._COUNTS}
            out.update({k: round(getattr(self, k), 6) for k in self._TIMES})
            for k in ("last_backlog", "last_freshness_lag_s",
                      "last_records_per_s", "last_window",
                      "last_commit_step", "last_reload_step"):
                v = getattr(self, k)
                if v is not None:
                    out[k] = v
            return out
