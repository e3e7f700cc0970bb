"""JSONL study event log (a copy of
``analytics_zoo_tpu/automl/scheduler/events.py`` over the port's
``obs/trace``).

One line per scheduler event under ``<logs_dir>/study_events.jsonl`` —
trial starts, rung reports, promote/pause/resume decisions, retries,
preemption, study checkpoints. Append-only and flushed per event so a
SIGTERM'd study leaves a complete trace; a resumed study appends to the
same file (the ``study_resume`` event marks the seam).

With no ``logs_dir`` the log degrades to an in-memory ring so
``summary()`` telemetry keeps working without touching disk.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from ...obs import trace as _trace

__all__ = ["EventLog"]


def _jsonable(v):
    import numpy as np
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.ndarray,)):
        return v.tolist()
    if isinstance(v, (tuple, set)):
        return [_jsonable(x) for x in v]
    if isinstance(v, list):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return repr(v)


class EventLog:
    def __init__(self, logs_dir: Optional[str] = None,
                 filename: str = "study_events.jsonl",
                 memory_limit: int = 4096):
        self.path = None
        self._fh = None
        if logs_dir:
            os.makedirs(logs_dir, exist_ok=True)
            self.path = os.path.join(logs_dir, filename)
            self._fh = open(self.path, "a", encoding="utf-8")
        self._lock = threading.Lock()
        self._recent = collections.deque(maxlen=memory_limit)
        self.counts: Dict[str, int] = collections.defaultdict(int)

    def emit(self, event: str, **fields):
        rec = {"t": round(time.time(), 3), "event": event}
        # obs plane: when tracing is armed, every event carries the trace
        # id of the span it was emitted under (the per-trial span for
        # worker-thread events), so study_events.jsonl lines join against
        # the Perfetto timeline and the span ring
        tid = _trace.current_trace_id()
        if tid:
            rec["trace"] = tid
        rec.update({k: _jsonable(v) for k, v in fields.items()})
        with self._lock:
            self.counts[event] += 1
            self._recent.append(rec)
            if self._fh is not None:
                self._fh.write(json.dumps(rec) + "\n")
                self._fh.flush()

    def recent(self, event: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            return [r for r in self._recent
                    if event is None or r["event"] == event]

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __del__(self):
        try:
            self.close()
        except (OSError, ValueError, AttributeError):
            # interpreter-shutdown teardown: the file handle (or the lock
            # attribute itself) may already be torn down
            pass
