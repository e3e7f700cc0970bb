"""Checkpoint-plane telemetry (a copy of ``analytics_zoo_tpu/ckpt/stats.py``).

One thread-safe counter object per :class:`~analytics_zoo_tpu_torch.ckpt.plane.
CheckpointPlane`, surfaced the same way the compile and transfer planes
surface theirs: ``TPUEstimator.data_pipeline_stats()["ckpt"]``, serving
``metrics()["ckpt"]`` / HTTP ``/metrics``, ``TrialRuntime.summary()
["ckpt"]`` and ``bench.py``'s checkpoint microbench.

The headline derived numbers:

* ``dedup_ratio`` — fraction of logical checkpoint bytes that were NOT
  rewritten because an identical blob (same content digest) already
  existed in the store. 0.0 = every byte written, 0.9 = nine of ten
  bytes deduplicated (e.g. an ASHA rung of trials sharing frozen
  embeddings, or back-to-back saves of a mostly-unchanged model).
* ``stall_frac`` — of the total save work, the fraction the training
  loop actually waited on (device→host snapshot + skeleton pickle);
  the rest ran on the writer thread behind training. The async-saver
  acceptance gate is stall < 20% of the blocking save time.
"""

from __future__ import annotations

import threading
from typing import Dict


class CkptStats:
    """Monotonic counters for one checkpoint plane (thread-safe)."""

    # (hot-reload counters live on InferenceModel.ckpt_stats(): reloads
    # are a property of the serving model, not of any one plane)
    _COUNTS = ("saves", "blocking_saves", "blobs_written", "blobs_deduped",
               "restores", "fallbacks", "flushes", "errors", "gc_blobs")
    _BYTES = ("bytes_logical", "bytes_written", "bytes_deduped", "gc_bytes")
    _TIMES = ("stall_s", "write_s", "hidden_s", "restore_s")

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            for k in self._COUNTS + self._BYTES:
                setattr(self, k, 0)
            for k in self._TIMES:
                setattr(self, k, 0.0)
            self.last_save_step = None
            self.last_restore_step = None

    def add(self, **kw):
        with self._lock:
            for k, v in kw.items():
                if k.startswith("last_"):
                    setattr(self, k, v)
                else:
                    setattr(self, k, getattr(self, k) + v)

    def snapshot(self) -> Dict:
        with self._lock:
            out = {k: getattr(self, k) for k in self._COUNTS + self._BYTES}
            out.update({k: round(getattr(self, k), 6) for k in self._TIMES})
            out["last_save_step"] = self.last_save_step
            out["last_restore_step"] = self.last_restore_step
            logical = self.bytes_logical
            out["dedup_ratio"] = (round(self.bytes_deduped / logical, 4)
                                  if logical else 0.0)
            work = self.stall_s + self.write_s
            out["stall_frac"] = (round(self.stall_s / work, 4)
                                 if work > 0 else 0.0)
            return out
