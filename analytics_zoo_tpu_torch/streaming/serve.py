"""Serving side of the streaming plane — hot-reload with freshness
accounting (counterpart of ``analytics_zoo_tpu/streaming/serve.py``).

A :class:`StreamingReloader` wraps the checkpoint plane's
``CheckpointWatcher`` around a live
:class:`~analytics_zoo_tpu_torch.pipeline.inference.inference_model.
InferenceModel` (or a ``ClusterServing`` engine's model): each newly
committed streaming checkpoint is hot-swapped into the serving weights —
a same-shape swap builds a new copy of the served module and replaces
the reference, so a predict in flight finishes on the weights it
started with and nothing is captured — and the manifest's stream cursor turns into the plane's SLO
number: **freshness lag**, event time of the newest trained record ->
wall clock when serving adopted it. The manifest's trace token chains the
``stream.reload`` span under the producing window's trace, closing the
ingest -> train -> commit -> serve timeline across the process boundary.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

from ..ckpt import format as ckpt_fmt
from ..ckpt.watch import CheckpointWatcher
from ..obs import trace as _trace
from .guardrail import REJECT, GuardrailEvaluator, GuardrailRejected
from .stats import StreamingStats

logger = logging.getLogger("analytics_zoo_tpu_torch")

__all__ = ["StreamingReloader"]


class StreamingReloader:
    """Watch ``root`` and hot-swap committed streaming checkpoints into a
    live serving model.

    ``model`` needs the ``InferenceModel`` adoption surface
    (``apply_checkpoint(path, state, step)``); ``ClusterServing`` callers
    pass their engine's model. ``start_at`` defaults to the step the
    model bootstrapped from (``load_checkpoint``), so a server never
    re-adopts the checkpoint it already serves — with streaming commit
    cadences the watcher usually polls *faster* than commits land, and
    the watcher's skip logic plus the watcher's delivery lock keep every step
    adopted exactly once.

    ``guard`` is an optional
    :class:`~analytics_zoo_tpu_torch.streaming.guardrail.
    GuardrailEvaluator`:
    every commit is scored on its holdout window BEFORE adoption, and a
    ``reject`` verdict raises through the watcher's rejected-step path —
    the step is skipped forever (no ``stream.reload`` span ever opens for
    it), the next commit is judged on its own merits, and the
    ``guard_rejected`` counter ticks on this reloader's stats.
    """

    def __init__(self, model, root: str, *, poll_s: float = 1.0,
                 passphrase: Optional[str] = None,
                 start_at: Optional[int] = None,
                 stats: Optional[StreamingStats] = None,
                 guard: Optional[GuardrailEvaluator] = None):
        self.model = model
        self.root = root
        self.stats = stats if stats is not None else StreamingStats()
        self.guard = guard
        if guard is not None:
            # one counter surface: the guard's verdicts land on the same
            # stats object the reloader exposes to the obs registry
            guard.stats = self.stats
        if start_at is None:
            start_at = getattr(model, "_loaded_step", None)
        self.watcher = CheckpointWatcher(
            root, self._on_checkpoint, poll_s=poll_s,
            passphrase=passphrase, start_at=start_at)

    # --- the watcher callback ----------------------------------------------
    def _on_checkpoint(self, path: str, state, step: int):
        meta = ckpt_fmt.manifest_meta(path) if \
            ckpt_fmt.is_plane_dir(path) else {}
        tok = meta.get("trace")
        if self.guard is not None:
            with _trace.span_under(tok, "stream.guard", step=step) as g:
                verdict, score = self.guard.evaluate(state, step)
                g.set(verdict=verdict,
                      score=round(score, 6) if score is not None else None)
            if verdict is REJECT:
                # span-asserted contract: commit -> guard.reject, and NO
                # stream.reload span ever opens for this step — the raise
                # rides the watcher's rejected-step path (skip forever)
                with _trace.span_under(tok, "guard.reject", step=step):
                    logger.warning(
                        "guardrail rejected streaming commit step %d "
                        "(score=%.6g, baseline=%.6g): adoption skipped",
                        step, score, self.guard.baseline())
                raise GuardrailRejected(
                    f"step {step} regressed on the holdout window "
                    f"(score={score:.6g})")
        with _trace.span_under(tok, "stream.reload",
                               step=step) as span:
            adopt = getattr(self.model, "apply_checkpoint", None)
            if adopt is None:               # bare callback consumers
                adopt = self.model
            adopt(path, state, step)
            cursor = meta.get("stream") or {}
            et = cursor.get("event_time_max")
            if et:
                # the plane's SLO: newest trained event -> served, seconds
                lag = time.time() - float(et)
                self.stats.observe_freshness(lag)
                span.set(freshness_lag_s=round(lag, 3))
        self.stats.add(reloads=1, last_reload_step=int(step))

    # --- lifecycle ----------------------------------------------------------
    def start(self) -> "StreamingReloader":
        self.watcher.start()
        return self

    def stop(self):
        self.watcher.stop()

    def poll_now(self) -> bool:
        """One synchronous check (tests/rollouts); True when a newer
        checkpoint was adopted."""
        return self.watcher.poll_now()

    # --- telemetry ----------------------------------------------------------
    @property
    def reload_count(self) -> int:
        return int(self.stats.snapshot().get("reloads", 0))

    @property
    def freshness_samples(self):
        return list(self.stats.freshness_samples)

    def freshness_percentiles(self):
        """(p50, p99) of per-reload freshness lag in seconds, or (None,
        None) before the first reload."""
        import numpy as np
        s = self.freshness_samples
        if not s:
            return None, None
        return (float(np.percentile(s, 50)), float(np.percentile(s, 99)))
