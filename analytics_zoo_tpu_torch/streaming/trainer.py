"""StreamingTrainer — incremental fit on fresh windows, cursor-carrying
commits, SIGTERM resume (counterpart of
``analytics_zoo_tpu/streaming/trainer.py``).

The loop composes the port's planes: windows come out of
:class:`~analytics_zoo_tpu_torch.streaming.source.StreamingXShards` (the
Redis transport, ChunkedArray assembly), each window runs one incremental
``TPUEstimator.fit`` (``initial_epoch=`` re-aligns the shuffle), the
commit rides the async CheckpointPlane with the stream cursor and the
trace token in the manifest meta, and the serving side's
CheckpointWatcher swaps the weights into a live ``InferenceModel``
(``serve.StreamingReloader``). One obs trace id spans ingest ->
assemble -> train dispatch -> ckpt commit -> watcher reload across the
loop thread, the ckpt writer thread and the watcher thread.

Where the JAX trainer counts compiled executables after window 1, this
one counts CUDA-graph captures (``orca/learn/graphs.CAPTURES``, every
kind): the trainer pins ``steps_per_dispatch`` to 1 unless the caller
pinned it, and then nothing is captured; with a pinned k on the card,
window 1 captures the one train graph of its batch signature and later
windows only replay it, so ``recompiles_after_warm`` reads 0.

Commit protocol (the cursor contract, docs/guides/streaming.md):

1. window W closes (stream-order deterministic composition);
2. ``fit`` trains W (fixed batch signature, shuffle seed = estimator
   seed + window counter);
3. the checkpoint (weights + optimizer + engine step) is committed with
   ``meta["stream"] = cursor(last_id=W.last, window=k+1, ...)`` and
   FLUSHED to disk;
4. only then are W's stream entries acked.

A SIGTERM (preemption) between any two steps resumes at the same
window: before 3, the records are unacked and replay through the PEL
into the same window; after 3 but before 4, the replayed entries dedup
against the committed cursor and are ack-compacted. Replayed records
therefore train the windows the uninterrupted run trained, and give its
weights bit for bit wherever the steps themselves are deterministic (on
the card, an embedding's ``index_add_`` backward sums with float
atomics, which are not).
"""

from __future__ import annotations

import logging
import time
from dataclasses import replace
from typing import Optional

from ..ckpt import format as ckpt_fmt
from ..obs import trace as _trace
from ..orca.learn.preemption import PreemptionWatcher
from .source import StreamCursor, StreamingXShards, Window
from .stats import StreamingStats

logger = logging.getLogger("analytics_zoo_tpu_torch")

__all__ = ["StreamingTrainer"]


def _compile_counts() -> int:
    """CUDA graphs captured in this process so far, of every kind: the
    port's counterpart of the JAX compile plane's compile count."""
    from ..orca.learn import graphs
    return sum(graphs.CAPTURES.values())


class StreamingTrainer:
    """Drive one estimator from one streaming source.

    ``estimator`` is a built or fresh
    :class:`~analytics_zoo_tpu_torch.orca.learn.estimator.TPUEstimator`; its
    ``model_dir``-independent checkpoint plane knobs (``ckpt_async``,
    retention, passphrase) apply to the streaming commits too. Unless the
    caller pinned ``steps_per_dispatch``, the trainer pins it to 1 —
    the auto fuse probe times dispatches, and a timing-dependent fuse
    factor must not decide how a *resumed* run groups its steps.
    """

    def __init__(self, estimator, source: StreamingXShards, model_dir: str,
                 *, shuffle: bool = False, commit_blocking: bool = False):
        self.estimator = estimator
        self.source = source
        self.model_dir = model_dir
        self.shuffle = shuffle
        self.commit_blocking = commit_blocking
        self.cursor = StreamCursor()
        self.stats: StreamingStats = source.stats
        estimator.config.setdefault("steps_per_dispatch", 1)
        self._warm_compiles: Optional[int] = None

    # --- resume -------------------------------------------------------------
    def resume(self) -> bool:
        """Restore the newest committed checkpoint and its cursor.
        Returns False when the model_dir holds no checkpoint (fresh
        start)."""
        try:
            path = self.estimator.load_checkpoint(self.model_dir)
        except FileNotFoundError:
            return False
        meta = ckpt_fmt.manifest_meta(path) if \
            ckpt_fmt.is_plane_dir(path) else {}
        sc = meta.get("stream")
        if sc:
            self.cursor = StreamCursor.from_dict(sc)
            logger.info("streaming resume: window %d, last id %s, "
                        "%d records applied (from %s)", self.cursor.window,
                        self.cursor.last_id or "<none>",
                        self.cursor.records, path)
        else:
            logger.warning("streaming resume: %s carries no stream cursor; "
                           "starting the cursor at zero (replays dedup "
                           "against an empty last_id)", path)
        return True

    # --- the loop -----------------------------------------------------------
    def run(self, max_windows: Optional[int] = None,
            idle_timeout_s: Optional[float] = None,
            stop: Optional[object] = None) -> StreamingStats:
        """Train until ``max_windows`` windows land, the source stays
        idle past ``idle_timeout_s`` (no NEW record for that long — a
        live low-rate stream keeps the loop running), ``stop`` (a
        threading.Event) is set, or a SIGTERM preemption notice arrives.
        Safe to re-enter: the cursor carries across calls (and across
        processes via :meth:`resume`)."""
        done = 0
        watcher = PreemptionWatcher()

        def should_stop() -> bool:
            return watcher.triggered or (stop is not None and stop.is_set())

        with watcher:
            while max_windows is None or done < max_windows:
                if should_stop():
                    break
                with _trace.span("stream.window", window=self.cursor.window):
                    w = self.source.next_window(
                        self.cursor, should_stop=should_stop,
                        idle_s=idle_timeout_s)
                    if w is None:
                        if should_stop() or idle_timeout_s is not None:
                            break
                        continue
                    self._train_window(w)
                    self._commit(w)
                    # ack ONLY now: the cursor is durable, so a crash
                    # from here on dedups instead of double-training
                    self.source.ack(w)
                done += 1
        if watcher.triggered:
            logger.warning(
                "streaming loop stopped on a preemption notice at window "
                "%d (cursor committed; unacked records will replay)",
                self.cursor.window)
        return self.stats

    def _train_window(self, w: Window):
        t0 = time.perf_counter()
        before = _compile_counts()
        self.estimator.fit(
            w.to_xshards(), epochs=1, batch_size=self.source.batch_size,
            shuffle=self.shuffle, verbose=False,
            initial_epoch=w.index)
        dt = time.perf_counter() - t0
        compiled = _compile_counts() - before
        if self._warm_compiles is None:
            # window 1 pays the one capture; every later window must
            # replay the warm graph (the streaming plane's whole
            # latency story) — track violations for the zero-recompile
            # gate
            self._warm_compiles = compiled
        elif compiled:
            self.stats.add(recompiles_after_warm=compiled)
            logger.warning("streaming window %d captured %d CUDA "
                           "graph(s); the batch signature changed",
                           w.index, compiled)
        self.stats.add(windows=1, records_trained=w.n, train_s=dt,
                       last_window=w.index,
                       last_records_per_s=round(w.n / max(dt, 1e-9), 3))

    def _commit(self, w: Window):
        t0 = time.perf_counter()
        self.cursor = replace(
            self.cursor, last_id=w.last_id, window=w.index + 1,
            records=self.cursor.records + w.n,
            event_time_max=max(self.cursor.event_time_max,
                               w.event_time_max))
        meta = {"stream": self.cursor.to_dict()}
        tok = _trace.token()
        if tok:
            # trace handoff to the serving side: the watcher's reload
            # span chains under this window via the manifest meta, the
            # same Dapper-style payload ride serving uses
            meta["trace"] = tok
        self.estimator.save_checkpoint(self.model_dir, meta=meta,
                                       blocking=self.commit_blocking)
        if not self.estimator.flush_checkpoints():
            # queued-but-failed write: one blocking retry — acking
            # against a non-durable cursor would lose records on crash
            self.estimator.save_checkpoint(self.model_dir, meta=meta,
                                           blocking=True)
        self.stats.add(commit_s=time.perf_counter() - t0,
                       last_commit_step=self.estimator.engine.step)

    def recompiles_after_warm(self) -> int:
        """CUDA graphs captured after window 1 (the zero-recompile gate
        reads 0 here)."""
        return int(self.stats.snapshot().get("recompiles_after_warm", 0))
