"""Checkpoint-dir watcher — the serving side of the checkpoint plane
(counterpart of ``analytics_zoo_tpu/ckpt/watch.py``).

Polls a checkpoint root for a newer *committed* step and hands the
verified state to a callback. ``InferenceModel.enable_hot_reload`` uses it
to swap same-shape weights into the live serving model (the reference
rolls a new model by restarting the whole Flink job).

Uncommitted dirs are invisible by construction (the COMMIT marker lands
last), so the watcher can never observe a half-written checkpoint; a blob
checksum failure on load is skipped and retried at the next poll.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Callable, Optional

from . import format as fmt

logger = logging.getLogger("analytics_zoo_tpu_torch")


class CheckpointWatcher:
    """Background poller: ``callback(path, state, step)`` on each newly
    committed checkpoint under ``root`` (newest only — intermediate steps
    landing between polls are skipped, serving wants latest)."""

    def __init__(self, root: str, callback: Callable,
                 poll_s: float = 2.0, passphrase: Optional[str] = None,
                 start_at: Optional[int] = None):
        self.root = root
        self.callback = callback
        self.poll_s = float(poll_s)
        self.passphrase = passphrase
        self.last_step = -1 if start_at is None else int(start_at)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # delivery lock: poll_now is documented for manual rollout checks
        # while the poll thread runs, and streaming commit cadences make
        # that overlap routine (a watcher usually polls FASTER than
        # commits land). Without serialization two concurrent polls can
        # both read last_step, both load the multi-second checkpoint,
        # and both hand the SAME step to the consumer — the model must
        # never re-adopt the step it already serves.
        self._poll_lock = threading.Lock()

    # --- polling ------------------------------------------------------------
    def _latest_committed(self):
        # max-step selection by STEP NUMBER only, never scan or mtime
        # order: with multiple producers committing into one watch root
        # (fleet-scale streaming: a respawned trainer re-commits while
        # its peers race ahead) os.listdir order and directory mtimes
        # are meaningless — a lagging producer's freshly *written* dir
        # carries the newest mtime but an OLD step, and adopting it
        # would roll live serving backwards
        best = (None, -1)
        for step, path in fmt.loadable_step_dirs(self.root):
            if step > self.last_step and step > best[1]:
                best = (path, step)
        return best if best[0] else (None, None)

    def poll_now(self) -> bool:
        """One synchronous check (tests and manual rollouts call this
        directly). Returns True when a new checkpoint was delivered.
        Serialized against the poll thread: each committed step reaches
        the consumer at most once, however many pollers race."""
        with self._poll_lock:
            return self._poll_once()

    def _poll_once(self) -> bool:
        path, step = self._latest_committed()
        if path is None:
            return False
        if step <= self.last_step:
            # monotonic-adoption invariant, re-checked at the delivery
            # edge: whatever the scan returned, the consumer NEVER sees
            # a step at or below the one it already serves (the scan
            # filter and this guard can only disagree if last_step moved
            # between them — e.g. a subclass or rollout hook bumping it
            # while a poll is in flight)
            return False
        try:
            # map_blobs: the adopting engine only READS the state (predict
            # copies at device transfer), so leaves come back as read-only
            # mmap views over the page cache — N watchers adopting the
            # same step share one physical copy instead of each re-reading
            # every blob onto its heap
            state = fmt.load_checkpoint_dir(path, self.passphrase,
                                            map_blobs=True)
        except Exception as e:      # noqa: BLE001 — retry next poll
            logger.warning("hot-reload: checkpoint %s unreadable (%s: %s); "
                           "will retry", path, type(e).__name__, e)
            return False
        try:
            self.callback(path, state, step)
        except Exception as e:      # noqa: BLE001 — consumer rejected it
            # unreadable -> retry (transient: mid-GC, torn blob fixed by a
            # newer save); callback failure -> SKIP this step, or a
            # checkpoint the consumer can never swap (e.g. incompatible
            # module pickle) would be fully re-read and re-failed every
            # poll forever
            logger.warning("hot-reload: consumer rejected checkpoint %s "
                           "(%s: %s); skipping step %d",
                           path, type(e).__name__, e, step)
            self.last_step = max(self.last_step, step)
            return False
        # max(), not plain assignment: last_step must never move
        # backwards, even against a concurrent manual bump
        self.last_step = max(self.last_step, step)
        return True

    # --- lifecycle ----------------------------------------------------------
    def start(self) -> "CheckpointWatcher":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="ckpt-watcher", daemon=True)
            self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.poll_s):
            try:
                self.poll_now()
            except Exception as e:  # noqa: BLE001 — watcher must not die
                logger.warning("hot-reload poll failed: %s", e)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
