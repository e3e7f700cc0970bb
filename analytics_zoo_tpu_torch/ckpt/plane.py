"""CheckpointPlane — async, atomic, deduplicated save/restore for one root
(counterpart of ``analytics_zoo_tpu/ckpt/plane.py``, the same code over the
port's :mod:`.format`).

The plane owns every durable-state path the stack used to serve with a
synchronous ``pickle.dump``: ``TPUEstimator`` checkpoints, TrialRuntime's
pause/resume trial states, and serving model artifacts. One instance per
checkpoint root; trials/names share the root's blob store, so identical
leaves across steps *and* across trials are stored once.

Save pipeline (``save()``):

1. **on the calling thread** — device→host snapshot (``Tensor.cpu()``),
   skeleton/leaf split, skeleton pickle. This is the only part training
   waits on (``stats.stall_s``); it also freezes the state, so training
   may mutate device buffers immediately after ``save()`` returns.
2. **on the writer thread** — sha256 per leaf, dedup lookup, blob writes,
   manifest, fsync, atomic rename, COMMIT marker, then retention + GC.
   A bounded in-flight window (``max_inflight``) makes back-pressure
   explicit: back-to-back triggers block on the window instead of piling
   snapshots up in host memory.

``blocking=True`` (or ``async_save=False``) runs step 2 inline — the
bit-identical reference path the microbench compares against.

Restore (``restore()``) walks candidates newest-first, skipping
uncommitted dirs and falling back past any checkpoint whose blob
checksums fail; legacy ``state.pkl`` dirs participate as candidates, so
pre-plane model_dirs resume unchanged.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import shutil
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ..common import knobs as _knobs
from ..obs import trace as _trace
from ..obs.registry import REGISTRY as _REGISTRY
from ..resilience.retry import RetryPolicy
from . import format as fmt
from .format import parse_step  # noqa: F401 — re-exported (ckpt.parse_step)
from .stats import CkptStats
from .store import BlobStore

logger = logging.getLogger("analytics_zoo_tpu_torch")


class _SaveJob:
    __slots__ = ("step", "name", "score", "meta", "skeleton", "leaves",
                 "done", "error", "path", "on_done", "trace")

    def __init__(self, step, name, score, meta, skeleton, leaves, path,
                 on_done=None):
        self.step = step
        self.name = name
        self.score = score
        self.meta = meta
        self.skeleton = skeleton
        self.leaves = leaves
        self.path = path
        self.on_done = on_done
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        # trace handoff: the save()-calling thread's span context, so the
        # writer thread's ckpt.write span chains to the training trace
        self.trace = _trace.token()


class CheckpointPlane:
    def __init__(self, root: str, *, keep_last_k: Optional[int] = None,
                 keep_best_k: Optional[int] = None,
                 metric_mode: str = "min",
                 passphrase: Optional[str] = None,
                 async_save: bool = True, max_inflight: int = 2,
                 fsync: bool = True, gc_min_interval_s: float = 30.0,
                 gc_grace_s: float = 120.0,
                 stats: Optional[CkptStats] = None,
                 retry_policy: Optional[RetryPolicy] = None):
        self.root = root
        self.keep_last_k = keep_last_k
        self.keep_best_k = keep_best_k
        self.metric_mode = metric_mode
        self.passphrase = passphrase
        self.encrypted = passphrase is not None
        self.async_save = async_save
        self.fsync = fsync
        self.stats = stats if stats is not None else CkptStats()
        if _knobs.get("ZOO_OBS"):
            # obs plane: this plane's counters on the unified registry
            # (weak — a closed/collected plane leaves the exposition);
            # the dict API (data_pipeline_stats()["ckpt"]) stays the source
            _REGISTRY.register_object("zoo_ckpt", self.stats)
        self.store = BlobStore(os.path.join(root, fmt.BLOB_DIR))
        self._q: "queue.Queue[Optional[_SaveJob]]" = queue.Queue(
            maxsize=max(1, int(max_inflight)))
        self._writer: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._closed = False
        # blob GC is mark-and-sweep over EVERY manifest under the root
        # (multi-writer safe, but O(total manifests) IO): throttle it so a
        # long-lived shared root (an AutoML study checkpointing every
        # pause) doesn't re-walk the tree on each retention-triggering
        # save. Orphan blobs linger at most gc_min_interval_s; close()
        # runs any deferred sweep.
        self.gc_min_interval_s = float(gc_min_interval_s)
        self.gc_grace_s = float(gc_grace_s)
        self._last_gc = float("-inf")
        self._gc_deferred = False
        self._flush_error: Optional[BaseException] = None
        # blob IO rides the shared resilience RetryPolicy: a transient
        # write failure (EINTR/EIO blip, NFS hiccup, injected chaos fault)
        # is retried with bounded backoff on the writer thread instead of
        # dropping the whole checkpoint on the floor; genuinely fatal
        # errors (ENOSPC surfaces as OSError too, but persists through the
        # budget) still land in _flush_error for flush() to report
        # the knob counts RETRIES (what its name says); max_attempts is
        # total tries, so +1 — ZOO_CKPT_IO_RETRIES=1 means one retry, not
        # silently none
        self._io_retry = retry_policy if retry_policy is not None else \
            RetryPolicy(max_attempts=1 + max(0, int(os.environ.get(
                            "ZOO_CKPT_IO_RETRIES", "2"))),
                        base_delay_s=0.1, max_delay_s=2.0, jitter_frac=0.0,
                        name="ckpt.blob_io")

    # --- save ---------------------------------------------------------------
    def _ckpt_dir(self, step: int, name: Optional[str]) -> str:
        base = os.path.join(self.root, name) if name else self.root
        return os.path.join(base, f"ckpt-{int(step)}")

    def save(self, state: Any, step: int, *, name: Optional[str] = None,
             score: Optional[float] = None, meta: Optional[Dict] = None,
             blocking: bool = False,
             on_done: Optional[Any] = None) -> str:
        """Checkpoint ``state`` (any picklable pytree; array leaves become
        content-addressed blobs). Returns the checkpoint dir path; with
        async save the write completes in the background — ``flush()``
        (or fit/run teardown) makes it durable. ``on_done(error)`` fires
        after the write (from the writer thread when async) with None on
        success — callers holding an in-memory fallback copy release it
        there, not at enqueue time."""
        if self._closed:
            raise RuntimeError("CheckpointPlane is closed")
        t0 = time.perf_counter()
        skeleton, leaves = fmt.split_state(state)   # device_get + freeze
        path = self._ckpt_dir(step, name)
        job = _SaveJob(int(step), name, score, meta, skeleton, leaves, path,
                       on_done=on_done)
        self.stats.add(saves=1, last_save_step=int(step))
        if blocking or not self.async_save:
            self.stats.add(stall_s=time.perf_counter() - t0,
                           blocking_saves=1)
            t1 = time.perf_counter()
            self._write(job)
            self.stats.add(write_s=time.perf_counter() - t1)
            if job.error is not None:
                raise job.error
            return path
        self._ensure_writer()
        self._q.put(job)            # blocks at the in-flight window
        self.stats.add(stall_s=time.perf_counter() - t0)
        return path

    def _ensure_writer(self):
        with self._lock:
            if self._writer is None or not self._writer.is_alive():
                self._writer = threading.Thread(
                    target=self._drain, name="ckpt-writer", daemon=True)
                self._writer.start()

    def _drain(self):
        while True:
            job = self._q.get()
            if job is None:
                self._q.task_done()
                return
            t0 = time.perf_counter()
            try:
                self._write(job)
                if job.error is not None:
                    self.stats.add(errors=1)
                    self._flush_error = job.error
                    logger.warning("async checkpoint save of %s failed: %s",
                                   job.path, job.error)
            finally:
                dt = time.perf_counter() - t0
                self.stats.add(write_s=dt, hidden_s=dt)
                # task_done LAST: a flush() woken by join() must already
                # see _flush_error, or the preemption path's blocking
                # retry is skipped exactly when the write failed
                self._q.task_done()

    def _write(self, job: _SaveJob):
        """Blob writes + atomic manifest commit + retention (writer side)."""
        with _trace.span_under(job.trace, "ckpt.write", step=job.step):
            self._write_job(job)

    def _write_job(self, job: _SaveJob):
        try:
            leaf_recs: List[Dict] = []
            for arr in job.leaves:
                raw = arr.tobytes()
                digest = fmt.digest_of(raw)
                wrote = self._io_retry.call(
                    self.store.put, digest, raw, self.encrypted,
                    self.passphrase, fsync=self.fsync)
                self.stats.add(bytes_logical=len(raw),
                               **({"bytes_written": len(raw),
                                   "blobs_written": 1} if wrote else
                                  {"bytes_deduped": len(raw),
                                   "blobs_deduped": 1}))
                leaf_recs.append(fmt.leaf_record(arr, digest))
            sk_digest = fmt.digest_of(job.skeleton)
            wrote = self._io_retry.call(
                self.store.put, sk_digest, job.skeleton, self.encrypted,
                self.passphrase, fsync=self.fsync)
            self.stats.add(bytes_logical=len(job.skeleton),
                           **({"bytes_written": len(job.skeleton),
                               "blobs_written": 1} if wrote else
                              {"bytes_deduped": len(job.skeleton),
                               "blobs_deduped": 1}))
            manifest = fmt.build_manifest(
                job.step,
                {"digest": sk_digest, "nbytes": len(job.skeleton)},
                leaf_recs,
                os.path.relpath(self.store.dir, job.path),
                self.encrypted, score=job.score, meta=job.meta)
            self._commit(job.path, manifest)
            self._apply_retention(job.name)
        except BaseException as e:      # noqa: BLE001 — surfaced via stats
            job.error = e
        finally:
            job.done.set()
            if job.on_done is not None:
                try:
                    job.on_done(job.error)
                except Exception:       # noqa: BLE001 — callback bug must
                    logger.exception(   # not kill the writer thread
                        "checkpoint on_done callback failed for %s",
                        job.path)

    def _commit(self, final_dir: str, manifest: Dict):
        """tmp dir → fsync → rename → COMMIT marker (see format.py)."""
        parent = os.path.dirname(final_dir)
        os.makedirs(parent, exist_ok=True)
        tmp = os.path.join(parent,
                           f".tmp-{os.path.basename(final_dir)}-"
                           f"{uuid.uuid4().hex[:8]}")
        os.makedirs(tmp)
        mpath = os.path.join(tmp, fmt.MANIFEST_NAME)
        with open(mpath, "w", encoding="utf-8") as f:
            json.dump(manifest, f, indent=1)
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())
        if self.fsync:
            fmt.fsync_dir(tmp)
        if os.path.exists(final_dir):
            # re-save at the same step (e.g. trigger + preemption landing
            # on one boundary): the newer write wins; drop the marker first
            # so a crash mid-replace cannot leave a trusted half-dir
            commit = os.path.join(final_dir, fmt.COMMIT_NAME)
            if os.path.exists(commit):
                os.remove(commit)
            shutil.rmtree(final_dir)
        os.rename(tmp, final_dir)
        commit = os.path.join(final_dir, fmt.COMMIT_NAME)
        with open(commit, "w", encoding="utf-8") as f:
            f.write(fmt.FORMAT + "\n")
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())
        if self.fsync:
            fmt.fsync_dir(final_dir)
            fmt.fsync_dir(parent)

    # --- retention + GC -----------------------------------------------------
    def _committed(self, name: Optional[str] = None
                   ) -> List[Tuple[int, str, Optional[float]]]:
        """Committed checkpoints under root[/name], legacy dirs included,
        as (step, path, score) sorted by step ascending."""
        base = os.path.join(self.root, name) if name else self.root
        out = []
        for step, path in fmt.loadable_step_dirs(base):
            score = None
            if fmt.is_plane_dir(path):
                try:
                    score = fmt.read_manifest(path).get("score")
                except Exception:   # noqa: BLE001 — unreadable manifest
                    continue
            out.append((step, path, score))
        return out

    def _apply_retention(self, name: Optional[str]):
        if self.keep_last_k is None and self.keep_best_k is None:
            return
        ckpts = self._committed(name)
        keep = set()
        if self.keep_last_k:
            keep.update(p for _, p, _ in ckpts[-int(self.keep_last_k):])
        if self.keep_best_k:
            scored = [(s, p) for _, p, s in ckpts if s is not None]
            scored.sort(key=lambda t: t[0],
                        reverse=self.metric_mode == "max")
            keep.update(p for _, p in scored[:int(self.keep_best_k)])
            # UNSCORED checkpoints (fit without validation_data) are
            # ineligible for best-k ranking but must not be deleted for
            # it: retain the newest keep_best_k of them, so a
            # best-k-only config degrades to last-k instead of silently
            # pruning everything but the newest
            unscored = [p for _, p, s in ckpts if s is None]
            keep.update(unscored[-int(self.keep_best_k):])
        if not keep:                # safety: never delete the newest
            keep.update(p for _, p, _ in ckpts[-1:])
        removed = False
        for _, path, _ in ckpts:
            if path in keep:
                continue
            commit = os.path.join(path, fmt.COMMIT_NAME)
            if os.path.exists(commit):
                os.remove(commit)   # de-commit first: never a torn trustee
            shutil.rmtree(path, ignore_errors=True)
            removed = True
        if removed:
            now = time.monotonic()
            if now - self._last_gc >= self.gc_min_interval_s:
                self.gc()
            else:
                self._gc_deferred = True

    def gc(self) -> Tuple[int, int]:
        """Sweep blobs no manifest under the root references (dedup
        refcounting by mark-and-sweep — a blob shared by surviving
        checkpoints survives any retention delete)."""
        self._last_gc = time.monotonic()
        self._gc_deferred = False
        removed, freed = self.store.gc(self.root, grace_s=self.gc_grace_s)
        if removed:
            self.stats.add(gc_blobs=removed, gc_bytes=freed)
        return removed, freed

    # --- flush / close ------------------------------------------------------
    def flush(self, timeout: Optional[float] = None) -> bool:
        """Drain pending async writes (the preemption grace-window path).
        Returns False if the writer did not finish within ``timeout`` OR
        any write since the last flush FAILED — "the queue drained" must
        never read as "the checkpoints are durable" when a disk-full save
        was dropped on the floor (the inline pickle this replaces raised
        immediately in that situation)."""
        if self._writer is None:
            return self._take_flush_error()
        if self._q.unfinished_tasks:
            self.stats.add(flushes=1)
        if timeout is None:
            self._q.join()
            return self._take_flush_error()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._q.unfinished_tasks == 0:
                return self._take_flush_error()
            time.sleep(0.005)
        return self._q.unfinished_tasks == 0 and self._take_flush_error()

    def _take_flush_error(self) -> bool:
        err, self._flush_error = self._flush_error, None
        if err is not None:
            logger.error("checkpoint flush: a queued save failed (%s: %s); "
                         "the newest restore point on disk may be older "
                         "than the training state", type(err).__name__, err)
            return False
        return True

    def close(self):
        if self._closed:
            return
        self._closed = True
        if self._writer is not None and self._writer.is_alive():
            self._q.put(None)
            self._writer.join(timeout=30)
        if self._gc_deferred:
            try:
                self.gc()           # run the throttled sweep before exit
            except OSError:         # pragma: no cover — best-effort
                pass

    # --- restore ------------------------------------------------------------
    def latest_step(self, name: Optional[str] = None) -> Optional[int]:
        self.flush()
        ckpts = self._committed(name)
        return ckpts[-1][0] if ckpts else None

    def restore(self, step: Optional[int] = None,
                name: Optional[str] = None) -> Tuple[str, Any]:
        """Load the newest committed checkpoint (or ``step``), verifying
        every blob digest; a checksum mismatch or torn dir falls back to
        the previous committed checkpoint. Returns (path, state)."""
        self.flush()
        t0 = time.perf_counter()
        ckpts = self._committed(name)
        if step is not None:
            ckpts = [c for c in ckpts if c[0] == int(step)]
        if not ckpts:
            raise FileNotFoundError(
                f"no committed checkpoint under {self.root}"
                + (f"/{name}" if name else ""))
        last_err: Optional[Exception] = None
        for s, path, _score in reversed(ckpts):
            try:
                state = fmt.load_checkpoint_dir(path, self.passphrase)
                self.stats.add(restores=1, last_restore_step=s,
                               restore_s=time.perf_counter() - t0)
                if last_err is not None:
                    logger.warning(
                        "restored %s after skipping a corrupt newer "
                        "checkpoint (%s)", path, last_err)
                return path, state
            except Exception as e:  # noqa: BLE001 — fall back to previous
                self.stats.add(fallbacks=1)
                logger.warning("checkpoint %s unreadable (%s: %s); falling "
                               "back", path, type(e).__name__, e)
                last_err = e
        raise last_err
