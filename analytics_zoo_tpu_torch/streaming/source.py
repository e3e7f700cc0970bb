"""StreamingXShards — tail a request stream into windowed ChunkedArray
micro-batches (counterpart of ``analytics_zoo_tpu/streaming/source.py``;
windows are composed exactly as there, record for record).

The reference platform's L2 data plane feeds live models from streaming
big-data pipelines (PAPER.md; Cluster Serving's Redis-stream ingestion).
This module is the training-side twin of the serving broker: records are
XADDed to a stream by producers (``records.encode_record`` payloads),
claimed here through the same broker/RESP2 transport serving uses
(``serving/queue_api.py`` — consumer groups, PEL + XAUTOCLAIM recovery,
reconnect-with-backoff, the ``broker.connect`` chaos site), and assembled
into **windows**: fixed-count micro-batch groups whose leaves are
:class:`~analytics_zoo_tpu_torch.orca.data.chunked.ChunkedArray` columns, ready
for the zero-copy XShards training path.

Window semantics (docs/guides/streaming.md):

* **count windows** — a window closes when ``window_records`` records
  (rounded up to a whole number of training batches) have accumulated;
* **age windows** — an older-than-``window_age_s`` buffer closes early
  with the largest whole-batch prefix; the remainder leads the next
  window. A buffer smaller than one batch never closes (training a
  partial batch would run a second batch signature, a second captured
  CUDA graph in a fused fit — the zero-recompile contract pins one);
* **watermark + late records** — the watermark trails the max event time
  seen by ``watermark_s``; a record whose event time is behind it is
  late and is dropped (acked + counted) or included per ``late_policy``;
* **backlog shedding** — when the broker backlog exceeds
  ``max_backlog``, claimed records are acked unseen until the consumer
  has caught up (freshness over completeness; sheds are counted and
  break bit-exact replay, so the bound defaults high).

At-least-once + exactly-once application: records are acked only after
the window that trained them is durably committed (the trainer calls
:meth:`ack` post-commit), so a crash replays them through the PEL/
XAUTOCLAIM path; replayed ids at or below the cursor's ``last_id`` are
deduplicated here and acked immediately. Window composition is
deterministic in stream order, which makes a replayed run's windows —
and therefore its weights — byte-identical to the uninterrupted run's.
"""

from __future__ import annotations

import logging
import time
from dataclasses import asdict, dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..common import knobs as _knobs
from ..obs import trace as _trace
from ..orca.data.chunked import ChunkedArray
from ..orca.data.shard import HostXShards
from ..serving.queue_api import Broker, make_broker
from ..shm import StaleObjectRef
from ..shm import arena_for_spec as _shm_arena_for_spec
from ..shm import peek_refs as _shm_peek_refs
from .records import decode_ref as decode_record_ref
from .stats import StreamingStats

logger = logging.getLogger("analytics_zoo_tpu_torch")

__all__ = ["StreamCursor", "Window", "StreamingXShards"]


@dataclass
class StreamCursor:
    """Resume point of the streaming loop — rides the checkpoint manifest
    (``meta["stream"]``) so a restart continues bit-exactly.

    * ``last_id`` — id of the last record whose window was trained AND
      committed; replayed entries at or below it are duplicates.
    * ``window`` — windows completed; doubles as the shuffle-epoch
      counter (``fit(initial_epoch=window)``), so with ``shuffle=True``
      a resumed window draws the same order the uninterrupted run did —
      together with the engine step (inside the same checkpoint) this is
      the loop's entire RNG state.
    * ``records`` / ``event_time_max`` — cumulative trained records and
      the newest trained event time (the freshness-lag reference point).
    """

    last_id: str = ""
    window: int = 0
    records: int = 0
    event_time_max: float = 0.0

    def to_dict(self) -> Dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "StreamCursor":
        return cls(last_id=str(d.get("last_id", "")),
                   window=int(d.get("window", 0)),
                   records=int(d.get("records", 0)),
                   event_time_max=float(d.get("event_time_max", 0.0)))


@dataclass
class Window:
    """One closed training window: records in stream order, assembled
    into ChunkedArray columns (one chunk per training batch)."""

    index: int
    ids: List[str]
    x: Tuple[ChunkedArray, ...]
    y: Optional[Tuple[ChunkedArray, ...]]
    event_time_min: float
    event_time_max: float

    @property
    def n(self) -> int:
        return len(self.ids)

    @property
    def last_id(self) -> str:
        return self.ids[-1]

    def chunked(self) -> Dict[str, Tuple[ChunkedArray, ...]]:
        out = {"x": self.x}
        if self.y is not None:
            out["y"] = self.y
        return out

    def to_xshards(self) -> HostXShards:
        """One dict shard per chunk, so the estimator's ``chunk_shards``
        rebuilds the same ChunkedArray columns without a merge copy."""
        parts = []
        for c in range(self.x[0].num_chunks):
            part = {"x": tuple(a.chunks[c] for a in self.x)}
            if self.y is not None:
                part["y"] = tuple(a.chunks[c] for a in self.y)
            parts.append(part)
        return HostXShards(parts)


class _PendingRecord:
    __slots__ = ("rid", "x", "y", "event_time")

    def __init__(self, rid, x, y, event_time):
        self.rid = rid
        self.x = x
        self.y = y
        self.event_time = event_time


class StreamingXShards:
    """Pull-mode window source over a serving broker.

    ``broker`` is a :class:`~analytics_zoo_tpu_torch.serving.queue_api.Broker`
    or a spec string (``redis://host:port/stream``, ``memory://name``,
    ``file://dir``). Only the Redis transport gives at-least-once replay
    (PEL + XAUTOCLAIM); the in-memory/file brokers are at-most-once and
    suit tests and single-process demos.

    Knobs (all overridable per-instance): ``ZOO_STREAM_WINDOW_RECORDS``,
    ``ZOO_STREAM_WINDOW_AGE_S``, ``ZOO_STREAM_WATERMARK_S``,
    ``ZOO_STREAM_LATE_POLICY``, ``ZOO_STREAM_MAX_BACKLOG``,
    ``ZOO_STREAM_POLL_TIMEOUT_S``.
    """

    def __init__(self, broker, batch_size: int, *,
                 window_records: Optional[int] = None,
                 window_age_s: Optional[float] = None,
                 watermark_s: Optional[float] = None,
                 late_policy: Optional[str] = None,
                 max_backlog: Optional[int] = None,
                 poll_timeout_s: Optional[float] = None,
                 claim_size: int = 256,
                 stats: Optional[StreamingStats] = None):
        self.broker: Broker = (make_broker(broker) if isinstance(broker, str)
                               else broker)
        self.batch_size = int(batch_size)
        if self.batch_size <= 0:
            raise ValueError("batch_size must be positive")
        wr = int(window_records if window_records is not None
                 else _knobs.get("ZOO_STREAM_WINDOW_RECORDS"))
        if wr % self.batch_size:
            rounded = -(-wr // self.batch_size) * self.batch_size
            logger.warning(
                "window_records %d rounded up to %d (a whole number of "
                "%d-row training batches keeps one batch signature — the "
                "zero-recompile contract)", wr, rounded, self.batch_size)
            wr = rounded
        self.window_records = max(wr, self.batch_size)
        self.window_age_s = float(
            window_age_s if window_age_s is not None
            else _knobs.get("ZOO_STREAM_WINDOW_AGE_S"))
        self.watermark_s = float(
            watermark_s if watermark_s is not None
            else _knobs.get("ZOO_STREAM_WATERMARK_S"))
        self.late_policy = str(
            late_policy if late_policy is not None
            else _knobs.get("ZOO_STREAM_LATE_POLICY"))
        if self.late_policy not in ("drop", "include"):
            raise ValueError(
                f"late_policy must be 'drop' or 'include', "
                f"got {self.late_policy!r}")
        self.max_backlog = int(
            max_backlog if max_backlog is not None
            else _knobs.get("ZOO_STREAM_MAX_BACKLOG"))
        self.poll_timeout_s = float(
            poll_timeout_s if poll_timeout_s is not None
            else _knobs.get("ZOO_STREAM_POLL_TIMEOUT_S"))
        self.claim_size = int(claim_size)
        self.stats = stats if stats is not None else StreamingStats()
        # decoded records awaiting a window close, in stream order; the
        # buffer survives an age-close (whole-batch prefix trains, the
        # tail leads the next window) but NOT a crash — unacked entries
        # replay through the PEL instead
        self._buf: List[_PendingRecord] = []
        self._buf_ids: set = set()
        self._buf_t0: Optional[float] = None    # wall clock of first buffer
        self._watermark = float("-inf")
        # acks owed for records consumed WITHOUT training (dedup replays,
        # late drops, backlog sheds) — flushed once per claim batch so the
        # overload-recovery path pays one batched XACK/XDEL, not two round
        # trips per record
        self._ack_buf: List[str] = []
        self._polls_since_backlog = 0
        # shm object plane: on a local ZOO_SHM-enabled stream record
        # payloads may arrive as slab descriptors — buffered records keep
        # their ref pinned until the window-commit ack done()s it
        self._arena = _shm_arena_for_spec(
            broker if isinstance(broker, str)
            else getattr(self.broker, "spec", None))
        self._refs: Dict[str, object] = {}

    # --- ingest -------------------------------------------------------------
    def _flush_acks(self):
        if not self._ack_buf:
            return
        rids, self._ack_buf = self._ack_buf, []
        try:
            self.broker.ack_many(rids)
        except Exception as e:      # noqa: BLE001 — ack is advisory here;
            # the entries stay pending and a later XAUTOCLAIM pass re-
            # delivers them into the dedup path, so progress is never
            # blocked
            logger.warning("streaming ack of %d consumed entries failed "
                           "(%s: %s); they will replay through the PEL",
                           len(rids), type(e).__name__, e)

    def _ref_done(self, ref) -> None:
        """Mark a slab descriptor consumed (no-op for inline/legacy)."""
        if ref is None or self._arena is None:
            return
        try:
            self._arena.done(ref)
        except Exception as e:      # noqa: BLE001 — freeing must not
            # stall ingest; a sweep/gc reclaims whatever this missed
            logger.warning("shm done failed for %s: %s", ref, e)

    def _peek_done(self, payload) -> None:
        """Consume-without-decode: mark the payload's descriptors done
        straight off the envelope header (dedup replays, backlog sheds —
        paths that never map the slab)."""
        if self._arena is None:
            return
        try:
            for ref in _shm_peek_refs(payload):
                self._arena.done(ref)
        except Exception as e:      # noqa: BLE001 — malformed frame
            logger.warning("shm peek failed: %s", e)

    def _ingest_one(self, rid: str, payload: bytes, cursor: StreamCursor,
                    shedding: bool) -> None:
        if rid <= cursor.last_id:
            # replayed entry whose window already trained AND committed:
            # ack and drop — exactly-once application
            self.stats.add(records_deduped=1)
            self._ack_buf.append(rid)
            self._peek_done(payload)
            return
        if rid in self._buf_ids:
            # the same entry delivered twice (XAUTOCLAIM re-stole it while
            # it sat in our buffer): drop the duplicate but do NOT ack —
            # the buffered copy is untrained, and an early ack would turn
            # a crash here into record loss. The window-commit ack clears
            # every pending delivery of the id at once. (Its slab ref is
            # the SAME blob the buffered copy holds pinned — nothing to do)
            self.stats.add(records_deduped=1)
            return
        if shedding:
            self.stats.add(records_shed=1)
            self._ack_buf.append(rid)
            self._peek_done(payload)
            return
        try:
            x, y, et, ref = decode_record_ref(payload, self._arena)
        except StaleObjectRef:
            # the blob was already consumed (a shed/drop's ack got lost and
            # the entry replayed past its freed slab): consume the
            # redelivery too — the record's consumption already happened
            self.stats.add(records_deduped=1)
            self._ack_buf.append(rid)
            return
        self._watermark = max(self._watermark, et - self.watermark_s)
        if et < self._watermark:
            if self.late_policy == "drop":
                self.stats.add(late_dropped=1)
                self._ack_buf.append(rid)
                self._ref_done(ref)
                return
            self.stats.add(late_included=1)
        if self._buf_t0 is None:
            self._buf_t0 = time.monotonic()
        self._buf.append(_PendingRecord(rid, x, y, et))
        self._buf_ids.add(rid)
        if ref is not None:
            self._refs[rid] = ref

    def _close_size(self) -> int:
        """Rows the current buffer may close with right now (0 = keep
        accumulating)."""
        n = len(self._buf)
        if n >= self.window_records:
            return self.window_records
        if (self._buf_t0 is not None and n >= self.batch_size
                and time.monotonic() - self._buf_t0 >= self.window_age_s):
            return (n // self.batch_size) * self.batch_size
        return 0

    def next_window(self, cursor: StreamCursor,
                    should_stop: Optional[Callable[[], bool]] = None,
                    idle_s: Optional[float] = None) -> Optional[Window]:
        """Block until a window closes (count reached, or age exceeded
        with at least one whole batch buffered). Returns None when
        ``should_stop`` fires, or when the stream goes IDLE — no new
        record for ``idle_s`` (the clock resets on every ingested
        record, so a live low-rate stream keeps the call alive).
        Buffered records stay claimed-but-unacked either way, so a
        restart replays them."""
        last_progress = time.monotonic()
        with _trace.span("stream.ingest", window=cursor.window) as ingest:
            t_ingest = time.perf_counter()
            polls = before = 0
            while True:
                take = self._close_size()
                if take:
                    break
                if should_stop is not None and should_stop():
                    return None
                if idle_s is not None and \
                        time.monotonic() - last_progress >= idle_s:
                    return None
                before = len(self._buf)
                backlog = self._sampled_backlog()
                batch = self.broker.claim_batch(self.claim_size,
                                                self.poll_timeout_s)
                polls += 1
                shedding = backlog > self.max_backlog
                for rid, payload in batch:
                    self._ingest_one(rid, payload, cursor, shedding)
                self._flush_acks()      # one batched XACK/XDEL per claim
                if shedding:
                    # catching up: resample immediately so shedding stops
                    # the poll after the backlog drops below the bound,
                    # not up to 15 stale polls later
                    self._polls_since_backlog = 0
                self.stats.add(polls=1,
                               records_in=len(self._buf) - before)
                if batch:
                    last_progress = time.monotonic()
            ingest.set(polls=polls, records=take)
            self.stats.add(ingest_s=time.perf_counter() - t_ingest)
        with _trace.span("stream.assemble", window=cursor.window,
                         records=take) as t:
            t0 = time.perf_counter()
            recs, self._buf = self._buf[:take], self._buf[take:]
            self._buf_ids.difference_update(r.rid for r in recs)
            self._buf_t0 = time.monotonic() if self._buf else None
            w = self._assemble(recs, cursor.window)
            self.stats.add(assemble_s=time.perf_counter() - t0)
        return w

    def _sampled_backlog(self) -> int:
        """Broker backlog, sampled every 16th poll (XLEN + XPENDING are
        two extra round trips — refreshing a gauge against a 100k default
        bound on EVERY 0.2 s poll would double the hot path's broker
        traffic). The shed decision tolerates the staleness: the bound is
        a protection valve, not a precise limit."""
        self._polls_since_backlog -= 1
        if self._polls_since_backlog > 0:
            return int(self.stats.snapshot().get("last_backlog", 0))
        self._polls_since_backlog = 16
        try:
            backlog = int(self.broker.pending())
        except Exception:   # noqa: BLE001 — telemetry only; the claim
            backlog = 0     # itself rides the broker's retry policy
        self.stats.add(last_backlog=backlog)
        return backlog

    def _assemble(self, recs: List[_PendingRecord], index: int) -> Window:
        """Stack records into ChunkedArray columns, one chunk per
        training batch — chunk boundaries are a function of batch_size
        only, so live and replayed runs assemble identical windows."""
        nx = len(recs[0].x)
        has_y = recs[0].y is not None
        ny = len(recs[0].y) if has_y else 0
        x_chunks: List[List[np.ndarray]] = [[] for _ in range(nx)]
        y_chunks: List[List[np.ndarray]] = [[] for _ in range(ny)]
        for s in range(0, len(recs), self.batch_size):
            group = recs[s:s + self.batch_size]
            for i in range(nx):
                x_chunks[i].append(np.stack([r.x[i] for r in group]))
            for i in range(ny):
                y_chunks[i].append(np.stack([r.y[i] for r in group]))
        ets = [r.event_time for r in recs]
        return Window(
            index=index,
            ids=[r.rid for r in recs],
            x=tuple(ChunkedArray(c) for c in x_chunks),
            y=tuple(ChunkedArray(c) for c in y_chunks) if has_y else None,
            event_time_min=min(ets), event_time_max=max(ets))

    # --- commit-side --------------------------------------------------------
    def ack(self, window: Window):
        """Acknowledge a trained-and-committed window's entries (the
        trainer calls this AFTER the checkpoint carrying the cursor is
        durable — acking earlier would turn a crash into record loss).
        One batched broker call: a window commit costs two Redis round
        trips, not two per record."""
        try:
            self.broker.ack_many(window.ids)
        except Exception as e:      # noqa: BLE001 — entries stay pending
            logger.warning("streaming window ack failed (%s: %s); the %d "
                           "entries will replay through the PEL and dedup "
                           "against the committed cursor",
                           type(e).__name__, e, window.n)
        # the window's arrays were copied out at assembly; the slabs are
        # consumed now that the cursor is durable (a replay past this
        # point dedups by id, never re-maps)
        for rid in window.ids:
            self._ref_done(self._refs.pop(rid, None))
        self.stats.add(acks=window.n)

    def close(self):
        # buffered-but-untrained records: drop our pins WITHOUT consuming —
        # the unacked entries replay after restart and must re-resolve
        if self._arena is not None:
            for ref in self._refs.values():
                try:
                    self._arena.release(ref)
                except Exception as e:      # noqa: BLE001 — already freed
                    logger.warning("shm release failed for %s: %s", ref, e)
        self._refs.clear()
        close = getattr(self.broker, "close", None)
        if close is not None:
            close()
