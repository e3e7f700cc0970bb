"""Serving queue backends.

The reference's transport is Redis streams + consumer groups
(FlinkRedisSource.scala:78-104 xreadGroup; results via pipelined HSET,
FlinkRedisSink.scala:29). This module provides the same contract —
append-only input stream with group consumption + keyed result store — with
two TPU-host-friendly backends:

* InMemoryBroker  — intra-process (tests, embedded serving)
* FileBroker      — spool-directory stream + result files; works across
  processes on one host or over a shared filesystem, no external service
* RedisBroker     — the reference's actual transport: XADD onto a stream,
  XREADGROUP/XACK consumer-group claims, HSET results — over our own RESP2
  client (redis_protocol.py), so it works against real Redis or the bundled
  MiniRedisServer with no redis-py dependency.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger("analytics_zoo_tpu_torch")


class Broker:
    #: entries this consumer stole back from a dead/stalled consumer's
    #: pending set (the XAUTOCLAIM-parity counter the SIGKILL chaos gate
    #: reads: reclaimed > 0 proves redelivery, lost == 0 proves nothing
    #: fell through)
    reclaimed: int = 0

    #: the broker spec string this handle was made from (set by
    #: :func:`make_broker`); the shm object plane derives the arena every
    #: process sharing the stream agrees on from its base
    spec: Optional[str] = None

    def enqueue(self, item_id: str, payload: bytes) -> None:
        raise NotImplementedError

    def publish_many(self, items) -> None:
        """Batch enqueue of ``[(item_id, payload), ...]`` pairs. Default:
        loop over :meth:`enqueue`; transports with per-message durability
        cost override it to amortize (the file broker pays ONE spool-dir
        fsync per call instead of one per message)."""
        for item_id, payload in items:
            self.enqueue(item_id, payload)

    def claim_batch(self, max_items: int, timeout_s: float
                    ) -> List[Tuple[str, bytes]]:
        """Blocking claim of up to max_items; returns [] on timeout."""
        raise NotImplementedError

    def put_result(self, item_id: str, payload: bytes) -> None:
        raise NotImplementedError

    def get_result(self, item_id: str, timeout_s: float = 10.0
                   ) -> Optional[bytes]:
        raise NotImplementedError

    def pending(self) -> int:
        raise NotImplementedError

    def ack(self, item_id: str) -> None:
        """Acknowledge a claimed entry WITHOUT publishing a result — the
        training-stream consumption path (streaming plane): records are
        acked only after the window that trained them is durably
        committed. All three brokers now share the Redis discipline:
        claimed entries stay pending until ``put_result``/``ack``, and a
        consumer that dies mid-batch leaves them where a live consumer's
        idle-reclaim (XAUTOCLAIM parity) re-delivers them."""
        return None

    def ack_many(self, item_ids) -> None:
        """Batch form of :meth:`ack` (a streaming window commit acks its
        whole window at once; the Redis broker turns this into ONE
        XACK + ONE XDEL instead of two round trips per record)."""
        for item_id in item_ids:
            self.ack(item_id)

    # --- fleet surface (scale-out serving tier) ----------------------------
    def oldest_age_s(self) -> float:
        """Age (seconds) of the oldest entry still on the stream —
        claimed-but-unacked included — or 0.0 when empty. The frontends'
        queue-age shed reads this: head-of-line age is a lower bound on
        what a new arrival will wait, so shedding on it (429 +
        Retry-After, before enqueue) beats admitting work that will only
        expire."""
        return 0.0

    def heartbeat(self, worker_id: str,
                  stats: Optional[Dict] = None) -> None:
        """Publish worker liveness + occupancy stats through the broker
        itself (no side channel): the fleet supervisor's autoscale signal
        and the frontend ``/readyz`` live-worker count both read
        :meth:`live_workers`. Default: no-op (exotic brokers stay
        compatible)."""
        return None

    def clear_heartbeat(self, worker_id: str) -> None:
        """Drop a worker's heartbeat (graceful drain/retire — the worker
        disappears from ``live_workers`` immediately instead of aging out
        over the TTL)."""
        return None

    def live_workers(self, ttl_s: float = 3.0) -> Dict[str, Dict]:
        """``worker_id -> last heartbeat stats`` for workers whose
        heartbeat is younger than ``ttl_s``."""
        return {}


class InMemoryBroker(Broker):
    """Intra-process broker with Redis consumer-group parity: a claim
    moves entries into a shared pending set (PEL) stamped with the
    claiming consumer + claim time; ``put_result``/``ack`` releases them;
    entries idle past ``claim_idle_s`` are stolen by whichever consumer
    claims next (XAUTOCLAIM parity, counted in :attr:`reclaimed`).
    :meth:`view` returns a handle over the SAME stream under a distinct
    consumer id, so multi-consumer fleet semantics (disjoint claims,
    dead-consumer reclaim) are testable without a Redis server."""

    _instances: Dict[str, "InMemoryBroker"] = {}

    @classmethod
    def get(cls, name: str = "serving_stream") -> "InMemoryBroker":
        if name not in cls._instances:
            cls._instances[name] = cls()
        return cls._instances[name]

    def __init__(self, claim_idle_s: float = 30.0,
                 consumer: Optional[str] = None):
        # stream rows: [seq, item_id, payload, t_enq]
        self._q: List[List] = []
        # PEL rows: seq -> [item_id, payload, t_enq, consumer, t_claim]
        self._pel: Dict[int, List] = {}
        self._by_item: Dict[str, List[int]] = {}
        self._results: Dict[str, bytes] = {}
        self._hb: Dict[str, Tuple[float, Dict]] = {}
        self._cv = threading.Condition()
        self._seq = itertools.count()
        self.claim_idle_s = float(claim_idle_s)
        self.consumer = consumer or f"mem-{uuid.uuid4().hex[:8]}"
        self.reclaimed = 0

    def view(self, consumer: Optional[str] = None,
             claim_idle_s: Optional[float] = None) -> "InMemoryBroker":
        """A second consumer over the SAME stream/results/PEL (the
        in-memory analogue of two XREADGROUP connections in one group)."""
        b = object.__new__(InMemoryBroker)
        b._q = self._q
        b._pel = self._pel
        b._by_item = self._by_item
        b._results = self._results
        b._hb = self._hb
        b._cv = self._cv
        b._seq = self._seq
        b.claim_idle_s = (self.claim_idle_s if claim_idle_s is None
                          else float(claim_idle_s))
        b.consumer = consumer or f"mem-{uuid.uuid4().hex[:8]}"
        b.reclaimed = 0
        return b

    def enqueue(self, item_id, payload):
        with self._cv:
            self._q.append([next(self._seq), item_id, payload, time.time()])
            self._cv.notify_all()

    def _steal_stale(self, max_items: int) -> List[Tuple[str, bytes]]:
        # caller holds self._cv; XAUTOCLAIM parity: re-deliver entries
        # whose claim went idle (their consumer died mid-batch, or wedged)
        now = time.time()
        out = []
        for seq in sorted(self._pel):
            if len(out) >= max_items:
                break
            row = self._pel[seq]
            if now - row[4] >= self.claim_idle_s:
                row[3] = self.consumer
                row[4] = now
                out.append((row[0], row[1]))
        return out

    def claim_batch(self, max_items, timeout_s):
        deadline = time.time() + timeout_s
        # bounded waits, not one long one: a PEL entry becoming stale
        # fires no notify, so the reclaim scan must get its turn
        poll = max(min(self.claim_idle_s / 4.0, 0.05), 0.002)
        with self._cv:
            while True:
                batch = self._steal_stale(max_items)
                self.reclaimed += len(batch)
                take = self._q[:max_items - len(batch)]
                del self._q[:len(take)]
                now = time.time()
                for seq, item_id, payload, t_enq in take:
                    self._pel[seq] = [item_id, payload, t_enq,
                                      self.consumer, now]
                    self._by_item.setdefault(item_id, []).append(seq)
                    batch.append((item_id, payload))
                if batch:
                    return batch
                remaining = deadline - time.time()
                if remaining <= 0:
                    return []
                self._cv.wait(min(remaining, poll))

    def _release(self, item_id: str, all_entries: bool):
        # caller holds self._cv
        seqs = self._by_item.get(item_id)
        if not seqs:
            return
        take = seqs if all_entries else seqs[:1]
        for seq in take:
            self._pel.pop(seq, None)
        left = seqs[len(take):]
        if left:
            self._by_item[item_id] = left
        else:
            self._by_item.pop(item_id, None)

    def put_result(self, item_id, payload):
        with self._cv:
            # one entry per result, like the Redis broker: a duplicate
            # enqueue of the same uri keeps its own pending entry until
            # its own result publishes
            self._release(item_id, all_entries=False)
            self._results[item_id] = payload
            self._cv.notify_all()

    def ack(self, item_id):
        with self._cv:
            self._release(item_id, all_entries=True)

    def ack_many(self, item_ids):
        with self._cv:
            for item_id in item_ids:
                self._release(item_id, all_entries=True)

    def get_result(self, item_id, timeout_s=10.0):
        deadline = time.time() + timeout_s
        with self._cv:
            while item_id not in self._results:
                remaining = deadline - time.time()
                if remaining <= 0:
                    return None
                self._cv.wait(remaining)
            return self._results.pop(item_id)

    def pending(self):
        with self._cv:
            return len(self._q)

    def oldest_age_s(self):
        with self._cv:
            ts = [row[3] for row in self._q]
            ts += [row[2] for row in self._pel.values()]
        return max(0.0, time.time() - min(ts)) if ts else 0.0

    def heartbeat(self, worker_id, stats=None):
        with self._cv:
            self._hb[worker_id] = (time.time(), dict(stats or {}))

    def clear_heartbeat(self, worker_id):
        with self._cv:
            self._hb.pop(worker_id, None)

    def live_workers(self, ttl_s=3.0):
        now = time.time()
        with self._cv:
            return {w: dict(s) for w, (t, s) in self._hb.items()
                    if now - t <= ttl_s}


class FileBroker(Broker):
    """Spool-dir stream: input items are files under in/, claimed
    atomically by rename into claimed/ (kept there, named
    ``<consumer>~<entry>``, until the result publishes or the entry is
    acked — the filesystem PEL), results under out/<id>, heartbeats under
    hb/. A claimed file whose mtime goes idle past ``claim_idle_s`` is
    requeued into in/ by the next claimer (XAUTOCLAIM parity), so a
    SIGKILLed worker's in-flight entries re-deliver to survivors."""

    def __init__(self, root: str, consumer: Optional[str] = None,
                 claim_idle_s: float = 30.0, fsync: bool = True):
        self.root = root
        for sub in ("in", "claimed", "out", "hb"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
        self.consumer = consumer or f"fs-{uuid.uuid4().hex[:8]}"
        self.claim_idle_s = float(claim_idle_s)
        self.fsync = bool(fsync)
        self.reclaimed = 0
        # claimed paths per item, this handle only (the Redis broker's
        # _pending_acks twin): a crashed process loses the map but its
        # files stay in claimed/ where the idle requeue finds them
        self._claimed: Dict[str, List[str]] = {}
        self._lock = threading.Lock()

    def _stage(self, item_id, payload) -> Tuple[str, str]:
        """Write payload to a tmp spool file (fsynced when durability is
        on) and return ``(tmp, final)`` — the rename is the publish."""
        tmp = os.path.join(self.root, "in", f".tmp-{uuid.uuid4().hex}")
        with open(tmp, "wb") as f:
            f.write(payload)
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())
        return tmp, os.path.join(
            self.root, "in", f"{time.time_ns()}-{item_id}")

    def _fsync_in_dir(self):
        fd = os.open(os.path.join(self.root, "in"), os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def enqueue(self, item_id, payload):
        tmp, final = self._stage(item_id, payload)
        os.replace(tmp, final)
        if self.fsync:
            self._fsync_in_dir()

    def publish_many(self, items):
        """Batched spool publish: every payload staged + fsynced, every
        rename issued, then ONE directory fsync covers the whole batch —
        N-1 fewer metadata flushes than N enqueues on the transport the
        FLEET snapshot rides."""
        staged = [self._stage(item_id, payload) for item_id, payload
                  in items]
        for tmp, final in staged:
            os.replace(tmp, final)
        if self.fsync and staged:
            self._fsync_in_dir()

    def _requeue_stale(self):
        # XAUTOCLAIM parity: a claimed file idle past claim_idle_s goes
        # BACK into in/ under its original (timestamped) name, so the
        # redelivery keeps its original stream position
        cl_dir = os.path.join(self.root, "claimed")
        now = time.time()
        for n in os.listdir(cl_dir):
            if "~" not in n:
                continue
            path = os.path.join(cl_dir, n)
            try:
                idle = now - os.path.getmtime(path)
            except OSError:
                continue        # acked/requeued by another consumer
            if idle < self.claim_idle_s:
                continue
            try:
                os.replace(path, os.path.join(
                    self.root, "in", n.split("~", 1)[1]))
            except OSError:
                continue        # another consumer won the steal
            self.reclaimed += 1

    def claim_batch(self, max_items, timeout_s):
        deadline = time.time() + timeout_s
        in_dir = os.path.join(self.root, "in")
        while True:
            self._requeue_stale()
            names = sorted(n for n in os.listdir(in_dir)
                           if not n.startswith("."))
            batch = []
            for n in names[:max_items]:
                src = os.path.join(in_dir, n)
                dst = os.path.join(self.root, "claimed",
                                   f"{self.consumer}~{n}")
                try:
                    os.replace(src, dst)  # atomic claim
                except OSError:
                    continue  # another worker won
                # rename preserves mtime — restamp so idle time counts
                # from the CLAIM, not the enqueue
                os.utime(dst, None)
                with open(dst, "rb") as f:
                    payload = f.read()
                item_id = n.split("-", 1)[1]
                with self._lock:
                    self._claimed.setdefault(item_id, []).append(dst)
                batch.append((item_id, payload))
            if batch or time.time() >= deadline:
                return batch
            time.sleep(0.005)

    def _unlink_claimed(self, item_id: str, all_entries: bool):
        with self._lock:
            paths = self._claimed.get(item_id)
            if not paths:
                return
            take = list(paths) if all_entries else paths[:1]
            left = paths[len(take):]
            if left:
                self._claimed[item_id] = left
            else:
                del self._claimed[item_id]
        for path in take:
            try:
                os.unlink(path)
            except OSError:
                # requeued by another consumer after our claim went
                # idle — the redelivery owns the entry now
                logger.debug("file broker: claimed entry %s already "
                             "requeued", path)

    def put_result(self, item_id, payload):
        tmp = os.path.join(self.root, "out", f".tmp-{uuid.uuid4().hex}")
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, os.path.join(self.root, "out", item_id))
        self._unlink_claimed(item_id, all_entries=False)

    def ack(self, item_id):
        self._unlink_claimed(item_id, all_entries=True)

    def ack_many(self, item_ids):
        for item_id in item_ids:
            self._unlink_claimed(item_id, all_entries=True)

    def get_result(self, item_id, timeout_s=10.0):
        path = os.path.join(self.root, "out", item_id)
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if os.path.exists(path):
                with open(path, "rb") as f:
                    data = f.read()
                os.unlink(path)
                return data
            time.sleep(0.005)
        return None

    def pending(self):
        return len([n for n in os.listdir(os.path.join(self.root, "in"))
                    if not n.startswith(".")])

    def oldest_age_s(self):
        oldest = None
        for sub in ("in", "claimed"):
            for n in os.listdir(os.path.join(self.root, sub)):
                if n.startswith("."):
                    continue
                base = n.split("~", 1)[1] if "~" in n else n
                try:
                    ts = int(base.split("-", 1)[0]) / 1e9
                except ValueError:
                    continue
                oldest = ts if oldest is None else min(oldest, ts)
        return max(0.0, time.time() - oldest) if oldest is not None else 0.0

    def heartbeat(self, worker_id, stats=None):
        doc = dict(stats or {})
        doc["t"] = time.time()
        tmp = os.path.join(self.root, "hb", f".tmp-{uuid.uuid4().hex}")
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, os.path.join(self.root, "hb", worker_id))

    def clear_heartbeat(self, worker_id):
        try:
            os.unlink(os.path.join(self.root, "hb", worker_id))
        except OSError:
            logger.debug("file broker: heartbeat %s already gone",
                         worker_id)

    def live_workers(self, ttl_s=3.0):
        hb_dir = os.path.join(self.root, "hb")
        now = time.time()
        out = {}
        for n in os.listdir(hb_dir):
            if n.startswith("."):
                continue
            path = os.path.join(hb_dir, n)
            try:
                if now - os.path.getmtime(path) > ttl_s:
                    continue
                with open(path) as f:
                    out[n] = json.load(f)
            except (OSError, ValueError):
                continue        # mid-replace or torn read: not live yet
        return out


class RedisBroker(Broker):
    """Redis-streams transport (reference: FlinkRedisSource.scala:78-104).

    Input records are XADDed to ``<stream>`` with fields ``uri``/``data``;
    the engine side claims them with XREADGROUP on consumer group ``group``
    and XACKs/XDELs only after the result is published (``put_result``), so
    a worker that crashes mid-inference leaves its claims in the group PEL
    where XAUTOCLAIM steals them — at-least-once delivery end to end.
    Results go to hash ``result:<id>`` field
    ``value`` (reference sink pipelines HSETs, FlinkRedisSink.scala:29) and
    are deleted on read, matching the reference client's get-then-forget
    polling loop (pyzoo client.py:250-282).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 stream: str = "serving_stream", group: str = "serving",
                 consumer: Optional[str] = None,
                 claim_idle_ms: int = 30000,
                 retry_policy=None):
        from ..resilience.retry import RetryPolicy
        from .redis_protocol import RedisClient, RedisError
        self._RedisClient = RedisClient
        self._RedisError = RedisError
        # broker-loss resilience: a dropped/refused connection is retried
        # through the shared RetryPolicy (reconnect happens inside
        # RedisClient on the next call) instead of surfacing a raw
        # ConnectionError to the serving worker loop. Stream semantics stay
        # at-least-once: a retried XADD may duplicate an entry whose reply
        # was lost, a retried XREADGROUP's lost claims land in the PEL
        # where XAUTOCLAIM recovers them, HSET results are idempotent.
        # the knob counts RETRIES (what its name says); max_attempts is
        # total tries, so +1 — RETRIES=1 means one reconnect, not none
        self._retry = retry_policy if retry_policy is not None else \
            RetryPolicy(
                max_attempts=1 + max(0, int(os.environ.get(
                    "ZOO_BROKER_RECONNECT_RETRIES", "4"))),
                base_delay_s=float(os.environ.get(
                    "ZOO_BROKER_RECONNECT_BACKOFF_S", "0.2")),
                max_delay_s=5.0, jitter_frac=0.1,
                transient=(ConnectionError, TimeoutError, OSError),
                name="broker.connect")
        self.host, self.port = host, port
        self.stream = stream.encode()
        self.group = group.encode()
        self.consumer = (consumer or f"cs-{uuid.uuid4().hex[:8]}").encode()
        # one connection per calling thread: blocking XREADGROUP claims from
        # one serving worker must not serialize the other workers (or
        # put_result calls) behind a shared socket lock
        self._tls = threading.local()
        self._clients: List = []
        self._clients_lock = threading.Lock()
        # stale-pending recovery: a consumer that died between XREADGROUP
        # and XACK leaves its entries in the group PEL forever (they are
        # past the group's last-delivered id, so '>' never re-delivers).
        # Periodic XAUTOCLAIM steals entries idle >= claim_idle_ms back to
        # a live consumer, restoring at-least-once delivery.
        self._claim_idle_ms = claim_idle_ms
        self._last_autoclaim = 0.0
        # entry ids claimed but not yet acked: acked/deleted only after the
        # result is published (put_result), so a worker that dies mid-batch
        # leaves its entries in the group PEL where XAUTOCLAIM can steal them
        self._pending_acks: Dict[str, List[bytes]] = {}
        self._pending_lock = threading.Lock()
        self.reclaimed = 0
        self._hb_key = b"fleet:" + self.stream + b":hb"
        try:
            # the connect itself must ride the retry policy too (not just
            # the command): _conn() evaluated as an argument would put the
            # first connection OUTSIDE the backoff loop, so a broker
            # coming up just after a restart would fail construction
            self._retry.call(
                lambda: self._conn().execute(
                    "XGROUP", "CREATE", self.stream, self.group, "0",
                    "MKSTREAM"))
        except RedisError as e:
            if "BUSYGROUP" not in str(e):
                raise

    def _conn(self):
        c = getattr(self._tls, "client", None)
        if c is None:
            c = self._RedisClient(self.host, self.port)
            self._tls.client = c
            with self._clients_lock:
                self._clients.append(c)
        return c

    def enqueue(self, item_id, payload):
        self._retry.call(self._conn().execute, "XADD", self.stream, "*",
                         "uri", item_id, "data", payload)

    def claim_batch(self, max_items, timeout_s):
        # reconnect-with-backoff around the whole claim: lost claims whose
        # reply vanished sit in the PEL until XAUTOCLAIM steals them back,
        # so a retry cannot drop work
        return self._retry.call(self._claim_batch, max_items, timeout_s)

    def _claim_batch(self, max_items, timeout_s):
        # BLOCK 0 means "block forever" on real Redis — clamp to >=1ms so a
        # zero/sub-ms timeout stays a poll, matching the other brokers
        block_ms = max(1, int(timeout_s * 1000))
        c = self._conn()
        batch, ids = [], []
        now = time.time()
        if now - self._last_autoclaim > self._claim_idle_ms / 2000.0:
            self._last_autoclaim = now
            try:
                stolen = c.execute(
                    "XAUTOCLAIM", self.stream, self.group, self.consumer,
                    self._claim_idle_ms, "0-0", "COUNT", max_items)
                for eid, fields in (stolen[1] if stolen else []):
                    kv = {fields[i]: fields[i + 1]
                          for i in range(0, len(fields), 2)}
                    batch.append((kv[b"uri"].decode(), kv[b"data"]))
                    ids.append(eid)
                    self.reclaimed += 1
            except self._RedisError:
                pass  # pre-6.2 Redis has no XAUTOCLAIM; skip recovery
        if len(batch) < max_items:
            # read fresh entries even when XAUTOCLAIM returned some: a
            # consumer configured with a small claim_idle_ms (streaming
            # restart recovery) would otherwise re-steal the same pending
            # entries every poll and STARVE the new-traffic read — stolen
            # entries merge ahead of fresh ones (PEL order, then stream
            # order), the order a replay reproduces
            reply = c.execute(
                "XREADGROUP", "GROUP", self.group, self.consumer,
                "COUNT", max_items - len(batch),
                "BLOCK", 1 if batch else block_ms,
                "STREAMS", self.stream, ">",
                timeout_s=timeout_s + 5.0)
            for _key, entries in (reply or []):
                for eid, fields in entries:
                    kv = {fields[i]: fields[i + 1]
                          for i in range(0, len(fields), 2)}
                    batch.append((kv[b"uri"].decode(), kv[b"data"]))
                    ids.append(eid)
        if not batch:
            return []
        if ids:
            with self._pending_lock:
                for (item_id, _), eid in zip(batch, ids):
                    self._pending_acks.setdefault(item_id, []).append(eid)
        return batch

    def put_result(self, item_id, payload):
        return self._retry.call(self._put_result, item_id, payload)

    def _put_result(self, item_id, payload):
        c = self._conn()
        c.execute("HSET", b"result:" + item_id.encode(), "value", payload)
        # ack + trim only now that the result is durably published; entries
        # for crashed workers stay in the PEL until XAUTOCLAIM steals them.
        # One entry per call: if the same uri was enqueued twice, each copy's
        # ack waits for its own result, preserving at-least-once per entry.
        with self._pending_lock:
            eids = self._pending_acks.get(item_id)
            eid = eids.pop(0) if eids else None
            if eids is not None and not eids:
                del self._pending_acks[item_id]
        if eid is not None:
            c.execute("XACK", self.stream, self.group, eid)
            c.execute("XDEL", self.stream, eid)

    def ack(self, item_id):
        """Resultless acknowledgement (streaming consumption): XACK + XDEL
        every pending entry claimed under ``item_id``. All entries, not
        one — a replayed/XAUTOCLAIM-stolen duplicate of the same record
        must not leave a phantom forever-pending entry behind."""
        self.ack_many([item_id])

    def ack_many(self, item_ids):
        self._retry.call(self._ack_all, list(item_ids))

    def _ack_all(self, item_ids):
        # eids leave _pending_acks only AFTER the server acknowledged
        # them: popping first would make a transient-failure retry find
        # nothing to ack and "succeed", leaving the entries pending in
        # the PEL forever (the same argument-evaluation trap the
        # constructor's retry fixes). XACK/XDEL are idempotent, so a
        # retry that re-sends already-acked ids is harmless.
        with self._pending_lock:
            eids = [e for i in item_ids
                    for e in self._pending_acks.get(i, ())]
        if not eids:
            return
        c = self._conn()
        # one XACK + one XDEL for the whole batch (a 1024-record window
        # commit is 2 round trips, not 2048)
        c.execute("XACK", self.stream, self.group, *eids)
        c.execute("XDEL", self.stream, *eids)
        done = set(eids)
        with self._pending_lock:
            for i in item_ids:
                cur = self._pending_acks.get(i)
                if not cur:
                    continue
                left = [e for e in cur if e not in done]
                if left:
                    self._pending_acks[i] = left
                else:
                    del self._pending_acks[i]

    def get_result(self, item_id, timeout_s=10.0):
        key = b"result:" + item_id.encode()
        deadline = time.time() + timeout_s
        while True:
            # HGET/DEL are idempotent — each poll rides the reconnect
            # policy individually so the deadline math stays honest
            val = self._retry.call(self._conn().execute, "HGET", key,
                                   "value")
            if val is not None:
                self._retry.call(self._conn().execute, "DEL", key)
                return val
            if time.time() >= deadline:
                return None
            time.sleep(0.005)

    def pending(self):
        """Backlog = stream length minus claimed-but-unacked entries, so it
        means the same thing as the other brokers' pending() (entries now
        stay in the stream until their result publishes)."""
        return self._retry.call(self._pending)

    def _pending(self):
        c = self._conn()
        backlog = int(c.execute("XLEN", self.stream))
        try:
            p = c.execute("XPENDING", self.stream, self.group)
            in_flight = int(p[0]) if p else 0
        except self._RedisError:
            in_flight = 0
        return max(backlog - in_flight, 0)

    def oldest_age_s(self):
        return self._retry.call(self._oldest_age_s)

    def _oldest_age_s(self):
        reply = self._conn().execute(
            "XRANGE", self.stream, "-", "+", "COUNT", 1)
        if not reply:
            return 0.0
        eid = reply[0][0]
        ms = int(eid.split(b"-", 1)[0])
        return max(0.0, time.time() - ms / 1000.0)

    def heartbeat(self, worker_id, stats=None):
        doc = dict(stats or {})
        doc["t"] = time.time()
        self._retry.call(self._conn().execute, "HSET", self._hb_key,
                         worker_id, json.dumps(doc))

    def clear_heartbeat(self, worker_id):
        self._retry.call(self._conn().execute, "HDEL", self._hb_key,
                         worker_id)

    def live_workers(self, ttl_s=3.0):
        flat = self._retry.call(self._conn().execute, "HGETALL",
                                self._hb_key) or []
        now = time.time()
        out = {}
        for i in range(0, len(flat), 2):
            try:
                doc = json.loads(flat[i + 1])
            except ValueError:
                continue
            if now - float(doc.get("t", 0.0)) <= ttl_s:
                out[flat[i].decode()] = doc
        return out

    def close(self):
        with self._clients_lock:
            clients, self._clients = self._clients, []
        for c in clients:
            c.close()


class PartitionedBroker(Broker):
    """Producer-side fan-out over N keyed sub-streams of one broker spec.

    ``make_broker("redis://h:p/s?partitions=4")`` returns one of these:
    :meth:`enqueue` routes each record to sub-stream ``s.p{k}`` by its
    routing key (``streaming.records.record_key``, CRC32-hashed — the
    same deterministic hash every consumer uses), falling back to the
    item id for keyless payloads, so all records of one key land on ONE
    partition in stream order — the invariant that keeps per-partition
    cursors and bit-exact replay meaningful at fleet scale. Consumers do
    NOT go through this class: each fleet trainer opens its own
    ``...?partition=k`` sub-broker and claims only its shard (disjoint by
    construction — different partitions are different streams).

    The aggregate read surface (:meth:`pending`, :meth:`oldest_age_s`,
    :meth:`live_workers`) merges across partitions so supervisors and
    frontends see whole-stream numbers; :meth:`claim_batch` round-robins
    the partitions (a single-consumer reader of a partitioned stream,
    used by coverage tests and drain tooling, not the fleet hot path).
    """

    def __init__(self, parts: List[Broker],
                 partition_by: Optional[str] = None):
        if not parts:
            raise ValueError("PartitionedBroker needs >= 1 partition")
        from ..common import knobs as _knobs
        self.parts = list(parts)
        self.partition_by = str(
            partition_by if partition_by is not None
            else _knobs.get("ZOO_STREAM_PARTITION_BY"))
        if self.partition_by not in ("key", "id"):
            raise ValueError(
                f"partition_by must be 'key' or 'id', "
                f"got {self.partition_by!r}")
        self._rr = 0

    @property
    def n_partitions(self) -> int:
        return len(self.parts)

    @property
    def reclaimed(self) -> int:
        # derived, read-only: the per-partition consumers own the counts
        return sum(int(getattr(p, "reclaimed", 0)) for p in self.parts)

    def partition_of(self, item_id: str, payload: bytes) -> int:
        """Partition index a record routes to: the record's stamped key
        when it carries one, else the item id (both through the same
        process-stable CRC32 hash)."""
        # lazy import: streaming.records is leaf-level, but importing the
        # streaming package from this module's top level would cycle back
        # through streaming.source -> queue_api
        from ..streaming.records import partition_for, record_key
        key = None
        if self.partition_by == "key":
            # header-only, copy-free: record_key accepts any buffer and
            # reads just the magic + JSON header; descriptor envelopes
            # (ZSHM1) carry the key in the envelope header
            head = bytes(memoryview(payload)[:5])
            if head[:4] == b"ZSR1" or head == b"ZSHM1":
                try:
                    key = record_key(payload)
                except ValueError:
                    key = None
        return partition_for(key if key is not None else item_id,
                             len(self.parts))

    def enqueue(self, item_id, payload):
        self.parts[self.partition_of(item_id, payload)].enqueue(
            item_id, payload)

    def publish_many(self, items):
        # group by partition so each sub-broker sees one batch (the file
        # transport then pays one dir fsync per partition, not per item)
        groups: Dict[int, List] = {}
        for item_id, payload in items:
            groups.setdefault(
                self.partition_of(item_id, payload), []).append(
                    (item_id, payload))
        for k, group in groups.items():
            self.parts[k].publish_many(group)

    def claim_batch(self, max_items, timeout_s):
        deadline = time.time() + timeout_s
        while True:
            for i in range(len(self.parts)):
                part = self.parts[(self._rr + i) % len(self.parts)]
                batch = part.claim_batch(max_items, 0.0)
                if batch:
                    self._rr = (self._rr + i + 1) % len(self.parts)
                    return batch
            if time.time() >= deadline:
                return []
            time.sleep(0.005)

    def ack(self, item_id):
        # the router knows where a PAYLOAD goes, not where an id was
        # claimed; ack is idempotent on every transport, so fan it out
        for p in self.parts:
            p.ack(item_id)

    def ack_many(self, item_ids):
        ids = list(item_ids)
        for p in self.parts:
            p.ack_many(ids)

    def put_result(self, item_id, payload):
        from ..streaming.records import partition_for
        self.parts[partition_for(item_id, len(self.parts))].put_result(
            item_id, payload)

    def get_result(self, item_id, timeout_s=10.0):
        from ..streaming.records import partition_for
        return self.parts[partition_for(
            item_id, len(self.parts))].get_result(item_id, timeout_s)

    def pending(self):
        return sum(p.pending() for p in self.parts)

    def oldest_age_s(self):
        return max((p.oldest_age_s() for p in self.parts), default=0.0)

    def heartbeat(self, worker_id, stats=None):
        self.parts[0].heartbeat(worker_id, stats)

    def clear_heartbeat(self, worker_id):
        self.parts[0].clear_heartbeat(worker_id)

    def live_workers(self, ttl_s=3.0):
        out: Dict[str, Dict] = {}
        for p in self.parts:
            out.update(p.live_workers(ttl_s))
        return out

    def close(self):
        for p in self.parts:
            close = getattr(p, "close", None)
            if close is not None:
                close()


def partitioned_spec(spec: str, partition: int) -> str:
    """``spec`` narrowed to one partition's sub-stream — the string a
    fleet supervisor hands each consumer process (query params carried by
    the base spec, e.g. ``claim_idle_ms``, ride along)."""
    base, _, query = spec.partition("?")
    keep = [kv for kv in query.split("&")
            if kv and kv.split("=", 1)[0] not in ("partition", "partitions")]
    keep.append(f"partition={int(partition)}")
    return base + "?" + "&".join(keep)


def make_broker(spec: str = "memory://serving_stream") -> Broker:
    """Broker factory: ``memory://<stream>``, ``file://<dir>``, or
    ``redis://host:port/<stream>`` (stream defaults to serving_stream).

    An optional ``?k=v`` query configures the transport — it rides the
    spec string so every fleet process (supervisor, spawned workers,
    frontends) that shares the spec shares the configuration:

    * ``claim_idle_s`` (memory/file) / ``claim_idle_ms`` (redis) — the
      idle threshold past which a live consumer steals a dead consumer's
      pending entries;
    * ``partition=k`` — open partition ``k``'s keyed sub-stream (memory:
      ``<name>.p<k>``; file: ``<dir>/p<k>``; redis: ``<stream>.p<k>`` —
      the same naming on all three transports, so tests move freely
      between them). This is the consumer-side handle: a fleet trainer
      claims only its shard;
    * ``partitions=N`` — the producer-side fan-out: a
      :class:`PartitionedBroker` routing each record onto one of the N
      sub-streams by its stamped key (id hash for keyless payloads).

    ``partition`` and ``partitions`` are mutually exclusive (a handle is
    either one shard or the router over all of them)."""
    spec_full = spec
    spec, _, query = spec.partition("?")
    params: Dict[str, str] = {}
    if query:
        for kv in query.split("&"):
            k, _, v = kv.partition("=")
            if k:
                params[k] = v

    for prefix in ("memory://", "file://", "redis://"):
        if spec.startswith(prefix):
            transport = prefix[:-3]
            break
    else:
        raise ValueError(f"unknown broker spec {spec} "
                         "(memory:// file:// or redis://)")

    def _int_param(name: str, minimum: int) -> Optional[int]:
        raw = params.get(name)
        if raw is None:
            return None
        try:
            v = int(raw)
        except ValueError:
            raise ValueError(
                f"{transport} broker: ?{name}={raw!r} is not an integer "
                f"(spec {spec_full!r})") from None
        if v < minimum:
            raise ValueError(
                f"{transport} broker: ?{name}={v} must be >= {minimum} "
                f"(spec {spec_full!r})")
        return v

    partition = _int_param("partition", 0)
    partitions = _int_param("partitions", 1)
    if partition is not None and partitions is not None:
        raise ValueError(
            f"{transport} broker: ?partition= (one shard) and "
            f"?partitions= (the fan-out router) are mutually exclusive "
            f"(spec {spec_full!r})")
    if partitions is not None:
        b: Broker = PartitionedBroker(
            [make_broker(partitioned_spec(spec_full, k))
             for k in range(partitions)])
        b.spec = spec_full
        return b

    if transport == "memory":
        name = spec[len("memory://"):] or "serving_stream"
        if partition is not None:
            name = f"{name}.p{partition}"
        b = InMemoryBroker.get(name)
        if "claim_idle_s" in params:
            b.claim_idle_s = float(params["claim_idle_s"])
        b.spec = spec_full
        return b
    if transport == "file":
        root = spec[len("file://"):]
        if partition is not None:
            root = os.path.join(root, f"p{partition}")
        b = FileBroker(
            root, claim_idle_s=float(params.get("claim_idle_s", 30.0)),
            fsync=params.get("fsync", "1") not in ("0", "false", "no"))
        b.spec = spec_full
        return b
    rest = spec[len("redis://"):]
    hostport, _, stream = rest.partition("/")
    host, _, port = hostport.partition(":")
    stream = stream or "serving_stream"
    if partition is not None:
        stream = f"{stream}.p{partition}"
    b = RedisBroker(host or "127.0.0.1", int(port or 6379), stream,
                    claim_idle_ms=int(
                        params.get("claim_idle_ms", 30000)))
    b.spec = spec_full
    return b
