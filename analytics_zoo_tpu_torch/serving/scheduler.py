"""Continuous, deadline-aware batch forming + multi-model multiplexing.

The original engine ran the reference's fixed discipline — claim up to
``batch_size`` records, waiting at most ``batch_timeout_ms`` — which either
idles the chip (the timeout fires on shallow queues) or lets one model's
backlog monopolize the device. This module is the serving twin of the comms
plane's fill-the-device-by-hiding-latency discipline (Horovod-style overlap,
PAPERS.md arXiv:1802.05799): never let the chip wait on batch formation, and
never let batch formation wait on a single model's queue.

Two pieces:

* :class:`ContinuousScheduler` — per-(model, input-signature) admission
  queues ordered earliest-deadline-first (the absolute-deadline stamps
  are the priority), with a global ``max_inflight`` bound that backpressures
  the broker claim pump so admitted memory stays bounded ahead of the
  deadline shedder. A queue becomes *ripe* (dispatchable) when its shape
  bucket is full, when its head request's slack drops to ``slack_s``
  (dispatch-now: waiting longer risks the deadline), when arrivals pause for
  one forming quantum (the chip must not idle on a queue nobody is still
  feeding), or when the engine is draining. Among ripe queues, the earliest
  head deadline wins (depth breaks ties) — a slow model's backlog cannot
  starve a fast model past its deadline, because the fast model's requests
  ripen and outrank on slack.

* :class:`ModelMultiplexer` — N loaded models on ONE chip set, each with its
  own circuit breaker and precompile example. Model switch costs no
  compiles: every model's shape buckets ride the compile plane's warmed
  executable cache, and hot-reload swaps weights without
  touching executables — so the scheduler is free to interleave (model,
  bucket) dispatches purely by deadline slack and queue depth.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["ServingRequest", "ContinuousScheduler", "ModelMultiplexer",
           "request_signature"]

_INF = float("inf")


def request_signature(data) -> Tuple:
    """Hashable shape/dtype signature of one decoded (densified) record —
    requests batch together only when stacking them is well-defined. Named
    records keep key ORDER (the engine feeds tensors positionally in the
    record's own key order, reference LinkedHashMap semantics)."""
    if isinstance(data, dict):
        return ("dict",) + tuple(
            (k, tuple(v.shape), str(v.dtype)) for k, v in data.items())
    if isinstance(data, (list, tuple)):
        return ("list",) + tuple(
            (tuple(v.shape), str(v.dtype)) for v in data)
    return ("arr", tuple(data.shape), str(data.dtype))


class ServingRequest:
    """One admitted record: decoded, densified, deadline-stamped, routed."""

    __slots__ = ("item_id", "data", "meta", "deadline", "model", "sig",
                 "trace", "t_admit", "shm_refs")

    def __init__(self, item_id: str, data, meta: Dict, model: str,
                 shm_refs=()):
        self.item_id = item_id
        self.data = data
        self.meta = meta
        d = meta.get("deadline")
        self.deadline = float(d) if d is not None else None
        self.model = model
        self.sig = request_signature(data)
        self.trace = meta.get("trace")
        self.t_admit = time.time()
        # shm object plane: slab descriptors this request's data is mapped
        # from — the engine done()s them strictly after the item's answer
        # is published (empty for inline/legacy payloads)
        self.shm_refs = tuple(shm_refs)

    @property
    def expired(self) -> bool:
        return self.deadline is not None and time.time() > self.deadline


class _Q:
    """One (model, signature) admission queue: an EDF heap plus the arrival
    bookkeeping the ripeness rules read."""

    __slots__ = ("heap", "last_arrival", "arrivals")

    def __init__(self):
        self.heap: List[Tuple[float, int, ServingRequest]] = []
        self.last_arrival = 0.0
        self.arrivals = 0

    def push(self, seq: int, req: ServingRequest, now: float):
        heapq.heappush(self.heap,
                       (req.deadline if req.deadline is not None else _INF,
                        seq, req))
        self.last_arrival = now
        self.arrivals += 1

    @property
    def head_deadline(self) -> float:
        return self.heap[0][0]

    def __len__(self):
        return len(self.heap)


class ContinuousScheduler:
    """EDF batch former over per-(model, signature) admission queues.

    Thread contract: the claim pump calls :meth:`offer` (blocking while the
    ``max_inflight`` bound is hit), dispatch workers call :meth:`next_batch`
    and pair every returned request with exactly one :meth:`done`.
    :meth:`finish_input` (drain: the pump will offer no more) lets
    ``next_batch`` return ``None`` once the queues empty; :meth:`close`
    (stop) wakes and releases everyone immediately.
    """

    def __init__(self, max_inflight: int = 256, slack_s: float = 0.005,
                 form_s: float = 0.002,
                 on_inflight: Optional[Callable[[int], None]] = None,
                 on_depth: Optional[Callable[[str, int], None]] = None):
        self.max_inflight = max(1, int(max_inflight))
        self.slack_s = max(0.0, float(slack_s))
        self.form_s = max(1e-4, float(form_s))
        self._cv = threading.Condition()
        self._queues: Dict[Tuple[str, Tuple], _Q] = {}
        self._inflight = 0          # admitted: queued + mid-dispatch
        self._seq = itertools.count()
        self._closed = False
        self._no_more = False
        # obs hooks (engine wires gauges); called OUTSIDE the lock
        self._on_inflight = on_inflight
        self._on_depth = on_depth

    # --- intake (claim pump) ------------------------------------------------
    def offer(self, req: ServingRequest) -> bool:
        """Admit one request, blocking while the inflight bound is hit —
        the backpressure that stops the claim pump (and with the Redis
        broker, leaves the backlog on the stream where the PEL keeps it
        at-least-once). False when the scheduler was closed meanwhile."""
        with self._cv:
            while self._inflight >= self.max_inflight and not self._closed:
                self._cv.wait(0.05)
            if self._closed:
                return False
            q = self._queues.get((req.model, req.sig))
            if q is None:
                q = self._queues.setdefault((req.model, req.sig), _Q())
            q.push(next(self._seq), req, time.time())
            self._inflight += 1
            inflight, depth = self._inflight, self._model_depth(req.model)
            self._cv.notify_all()
        if self._on_inflight:
            self._on_inflight(inflight)
        if self._on_depth:
            self._on_depth(req.model, depth)
        return True

    def offer_many(self, reqs: List[ServingRequest]) -> int:
        """Admit a whole claimed batch under one lock acquisition per
        inflight-window — the pump's hot path (per-record :meth:`offer`
        costs a lock round-trip, a ``notify_all`` and two gauge pushes
        EACH, which closed-loop saturation measures as real throughput).
        Blocks at the bound like :meth:`offer`; returns how many were
        admitted (short only when closed mid-way)."""
        admitted = 0
        while admitted < len(reqs):
            with self._cv:
                while self._inflight >= self.max_inflight \
                        and not self._closed:
                    self._cv.wait(0.05)
                if self._closed:
                    return admitted
                now = time.time()
                room = self.max_inflight - self._inflight
                chunk = reqs[admitted:admitted + room]
                for req in chunk:
                    q = self._queues.get((req.model, req.sig))
                    if q is None:
                        q = self._queues.setdefault(
                            (req.model, req.sig), _Q())
                    q.push(next(self._seq), req, now)
                self._inflight += len(chunk)
                inflight = self._inflight
                depths = {m: self._model_depth(m)
                          for m in {r.model for r in chunk}}
                self._cv.notify_all()
            if self._on_inflight:
                self._on_inflight(inflight)
            if self._on_depth:
                for m, d in depths.items():
                    self._on_depth(m, d)
            admitted += len(chunk)
        return admitted

    def admit(self, n: int = 1):
        """Account ``n`` requests admitted OUTSIDE the queues (the legacy
        fixed policy dispatches claim-order batches directly but still
        pairs each request with one :meth:`done`)."""
        with self._cv:
            self._inflight += n
            inflight = self._inflight
        if self._on_inflight:
            self._on_inflight(inflight)

    def done(self, n: int = 1):
        """A dispatch finished (or shed) ``n`` admitted requests."""
        with self._cv:
            self._inflight -= n
            inflight = self._inflight
            self._cv.notify_all()
        if self._on_inflight:
            self._on_inflight(inflight)

    # --- lifecycle ----------------------------------------------------------
    def finish_input(self):
        with self._cv:
            self._no_more = True
            self._cv.notify_all()

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    # --- introspection ------------------------------------------------------
    def _model_depth(self, model: str) -> int:
        return sum(len(q) for (m, _), q in self._queues.items()
                   if m == model)

    def depths(self) -> Dict[str, int]:
        with self._cv:
            out: Dict[str, int] = {}
            for (m, _), q in self._queues.items():
                out[m] = out.get(m, 0) + len(q)
            return out

    @property
    def inflight(self) -> int:
        with self._cv:
            return self._inflight

    def queued(self) -> int:
        with self._cv:
            return sum(len(q) for q in self._queues.values())

    def oldest_wait_s(self) -> float:
        """Seconds the longest-waiting admitted request has sat queued —
        the worker-local half of the fleet's queue-age signal (the broker
        half is ``oldest_age_s``: entries not yet claimed)."""
        with self._cv:
            t = min((req.t_admit for q in self._queues.values()
                     for _, _, req in q.heap), default=None)
        return 0.0 if t is None else max(0.0, time.time() - t)

    # --- batch forming (dispatch workers) -----------------------------------
    def next_batch(self, cap_fn: Callable[[str], int], idle_wait: float = 0.05
                   ) -> Optional[Tuple[str, List[ServingRequest]]]:
        """Block until a (model, batch) is dispatchable; return
        ``(model_name, requests)`` with all requests sharing one input
        signature, in EDF order. ``None`` means stop (closed, or draining
        with nothing left). ``cap_fn(model)`` is the shape-bucket cap."""
        while True:
            with self._cv:
                if self._closed:
                    return None
                now = time.time()
                best_key = None
                best_rank = (_INF, 0)
                soonest = _INF
                for key, q in self._queues.items():
                    if not len(q):
                        continue
                    head = q.head_deadline
                    cap = max(1, cap_fn(key[0]))
                    ripe_at = min(
                        # slack gate: must dispatch before the head misses
                        head - self.slack_s if head != _INF else _INF,
                        # forming gate: arrivals paused for one quantum —
                        # nobody is still feeding this queue, don't idle
                        q.last_arrival + self.form_s)
                    if len(q) >= cap or self._no_more or ripe_at <= now:
                        rank = (head, -len(q))
                        if best_key is None or rank < best_rank:
                            best_key, best_rank = key, rank
                    else:
                        soonest = min(soonest, ripe_at)
                if best_key is not None:
                    return self._take(best_key,
                                      max(1, cap_fn(best_key[0])))
                if soonest != _INF:
                    self._cv.wait(min(max(soonest - now, 1e-4), idle_wait))
                    continue
                # every queue empty
                if self._no_more:
                    return None
                self._cv.wait(idle_wait)

    def _take(self, key, cap: int):
        q = self._queues[key]
        reqs = [heapq.heappop(q.heap)[2] for _ in range(min(len(q), cap))]
        depth = self._model_depth(key[0])
        if self._on_depth:
            # inside the lock is fine: gauge .set is a micro-lock
            self._on_depth(key[0], depth)
        return key[0], reqs


class _ModelEntry:
    __slots__ = ("name", "model", "breaker", "example", "records_out",
                 "batches")

    def __init__(self, name, model, breaker, example):
        self.name = name
        self.model = model
        self.breaker = breaker
        self.example = example
        self.records_out = 0
        self.batches = 0


class ModelMultiplexer:
    """N named models co-served on one chip set.

    Each entry keeps its own :class:`~..resilience.retry.CircuitBreaker`
    (a wedged model sheds ITS requests fast without opening the circuit on
    its healthy neighbours) and an optional precompile ``example`` the
    engine warms at :meth:`ClusterServing.start`. The first added model is
    the default route for requests that carry no ``model`` meta."""

    def __init__(self, breaker_threshold: int = 5,
                 breaker_cooldown_s: float = 30.0):
        from ..resilience.retry import CircuitBreaker
        self._CircuitBreaker = CircuitBreaker
        self._threshold = breaker_threshold
        self._cooldown = breaker_cooldown_s
        self._entries: Dict[str, _ModelEntry] = {}
        self._default: Optional[str] = None
        self._lock = threading.Lock()

    def add_model(self, name: str, model, example=None) -> "ModelMultiplexer":
        with self._lock:
            entry = self._entries.get(name)
            if entry is not None:
                entry.model = model
                if example is not None:
                    entry.example = example
            else:
                self._entries[name] = _ModelEntry(
                    name, model,
                    self._CircuitBreaker(threshold=self._threshold,
                                         cooldown_s=self._cooldown,
                                         name=f"serving.{name}"),
                    example)
                if self._default is None:
                    self._default = name
        return self

    @property
    def default_name(self) -> str:
        if self._default is None:
            raise RuntimeError("ModelMultiplexer has no models; add_model "
                               "first")
        return self._default

    @property
    def default(self) -> _ModelEntry:
        return self._entries[self.default_name]

    def get(self, name: str) -> Optional[_ModelEntry]:
        return self._entries.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    def entries(self) -> List[_ModelEntry]:
        with self._lock:
            return list(self._entries.values())

    def __len__(self):
        return len(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def bucket_cap(self, name: str, batch_size: int) -> int:
        """Shape-bucket cap for one model's batches: the configured
        ``batch_size``, device-rounded by the model's own bucket table
        when it has one (plain ``predict``-only objects don't)."""
        entry = self._entries.get(name)
        if entry is None:
            return batch_size
        buckets = getattr(entry.model, "buckets", None)
        if not buckets:
            return batch_size
        from ..pipeline.inference.inference_model import _bucket
        return _bucket(batch_size, buckets)

    def compile_stats(self) -> Dict:
        """Per-model warmed-executable signature counts. Executables live
        in the ONE process-wide compile plane (separate per-model compile
        counters don't exist by design — sharing is the point), so the
        per-model zero-churn receipt is this count staying flat while
        traffic interleaves, read next to the plane's global ``compiles``."""
        out = {}
        for entry in self.entries():
            cache = getattr(entry.model, "_cache", None)
            if cache is not None:
                out[entry.name] = {"warmed_signatures": len(cache)}
        return out

    def snapshot(self) -> Dict:
        return {name: {"records_out": e.records_out, "batches": e.batches,
                       "breaker": e.breaker.snapshot()}
                for name, e in ((n, self._entries[n]) for n in self.names())}
