"""Cluster Serving engine — queue -> continuous batch former -> TPU -> results.

The reference pipeline (SURVEY.md §3.5) is Redis stream -> Flink
FlinkRedisSource (xreadGroup, engine/FlinkRedisSource.scala:78-104) ->
FlinkInference -> ClusterServingInference batching
(engine/ClusterServingInference.scala:36-152) -> InferenceModel.doPredict ->
FlinkRedisSink. The TPU-native pipeline drops Flink entirely, and since the
serving-scale arc also drops the reference's fixed claim loop: a **claim
pump** streams records off the broker, decodes and sheds them, and routes
them into per-(model, signature) admission queues; dispatch workers pull
EDF-formed batches from the :class:`~.scheduler.ContinuousScheduler` (bucket
full, or head slack at the dispatch-now threshold — no fixed
``batch_timeout_ms`` stall) and run whichever model the batch belongs to on
the shared chip set via the :class:`~.scheduler.ModelMultiplexer`. Per-stage
latency is tracked like the reference's Timer (serving/engine/Timer.scala:102).

``policy="fixed"`` keeps the original claim-up-to-batch_size discipline as a
baseline (bench_serving_scale A/Bs the two on the same model).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..common import knobs
from ..obs import trace as _trace
from ..obs.registry import REGISTRY, InstancedEvents
from ..resilience import faults as _faults
from ..resilience.stats import STATS
from ..shm import arena_for_spec as _shm_arena_for_spec
from ..shm import peek_refs as _shm_peek_refs
from .codecs import decode_payload, decode_ref, densify, encode_payload
from .queue_api import Broker, make_broker
from .scheduler import ContinuousScheduler, ModelMultiplexer, ServingRequest

logger = logging.getLogger("analytics_zoo_tpu_torch")


class Timer:
    """(reference: serving/engine/Timer.scala) — n-record latency stats."""

    def __init__(self):
        self._lock = threading.Lock()
        self.stats: Dict[str, List[float]] = defaultdict(list)

    def time(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *a):
                dt = time.perf_counter() - self.t0
                with timer._lock:
                    timer.stats[name].append(dt)

        return _Ctx()

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        with self._lock:
            items = [(k, list(v)) for k, v in self.stats.items()]
        for name, vals in items:
            arr = np.asarray(vals)
            out[name] = {"count": len(arr), "mean_ms": float(arr.mean() * 1e3),
                         "p50_ms": float(np.percentile(arr, 50) * 1e3),
                         "p95_ms": float(np.percentile(arr, 95) * 1e3),
                         "p99_ms": float(np.percentile(arr, 99) * 1e3)}
        return out

    def reset(self):
        """Drop accumulated samples (e.g. after warmup, so reported
        percentiles are steady-state rather than compile-tainted)."""
        with self._lock:
            self.stats = defaultdict(list)


class ClusterServing:
    """(reference entry: serving/ClusterServing.scala:69; config via
    utils/ClusterServingHelper.scala)

    ``model`` may be a single model object (wrapped as the multiplexer's
    ``default``) or a :class:`~.scheduler.ModelMultiplexer` co-serving
    several models on one chip set. Scheduler knobs come from
    ``common/knobs.py`` (``ZOO_SERVING_BATCH_SIZE`` /
    ``ZOO_SERVING_BATCH_TIMEOUT_MS`` / ``ZOO_SERVING_MAX_INFLIGHT`` /
    ``ZOO_SERVING_SLACK_MS``) when the constructor arguments are left None.
    """

    def __init__(self, model,
                 queue: str = "memory://serving_stream",
                 batch_size: Optional[int] = None,
                 batch_timeout_ms: Optional[float] = None,
                 model_parallelism: int = 1,
                 breaker_threshold: int = 5,
                 breaker_cooldown_s: float = 30.0,
                 policy: str = "continuous",
                 max_inflight: Optional[int] = None,
                 slack_ms: Optional[float] = None,
                 form_ms: float = 2.0,
                 worker_id: Optional[str] = None,
                 heartbeat_s: Optional[float] = None):
        if isinstance(model, ModelMultiplexer):
            self.mux = model
        else:
            self.mux = ModelMultiplexer(
                breaker_threshold=breaker_threshold,
                breaker_cooldown_s=breaker_cooldown_s).add_model(
                "default", model)
        if len(self.mux) == 0:
            raise ValueError("ModelMultiplexer has no models; add_model "
                             "before constructing ClusterServing")
        self.broker: Broker = make_broker(queue) if isinstance(queue, str) \
            else queue
        # shm object plane: on a local, ZOO_SHM-enabled stream request
        # payloads may arrive as descriptor frames — map them from the
        # spec-derived arena every sibling process agrees on (None keeps
        # today's inline wire, byte for byte)
        self._arena = _shm_arena_for_spec(
            queue if isinstance(queue, str)
            else getattr(self.broker, "spec", None))
        self.batch_size = int(knobs.get("ZOO_SERVING_BATCH_SIZE")
                              if batch_size is None else batch_size)
        self.batch_timeout = float(
            knobs.get("ZOO_SERVING_BATCH_TIMEOUT_MS")
            if batch_timeout_ms is None else batch_timeout_ms) / 1e3
        if policy not in ("continuous", "fixed"):
            raise ValueError(f"policy must be 'continuous' or 'fixed', "
                             f"got {policy!r}")
        self.policy = policy
        self.max_inflight = int(knobs.get("ZOO_SERVING_MAX_INFLIGHT")
                                if max_inflight is None else max_inflight)
        self.slack_s = float(knobs.get("ZOO_SERVING_SLACK_MS")
                             if slack_ms is None else slack_ms) / 1e3
        self.form_s = form_ms / 1e3
        # modelParallelism in the reference = number of model copies
        # (ClusterServing.scala:60); XLA executables are reentrant so this is
        # the number of dispatch threads sharing the chip set.
        self.num_workers = model_parallelism
        # fleet membership: with a worker_id, a heartbeat thread publishes
        # liveness + occupancy stats through the broker every heartbeat_s
        # (the autoscaler's signal, and /readyz's live-worker count)
        self.worker_id = worker_id
        self.heartbeat_s = float(knobs.get("ZOO_FLEET_HEARTBEAT_S")
                                 if heartbeat_s is None else heartbeat_s)
        self._hb_thread: Optional[threading.Thread] = None
        self.timer = Timer()
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._pump_thread: Optional[threading.Thread] = None
        self._threads: List[threading.Thread] = []
        self.records_out = 0
        # overload counters live in the unified metrics registry (obs
        # plane): one family labeled per engine instance, so metrics()'s
        # dict stays a per-engine view (starting at 0) while /metrics.prom
        # exposes the same series process-wide
        self._res_events = InstancedEvents(
            REGISTRY.counter(
                "zoo_serving_engine_events_total",
                "serving-engine overload events: expired/open-circuit "
                "sheds, batch failures, decode errors, unknown-model "
                "rejects",
                labelnames=("inst", "event")),
            ("shed_expired", "shed_open", "batch_failures",
             "decode_errors", "unknown_model"))
        self._res_children = self._res_events.children
        inst = self._res_events.inst
        # scheduler observability: admitted-inflight / per-model queue-depth
        # gauges pushed from the scheduler hooks, per-model batch/record
        # counters and busy-seconds bumped at dispatch — the serving face
        # of chip occupancy, scraped next to the span timeline
        self._g_inflight = REGISTRY.gauge(
            "zoo_serving_sched_inflight",
            "requests admitted into the continuous former (queued + "
            "mid-dispatch), bounded by ZOO_SERVING_MAX_INFLIGHT",
            labelnames=("inst",)).labels(inst=inst)
        self._depth_family = REGISTRY.gauge(
            "zoo_serving_sched_queue_depth",
            "admission-queue depth per co-served model",
            labelnames=("inst", "model"))
        self._batches_family = REGISTRY.counter(
            "zoo_serving_sched_batches_total",
            "batches dispatched per co-served model",
            labelnames=("inst", "model"))
        self._records_family = REGISTRY.counter(
            "zoo_serving_sched_records_total",
            "records served per co-served model",
            labelnames=("inst", "model"))
        self._c_busy = REGISTRY.counter(
            "zoo_serving_sched_busy_seconds_total",
            "wall seconds the dispatch workers spent in model execution "
            "(chip occupancy numerator)",
            labelnames=("inst",)).labels(inst=inst)
        self._inst = inst
        self._depth_children: Dict[str, object] = {}
        self._batch_children: Dict[str, object] = {}
        self._record_children: Dict[str, object] = {}
        self.sched = ContinuousScheduler(
            max_inflight=self.max_inflight, slack_s=self.slack_s,
            form_s=self.form_s,
            on_inflight=self._g_inflight.set,
            on_depth=self._set_depth)

    # --- per-model obs children --------------------------------------------
    def _model_child(self, family, cache: Dict, model: str):
        child = cache.get(model)
        if child is None:
            child = family.labels(inst=self._inst, model=model)
            cache[model] = child
        return child

    def _set_depth(self, model: str, depth: int):
        self._model_child(self._depth_family, self._depth_children,
                          model).set(depth)

    def _count_batch(self, model: str, n_records: int):
        self._model_child(self._batches_family, self._batch_children,
                          model).inc()
        self._model_child(self._records_family, self._record_children,
                          model).inc(n_records)

    def _count(self, key: str, n: int = 1):
        self._res_children[key].inc(n)

    def _close_series(self):
        """Drop this instance's registry series from the exposition —
        rebuilt engines must not leak dead-uuid series into every scrape.
        Cached children keep serving metrics()'s view."""
        self._res_events.close()
        for fam, children in (
                (self._depth_family, self._depth_children),
                (self._batches_family, self._batch_children),
                (self._records_family, self._record_children)):
            for model in children:
                fam.remove(inst=self._inst, model=model)
        REGISTRY.gauge("zoo_serving_sched_inflight",
                       labelnames=("inst",)).remove(inst=self._inst)
        REGISTRY.counter("zoo_serving_sched_busy_seconds_total",
                         labelnames=("inst",)).remove(inst=self._inst)

    # --- single-model compatibility surface --------------------------------
    @property
    def model(self):
        """The default model (single-model constructor compatibility)."""
        return self.mux.default.model

    @property
    def breaker(self):
        """The default model's circuit breaker (readiness probes and the
        legacy metrics key read this one; per-model breakers are in
        ``metrics()["scheduler"]["per_model"]``)."""
        return self.mux.default.breaker

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    # --- claim pump (continuous policy) -------------------------------------
    def _pump(self):
        """Stream records off the broker into the admission queues. The
        claim timeout is only an idle poll — batch formation happens in the
        scheduler, so the chip never waits on this thread's timeout."""
        try:
            while not self._stop.is_set():
                with self.timer.time("claim"):
                    batch = self.broker.claim_batch(
                        max(1, self.max_inflight),
                        max(self.batch_timeout, 0.001))
                if batch:
                    self._route_claim(batch)
                elif self._draining.is_set():
                    if self._safe_pending() in (0, None):
                        return      # drained: broker empty, stop claiming
        finally:
            self.sched.finish_input()

    def _refs_done(self, refs):
        """Mark slab descriptors consumed — called strictly AFTER the
        item's answer was published (put_result is serving's ack): a PEL
        reclaim of an unanswered item must re-resolve the same
        generation."""
        if not refs or self._arena is None:
            return
        for r in refs:
            try:
                self._arena.done(r)
            except Exception as e:  # noqa: BLE001 — freeing must not
                # fail serving; a sweep/gc reclaims whatever this missed
                logger.warning("shm done failed for %s: %s", r, e)

    def _route_claim(self, batch):
        """Decode + shed + route one claimed batch. Every claimed item gets
        a result — error payloads for shed/failed ones — so frontend fetches
        never wait out their full timeout on a request the engine already
        gave up on."""
        prologue = self._decode_prologue(batch)
        if prologue is None:
            return
        reqs, _batch_tok = prologue
        admitted = self.sched.offer_many(reqs)
        for req in reqs[admitted:]:
            # closed mid-offer (stop during shutdown): answer rather
            # than orphan — at-least-once brokers would redeliver, the
            # in-memory one would hang the client to its timeout
            self.broker.put_result(req.item_id, encode_payload(
                np.zeros(0), meta={"error": "serving stopped"}))
            self._refs_done(req.shm_refs)

    def _decode_and_shed(self, batch):
        """Per-item decode (one malformed record fails itself, not its
        batchmates) + deadline shedding: a request whose ``meta.deadline``
        (absolute epoch seconds, stamped at admission) has passed is
        answered with an error payload and NEVER reaches the device. Routes
        the rest by ``meta.model`` (default: the multiplexer's first model).
        Returns ``(requests, shed_replies, trace_token)`` — shed replies
        are (item_id, payload) pairs the CALLER publishes after recording
        the decode/batch spans (publishing here would let a fast client
        observe every result before the shed-all batch span exists — the
        span-vs-result race the streaming-cadence tests caught); the token
        is the first decoded item's (shed included)."""
        reqs: List[ServingRequest] = []
        shed: List[Tuple[str, bytes, tuple]] = []
        batch_tok = None
        default_model = self.mux.default_name
        with self.timer.time("decode"):
            _faults.fire("serving.decode")  # chaos hook (whole batch)
            now = time.time()
            for item_id, payload in batch:
                refs: tuple = ()
                try:
                    data, meta, item_refs = decode_ref(
                        payload, arena=self._arena)
                    refs = tuple(item_refs)
                    if batch_tok is None:
                        batch_tok = meta.get("trace")
                    # deadline parse is per-item too: a client that sends
                    # meta={"deadline": "soon"} must fail itself, not
                    # feed the breaker and fail its batchmates
                    deadline = meta.get("deadline")
                    expired = (deadline is not None
                               and now > float(deadline))
                except Exception as e:      # noqa: BLE001 — bad record
                    self._count("decode_errors")
                    self.broker.put_result(item_id, encode_payload(
                        np.zeros(0), meta={"error": f"bad payload: {e}"}))
                    self._refs_done(refs)
                    continue
                if expired:
                    self._count("shed_expired")
                    STATS.add("serving.shed_expired")
                    shed.append((item_id, encode_payload(
                        np.zeros(0),
                        meta={"error": "deadline exceeded",
                              "shed": "expired"}), refs))
                    continue
                model = meta.get("model") or default_model
                if model not in self.mux:
                    self._count("unknown_model")
                    self.broker.put_result(item_id, encode_payload(
                        np.zeros(0), meta={
                            "error": f"unknown model {model!r} (serving: "
                                     f"{sorted(self.mux.names())})"}))
                    self._refs_done(refs)
                    continue
                # sparse ingress (reference: http/domains.scala:100)
                # densifies at admission — the TPU executable wants static
                # dense. Per-item like the decode: a record that decodes
                # but won't densify (out-of-range sparse indices) fails
                # itself, not its batchmates
                try:
                    reqs.append(ServingRequest(item_id, densify(data),
                                               meta, model,
                                               shm_refs=refs))
                except Exception as e:      # noqa: BLE001 — bad record
                    self._count("decode_errors")
                    self.broker.put_result(item_id, encode_payload(
                        np.zeros(0), meta={"error": f"bad payload: {e}"}))
                    self._refs_done(refs)
        return reqs, shed, batch_tok

    def _publish_shed(self, shed):
        for item_id, payload, refs in shed:
            self.broker.put_result(item_id, payload)
            self._refs_done(refs)

    def _decode_prologue(self, batch):
        """The shared claim prologue for BOTH claim paths (continuous
        ``_route_claim`` and legacy ``_handle_fixed``): decode + shed with
        whole-stage fault answering, the ``serving.decode`` span, and —
        for a fully-expired claim — a shed-all ``serving.batch`` span
        recorded BEFORE the shed answers publish (a fast client that saw
        every result can rely on the span existing — exactly the overload
        case the Perfetto timeline should explain). Returns
        ``(requests, batch_token)``, or None when the claim was fully
        answered here."""
        t_dec = time.perf_counter()
        try:
            reqs, shed, batch_tok = self._decode_and_shed(batch)
        except Exception as e:  # noqa: BLE001 — injected/decode-stage fault
            self.mux.default.breaker.record_failure()
            self._count("batch_failures")
            logger.exception("serving decode stage failed: %s", e)
            for item_id, payload in batch:
                self.broker.put_result(item_id, encode_payload(
                    np.zeros(0), meta={"error": str(e)}))
                # the per-item refs were lost with the stage: peek the
                # descriptors off the raw payload (no checkout) so the
                # answered items' slabs still free
                try:
                    self._refs_done(_shm_peek_refs(payload))
                except Exception as pe:  # noqa: BLE001 — malformed frame
                    logger.warning("shm peek failed: %s", pe)
            return None
        _trace.record_span("serving.decode", t_dec, time.perf_counter(),
                           parent=batch_tok, n=len(batch))
        if not reqs:
            if shed:
                t1 = time.perf_counter()
                _trace.record_span("serving.batch", t1, t1,
                                   parent=batch_tok, n=0, shed=len(shed))
            self._publish_shed(shed)
            return None
        self._publish_shed(shed)
        return reqs, batch_tok

    # --- dispatch workers ----------------------------------------------------
    def _cap_for(self, model: str) -> int:
        return self.mux.bucket_cap(model, self.batch_size)

    def _dispatch_loop(self):
        while not self._stop.is_set():
            nb = self.sched.next_batch(self._cap_for)
            if nb is None:
                return      # stopped, or drained dry
            model_name, reqs = nb
            self._dispatch_batch(model_name, reqs)

    def _dispatch_batch(self, model_name: str, reqs):
        """Shed-recheck + breaker-gate + run one formed batch. EVERY
        request in ``reqs`` is released from the inflight ledger in the
        one outer ``finally`` — a broker that throws mid-answer (even on
        the shed or open-circuit paths) or a BaseException worker death
        must not leak ``max_inflight`` slots and wedge the claim pump;
        results never published stay claimed for XAUTOCLAIM."""
        try:
            self._dispatch_batch_inner(model_name, reqs)
        finally:
            self.sched.done(len(reqs))

    def _dispatch_batch_inner(self, model_name: str, reqs):
        entry = self.mux.get(model_name)
        batch_tok = next((r.trace for r in reqs if r.trace), None)
        # requests can expire while queued: shed them at the moment of
        # dispatch too, so the device never computes an answer nobody is
        # waiting for
        now = time.time()
        live = []
        n_shed = 0
        for r in reqs:
            if r.deadline is not None and now > r.deadline:
                n_shed += 1
                self._count("shed_expired")
                STATS.add("serving.shed_expired")
                self.broker.put_result(r.item_id, encode_payload(
                    np.zeros(0), meta={"error": "deadline exceeded",
                                       "shed": "expired"}))
                self._refs_done(r.shm_refs)
            else:
                live.append(r)
        if not live:
            # shed-all batch: still a batch span, so the timeline shows
            # the overload instead of a silent gap
            t1 = time.perf_counter()
            _trace.record_span("serving.batch", t1, t1, parent=batch_tok,
                               n=0, shed=n_shed, model=model_name)
            return
        if not entry.breaker.allow():
            # open circuit: fail fast, the device never sees the batch —
            # per-model, so a wedged neighbour cannot shed this one's
            # traffic
            self._count("shed_open", len(live))
            STATS.add("serving.shed_open", len(live))
            for r in live:
                self.broker.put_result(r.item_id, encode_payload(
                    np.zeros(0), meta={"error": "circuit open",
                                       "shed": "circuit_open"}))
                self._refs_done(r.shm_refs)
            return
        try:
            self._process(entry, live, batch_tok)
            entry.breaker.record_success()
        except Exception as e:  # noqa: BLE001 — serving must not die
            entry.breaker.record_failure()
            self._count("batch_failures")
            logger.exception("serving batch failed (model=%s): %s",
                             model_name, e)
            for r in live:
                self.broker.put_result(r.item_id, encode_payload(
                    np.zeros(0), meta={"error": str(e)}))
                self._refs_done(r.shm_refs)

    def _process(self, entry, live, batch_tok=None):
        arrays = [r.data for r in live]
        tok = batch_tok
        with _trace.span_under(tok, "serving.batch", n=len(live),
                               model=entry.name), \
                self.timer.time("batch"):
            first = arrays[0]
            if isinstance(first, list):
                stacked = [np.stack([a[i] for a in arrays])
                           for i in range(len(first))]
            elif isinstance(first, dict):
                # named multi-tensor records: stack per key (values
                # fetched BY NAME per record) and feed the model
                # positionally in the record's own key order — the
                # reference's LinkedHashMap insertion-order semantics
                # (http/domains.scala:102), i.e. clients declare tensors
                # in the model's input order. The signature routing already
                # groups by key order, so a mismatch here is a bug guard.
                order = tuple(first.keys())
                for a in arrays:
                    if tuple(a.keys()) != order:
                        raise ValueError(
                            f"named-tensor records disagree on key order "
                            f"({order} vs {tuple(a.keys())}); all clients "
                            "of one stream must enqueue tensors in the "
                            "model's input order")
                stacked = [np.stack([a[k] for a in arrays]) for k in order]
            else:
                stacked = np.stack(arrays)
        t_busy = time.perf_counter()
        with _trace.span_under(tok, "serving.dispatch", n=len(live),
                               model=entry.name), \
                self.timer.time("inference"):
            preds = entry.model.predict(stacked)
        self._c_busy.inc(time.perf_counter() - t_busy)
        with _trace.span_under(tok, "serving.respond"), \
                self.timer.time("encode"):
            done_t = time.time()
            multi = isinstance(preds, (list, tuple))
            for i, r in enumerate(live):
                if multi:
                    out = [np.asarray(p[i]) for p in preds]
                else:
                    out = np.asarray(preds[i])
                # t_done lets open-loop load generators account latency at
                # completion time, independent of their fetch scheduling
                self.broker.put_result(r.item_id, encode_payload(
                    out, meta={"t_done": done_t}))
                self._refs_done(r.shm_refs)
        self.records_out += len(live)
        entry.records_out += len(live)
        entry.batches += 1
        self._count_batch(entry.name, len(live))

    # --- legacy fixed policy -------------------------------------------------
    def _worker_fixed(self):
        """The original discipline: claim up to ``batch_size`` (waiting at
        most ``batch_timeout``), then decode/shed/group/dispatch in this
        thread. Kept as the A/B baseline for bench_serving_scale."""
        while not self._stop.is_set():
            with self.timer.time("claim"):
                batch = self.broker.claim_batch(self.batch_size,
                                                self.batch_timeout)
            if not batch:
                if self._draining.is_set():
                    return      # drained: queue empty, stop claiming
                continue
            self._handle_fixed(batch)

    def _handle_fixed(self, batch):
        prologue = self._decode_prologue(batch)
        if prologue is None:
            return
        reqs, _batch_tok = prologue
        # group by (model, signature) — a mixed claim dispatches per group
        groups: Dict = {}
        for r in reqs:
            groups.setdefault((r.model, r.sig), []).append(r)
        for (model_name, _sig), grp in groups.items():
            # the fixed path bypasses the admission queues but keeps the
            # inflight ledger balanced against _dispatch_batch's done()
            self.sched.admit(len(grp))
            self._dispatch_batch(model_name, grp)

    # --- lifecycle ----------------------------------------------------------
    def start(self, example=None):
        """Start the claim pump + dispatch workers. With ``example`` (a
        batch-shaped array, or list of arrays, matching real traffic's
        record shape/dtype), every shape bucket up to ``batch_size`` is
        compiled for the DEFAULT model before serving begins; multiplexed
        models precompile from the ``example`` passed to
        ``ModelMultiplexer.add_model`` — the XLA analogue of the reference
        pre-filling its model-copy queue (InferenceModel.scala:580-626).
        Without warm buckets, partial batches hit cold buckets and compiles
        land in the latency tail."""
        if example is not None:
            self.mux.default.example = example
        with self.timer.time("precompile"):
            for entry in self.mux.entries():
                if entry.example is not None and \
                        hasattr(entry.model, "precompile"):
                    # precompile rounds batch_size up to the bucket
                    # steady-state full batches actually land in
                    entry.model.precompile(entry.example,
                                           max_bucket=self.batch_size)
        if self.policy == "continuous":
            self._pump_thread = threading.Thread(
                target=self._pump, daemon=True, name="serving-pump")
            self._pump_thread.start()
            target = self._dispatch_loop
        else:
            target = self._worker_fixed
        for i in range(self.num_workers):
            t = threading.Thread(target=target, daemon=True,
                                 name=f"serving-worker-{i}")
            t.start()
            self._threads.append(t)
        if self.worker_id:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, daemon=True,
                name="serving-heartbeat")
            self._hb_thread.start()
        return self

    # --- fleet heartbeat -----------------------------------------------------
    def _hb_stats(self) -> Dict:
        return {
            "busy_s": round(float(self._c_busy.value), 6),
            "records_out": self.records_out,
            "inflight": self.sched.inflight,
            "queue_depth": sum(self.sched.depths().values()),
            "oldest_wait_s": round(self.sched.oldest_wait_s(), 4),
            "reclaimed": int(getattr(self.broker, "reclaimed", 0)),
            "draining": self.draining,
        }

    def _heartbeat_loop(self):
        # first beat immediately: the fleet's wait_live() sees a spawned
        # worker as soon as its engine starts, not one period later
        while True:
            try:
                self.broker.heartbeat(self.worker_id, self._hb_stats())
            except Exception as e:  # noqa: BLE001 — liveness is best-effort
                logger.debug("heartbeat publish failed: %s", e)
            if self._stop.wait(self.heartbeat_s):
                return

    def _clear_heartbeat(self):
        if not self.worker_id:
            return
        try:
            self.broker.clear_heartbeat(self.worker_id)
        except Exception as e:  # noqa: BLE001 — broker may already be down
            logger.debug("heartbeat clear failed: %s", e)

    def stop(self):
        self._stop.set()
        self.sched.close()
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=5)
        for t in self._threads:
            t.join(timeout=5)
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2)
        self._clear_heartbeat()
        self._close_series()

    def drain(self, timeout_s: float = 30.0) -> Dict:
        """Graceful shutdown (the SIGTERM path, shared with the training
        supervisor via ``PreemptionWatcher(on_signal=...)``): stop
        *accepting* (the frontend 503s while ``draining``), let the pump
        finish claiming the broker backlog and the workers finish every
        admitted request — in-flight batches AND the queued backlog — then
        stop and return the final metrics snapshot (flushed to the log,
        the Flink analogue of a savepoint-stop)."""
        self._draining.set()
        STATS.add("serving.drains")
        deadline = time.monotonic() + timeout_s
        if self._pump_thread is not None:
            self._pump_thread.join(
                timeout=max(0.0, deadline - time.monotonic()))
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        # short final joins — a wedged worker must not stretch the
        # caller's SIGTERM grace budget by stop()'s 5s-per-thread joins
        self._stop.set()
        self.sched.close()
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=1)
        for t in self._threads:
            t.join(timeout=1)
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2)
        self._clear_heartbeat()
        # drop this instance's registry series like stop() does — a
        # supervisor that drain()s and rebuilds must not accumulate
        # dead-uuid series scrape after scrape; metrics() keeps working
        # off the cached children for the returned snapshot
        self._close_series()
        snap = self.metrics()
        logger.info("serving drained (records_out=%d, pending=%s): %s",
                    self.records_out,
                    self._safe_pending(), snap.get("resilience"))
        return snap

    def _safe_pending(self):
        try:
            return self.broker.pending()
        except Exception:       # noqa: BLE001 — broker may already be down
            return None

    def metrics(self) -> Dict:
        """(reference observability: Flink numRecordsOutPerSecond +
        Timer stats)"""
        # the dict is a view over the registry children (obs plane): same
        # keys and int values as the pre-registry per-engine dict
        res = {k: int(c.value) for k, c in self._res_children.items()}
        res["breaker"] = self.breaker.snapshot()
        res["draining"] = self.draining
        model = self.model
        out = {"records_out": self.records_out,
               # batch-dim sharding spreads every batch over these chips
               # (reference scales with model replicas / Flink parallelism);
               # 1 for eager/call_tf models, which compute host-side
               "devices": getattr(model, "device_count", 1),
               "stages": self.timer.summary(),
               # overload/fault counters: expired requests shed before
               # dispatch, open-circuit sheds, breaker state — the serving
               # face of the resilience plane
               "resilience": res,
               # the continuous former + multiplexer: admitted inflight,
               # per-model queue depth / served counts / breaker state
               "scheduler": {
                   "policy": self.policy,
                   "models": self.mux.names(),
                   "inflight": self.sched.inflight,
                   "max_inflight": self.max_inflight,
                   "slack_ms": round(self.slack_s * 1e3, 3),
                   "queue_depth": self.sched.depths(),
                   "busy_s": round(float(self._c_busy.value), 6),
                   "per_model": self.mux.snapshot()}}
        if hasattr(model, "transfer_stats"):
            # transfer-plane counters: serving-ingress h2d seconds/bytes/
            # MB/s from the sharded device_put path (native/transfer.py)
            snap = model.transfer_stats()
            if snap and snap.get("h2d_n"):
                out["transfer"] = snap
        if hasattr(model, "compile_stats"):
            # compiles vs cache/disk hits — read next to the "precompile"
            # stage timer to see whether warmup paid real compilation or
            # reused executables (in-process or from the disk cache). Empty
            # when this model's plane is off: omit rather than clobber the
            # process-wide counters the HTTP /metrics handler surfaces.
            snap = model.compile_stats()
            if snap:
                out["compile"] = snap
        if hasattr(model, "ckpt_stats"):
            # checkpoint-plane hot-reload counters (weights swapped into
            # the live model; full_reloads > 0 means a structure change
            # forced bucket recompiles). Empty until the first reload.
            snap = model.ckpt_stats()
            if snap:
                out["ckpt"] = snap
        if len(self.mux) > 1:
            # multiplexed: per-model compile counters prove (or disprove)
            # the zero-cross-model-churn contract from the same surface
            snap = self.mux.compile_stats()
            if snap:
                out["compile_per_model"] = snap
        return out

    def reset_metrics(self):
        """Zero the stage timers and record counter — call after warmup so
        ``metrics()`` reports steady-state percentiles."""
        self.timer.reset()
        self.records_out = 0

    def update_model(self, model: InferenceModel, name: Optional[str] = None):
        """Hot-swap a served model (the reference rolls a new model by
        restarting the Flink job, ClusterServingGuide 'model update'; here
        the swap is a reference assignment — in-flight batches finish on
        the old executables, the next dispatch uses the new ones). With
        ``name``, swaps (or adds) that multiplexer entry; default: the
        default model."""
        self.mux.add_model(name or self.mux.default_name, model)
        return self
