"""Streaming at fleet scale — N sharded trainer consumers + per-model
serving adoption (counterpart of ``analytics_zoo_tpu/streaming/fleet.py``).

The single-trainer loop is one trainer on one stream; under real traffic
that single consumer IS the freshness bottleneck. This module shards it: a
:class:`StreamingFleet` supervisor spawns N shared-nothing trainer
*processes* over one partitioned stream (``?partitions=N`` at the
producer routes every record by its stamped key, ``?partition=k`` at
consumer ``k`` claims only its shard — different partitions are
different sub-streams, so claims are disjoint by construction, not by
consumer-group luck), each running the windowed loop and
committing cursor-carrying checkpoints into its OWN per-partition
namespace ``<root>/p<k>``. The serving side
(:class:`FleetReloaders`) runs one CheckpointWatcher per partition
namespace, adopting the freshest *committed* step per model — never an
older one (the watcher's monotonic-adoption invariant) — optionally
through a per-model :class:`~analytics_zoo_tpu_torch.streaming.guardrail.
GuardrailEvaluator` that rejects regressions before they reach traffic.

Topology::

    producer --(key hash)--> stream.p0 --> trainer-0 --> root/p0 \\
    producer --(key hash)--> stream.p1 --> trainer-1 --> root/p1 --+--> FleetReloaders
    producer --(key hash)--> stream.pN --> trainer-N --> root/pN /     (guard -> adopt
                                                                        per model)

Freshness math (docs/performance_notes.md): at a fixed aggregate
ingest rate R, each of N consumers sees R/N — so the per-consumer
``window_records`` must scale as ``aggregate_window / N`` (or windows
must be age-closed) for window close time, and therefore freshness, to
stay flat going 1 -> N. The supervisor only shards and supervises; it
holds no state a consumer crash can lose — a SIGKILLed trainer's
unacked claims sit in its partition's PEL until the respawned process
(same partition, cursor resumed from the per-partition checkpoint)
replays them into byte-identical windows.

Consumers are processes started with ``spawn`` (each opens its own CUDA
context on the card); the factory crosses the spawn boundary pickled by
reference, as the serving fleet's does (``serving/fleet.py``).
"""

from __future__ import annotations

import json
import logging
import multiprocessing as mp
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from ..common import knobs as _knobs
from ..obs import trace as _trace
from ..obs.registry import REGISTRY
from ..serving.fleet import _dumps, _loads
from ..serving.queue_api import make_broker, partitioned_spec
from ..shm import sweep_spec as _shm_sweep_spec
from .guardrail import GuardrailEvaluator
from .serve import StreamingReloader
from .source import StreamingXShards
from .stats import StreamingStats
from .trainer import StreamingTrainer

logger = logging.getLogger("analytics_zoo_tpu_torch")

__all__ = ["StreamingFleet", "FleetReloaders", "linear_estimator_factory"]

#: per-consumer freshness buckets (seconds): streaming adoption on a warm
#: loop lands well under a second; the tail buckets catch stalls
_FRESHNESS_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 120.0)


class _Linear(torch.nn.Module):
    """flax's ``Dense(1)(x)[:, 0]``: one ``Dense_0`` layer (the flax name,
    so ``interop`` carries its weights), lecun-normal kernel and zero
    bias drawn from ``seed``."""

    def __init__(self, dim: int, seed: int):
        super().__init__()
        from ..models.common.initializers import lecun_normal_
        self.Dense_0 = torch.nn.Linear(dim, 1)
        lecun_normal_(self.Dense_0.weight, dim,
                      torch.Generator().manual_seed(seed))
        with torch.no_grad():
            self.Dense_0.bias.zero_()

    def forward(self, x):
        return self.Dense_0(x)[:, 0]


def linear_estimator_factory(dim: int = 8, seed: int = 0,
                             lr: float = 0.05, device=None):
    """Module-level toy-estimator factory (plain-pickleable by reference
    through ``functools.partial`` — the spawn boundary re-imports this
    module in the child): a Dense(1) regressor, the tests' and the
    smoke's stand-in for a real per-partition model. ``device`` as every
    entry point of the port: the card unless ``"cpu"``."""
    from ..orca.learn.estimator import TPUEstimator
    from ..orca.learn.optimizers import Adam

    return TPUEstimator(_Linear(dim, seed), loss="mse",
                        optimizer=Adam(lr=lr), seed=seed, device=device)


def _consumer_main(factory_blob: bytes, queue_spec: str, partition: int,
                   root: str, cfg_json: str):
    """Entry point of one fleet trainer process (spawn target): build the
    estimator from the pickled factory, consume partition ``k``'s
    sub-stream through the windowed loop, commit into
    ``<root>/p<k>``, heartbeat through the partition broker, stop
    gracefully on SIGTERM (the commit protocol makes ANY exit point
    replay-safe — SIGKILL included, which is the chaos gate)."""
    cfg = json.loads(cfg_json)
    for k, v in (cfg.get("env") or {}).items():
        os.environ[k] = str(v)
    if _knobs.get("ZOO_TRACE"):
        _trace.arm()
    stop_ev = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop_ev.set())
    consumer_id = f"t{partition}"
    est = _loads(factory_blob)()
    src = StreamingXShards(
        partitioned_spec(queue_spec, partition),
        batch_size=int(cfg["batch_size"]),
        window_records=cfg.get("window_records"),
        window_age_s=cfg.get("window_age_s"),
        poll_timeout_s=cfg.get("poll_timeout_s"))
    model_dir = os.path.join(root, f"p{partition}")
    trainer = StreamingTrainer(est, src, model_dir,
                               commit_blocking=bool(
                                   cfg.get("commit_blocking", False)))
    resumed = trainer.resume()
    logger.info("stream-fleet consumer %s up (pid=%d, partition=%d, "
                "resumed=%s)", consumer_id, os.getpid(), partition, resumed)

    def _hb_doc(final: bool = False):
        snap = src.stats.snapshot()
        return {"partition": partition,
                "final": final,
                "windows": snap.get("windows", 0),
                "records_trained": snap.get("records_trained", 0),
                "records_deduped": snap.get("records_deduped", 0),
                "recompiles_after_warm":
                    snap.get("recompiles_after_warm", 0),
                "last_commit_step": snap.get("last_commit_step"),
                "reclaimed": int(getattr(src.broker, "reclaimed", 0)),
                # commit lag: newest trained event time -> now; the
                # supervisor-side (pre-adoption) freshness signal
                "commit_lag_s": (
                    round(time.time() - trainer.cursor.event_time_max, 3)
                    if trainer.cursor.event_time_max else None)}

    def _beat():
        while not hb_stop.wait(float(cfg.get("heartbeat_s", 0.5))):
            try:
                src.broker.heartbeat(consumer_id, _hb_doc())
            except Exception as e:  # noqa: BLE001 — liveness is advisory
                logger.debug("stream-fleet heartbeat failed: %s", e)

    hb_stop = threading.Event()
    hb = threading.Thread(target=_beat, daemon=True,
                          name=f"stream-hb-{consumer_id}")
    hb.start()
    try:
        trainer.run(max_windows=cfg.get("max_windows"),
                    idle_timeout_s=cfg.get("idle_timeout_s"),
                    stop=stop_ev)
    finally:
        hb_stop.set()
        try:
            # one FINAL beat instead of a clear: a graceful exit must not
            # erase its terminal stats before the supervisor's last
            # sample — the entry ages out through the liveness TTL, and a
            # respawn onto the partition overwrites the same key
            src.broker.heartbeat(consumer_id, _hb_doc(final=True))
        except Exception as e:  # noqa: BLE001 — broker may be gone
            logger.debug("stream-fleet final heartbeat failed: %s", e)
        est.shutdown()
        trace_dir = cfg.get("trace_dir")
        if trace_dir:
            from ..serving.fleet import _dump_spans
            _dump_spans(trace_dir, consumer_id)


class StreamingFleet:
    """Supervisor for N shared-nothing trainer consumers over one
    partitioned stream.

    ``estimator_factory`` is a zero-arg picklable callable returning a
    fresh ``TPUEstimator`` (every consumer builds its OWN — nothing is
    shared but the stream spec and the checkpoint root). ``queue`` must
    be a cross-process spec (``file://`` or ``redis://``); partition
    sub-streams are derived from it, so producers enqueue through
    ``make_broker(queue + "?partitions=N")`` and route by record key.

    The monitor thread reaps dead consumers and respawns them onto the
    SAME partition — the respawn resumes from the per-partition
    checkpoint cursor and replays its partition's PEL, which is the
    whole crash-recovery story (no rebalancing: partition count is
    fixed at fleet size, the deterministic-replay contract's price).
    """

    def __init__(self, estimator_factory: Callable[[], Any], queue: str,
                 root: str, *,
                 consumers: Optional[int] = None,
                 batch_size: int = 32,
                 window_records: Optional[int] = None,
                 window_age_s: Optional[float] = None,
                 poll_timeout_s: Optional[float] = None,
                 max_windows: Optional[int] = None,
                 idle_timeout_s: Optional[float] = None,
                 commit_blocking: bool = False,
                 heartbeat_s: float = 0.5,
                 consumer_ttl_s: float = 3.0,
                 poll_s: float = 0.25,
                 worker_env: Optional[Dict[str, str]] = None,
                 trace_dir: Optional[str] = None,
                 mp_start: str = "spawn"):
        if not isinstance(queue, str) or queue.startswith("memory://"):
            raise ValueError(
                "StreamingFleet needs a cross-process queue spec "
                f"(file:// or redis://), got {queue!r} — memory:// lives "
                "in one process")
        self.queue = queue
        self.root = root
        self.consumers = int(_knobs.get("ZOO_STREAM_CONSUMERS")
                             if consumers is None else consumers)
        if self.consumers < 1:
            raise ValueError(f"consumers must be >= 1, "
                             f"got {self.consumers}")
        self._factory_blob = _dumps(estimator_factory)
        self.heartbeat_s = float(heartbeat_s)
        self.consumer_ttl_s = float(consumer_ttl_s)
        self.poll_s = float(poll_s)
        self._cfg = {
            "batch_size": int(batch_size),
            "window_records": window_records,
            "window_age_s": window_age_s,
            "poll_timeout_s": poll_timeout_s,
            "max_windows": max_windows,
            "idle_timeout_s": idle_timeout_s,
            "commit_blocking": commit_blocking,
            "heartbeat_s": self.heartbeat_s,
            "env": dict(worker_env or {}),
            "trace_dir": trace_dir,
        }
        # the aggregate view: partitioned router over all sub-streams
        # (pending/oldest_age merge across partitions; live_workers
        # merges every consumer's heartbeat). partitioned_spec appends
        # its pin last, so swapping the tail yields the fan-out form.
        pinned = partitioned_spec(queue, 0)
        self.router = make_broker(pinned[:-len("partition=0")]
                                  + f"partitions={self.consumers}")
        self._ctx = mp.get_context(mp_start)
        self._procs: Dict[int, Any] = {}
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._last_stats: Dict[str, Dict] = {}
        self.restarts = 0

    # --- lifecycle ----------------------------------------------------------
    def partition_root(self, partition: int) -> str:
        """The checkpoint namespace consumer ``partition`` commits into
        (what a per-model reloader watches)."""
        return os.path.join(self.root, f"p{int(partition)}")

    def start(self) -> "StreamingFleet":
        os.makedirs(self.root, exist_ok=True)
        for k in range(self.consumers):
            self._spawn(k)
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True,
            name="stream-fleet-monitor")
        self._monitor.start()
        return self

    def _spawn(self, partition: int):
        p = self._ctx.Process(
            target=_consumer_main,
            args=(self._factory_blob, self.queue, partition, self.root,
                  json.dumps(self._cfg)),
            daemon=True, name=f"stream-consumer-t{partition}")
        p.start()
        self._procs[partition] = p
        logger.info("stream-fleet: spawned consumer t%d (pid=%d)",
                    partition, p.pid)

    def _monitor_loop(self):
        while not self._stop.wait(self.poll_s):
            try:
                self._tick()
            except Exception as e:  # noqa: BLE001 — supervisor must not die
                logger.warning("stream-fleet monitor tick failed: %s", e)

    def _tick(self):
        with self._lock:
            dead_pids: List[int] = []
            for k, p in list(self._procs.items()):
                if p.is_alive():
                    continue
                p.join(timeout=0)
                del self._procs[k]
                if p.pid is not None:
                    dead_pids.append(p.pid)
                if self._stop.is_set():
                    continue
                if p.exitcode == 0:
                    # clean exit: the consumer finished its bounded run
                    # (max_windows / idle timeout) — completion, not a
                    # crash; respawning it would churn forever
                    logger.info("stream-fleet: consumer t%d completed",
                                k)
                    continue
                # a consumer CRASHED (SIGKILL, OOM, bug): respawn it onto
                # the SAME partition — the per-partition cursor + PEL
                # replay make the restart bit-exact
                self.restarts += 1
                logger.warning(
                    "stream-fleet: consumer t%d died (exitcode=%s) — "
                    "respawning onto its partition", k, p.exitcode)
                self._spawn(k)
            if dead_pids:
                # shm object plane: a SIGKILLed consumer's slab pins die
                # with its pid — sweep its lease files; its unacked claims
                # replay into the respawn and re-resolve still-live blobs
                try:
                    out = _shm_sweep_spec(self.queue, dead_pids)
                    if out.get("leases_swept") or out.get("freed"):
                        logger.info(
                            "stream-fleet: shm sweep after reap: %s", out)
                except Exception as e:  # noqa: BLE001 — sweep is recovery
                    logger.warning(
                        "stream-fleet: shm sweep failed: %s", e)
            try:
                for cid, s in self.router.live_workers(
                        self.consumer_ttl_s).items():
                    self._last_stats[cid] = s
            except Exception as e:  # noqa: BLE001 — broker blip
                logger.debug("stream-fleet: live_workers probe "
                             "failed: %s", e)

    def wait_live(self, n: Optional[int] = None,
                  timeout_s: float = 60.0) -> bool:
        """Block until >= n consumers (default: all) heartbeat as
        live."""
        need = self.consumers if n is None else int(n)
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            try:
                if len(self.router.live_workers(
                        self.consumer_ttl_s)) >= need:
                    return True
            except Exception as e:  # noqa: BLE001 — broker warming up
                logger.debug("stream-fleet: wait_live probe failed: %s", e)
            time.sleep(0.05)
        return False

    def kill_consumer(self, partition: int) -> bool:
        """SIGKILL one consumer (chaos surface: no drain, no ack — its
        partition's unacked claims must replay through the PEL into the
        respawned process)."""
        with self._lock:
            p = self._procs.get(int(partition))
            if p is None or not p.is_alive():
                return False
            p.kill()
            logger.info("stream-fleet: SIGKILLed consumer t%d (chaos)",
                        partition)
            return True

    def alive(self) -> int:
        with self._lock:
            return sum(1 for p in self._procs.values() if p.is_alive())

    def join(self, timeout_s: float = 120.0) -> bool:
        """Wait for every consumer process to exit on its own (bounded
        runs: ``max_windows``/``idle_timeout_s`` set). False on
        timeout."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if self.alive() == 0:
                return True
            time.sleep(0.05)
        return False

    def metrics(self) -> Dict:
        with self._lock:
            stats = {c: dict(s) for c, s in self._last_stats.items()}
        return {
            "consumers": self.consumers,
            "alive": self.alive(),
            "restarts": self.restarts,
            "windows_total": sum(
                int(s.get("windows", 0)) for s in stats.values()),
            "records_trained_total": sum(
                int(s.get("records_trained", 0)) for s in stats.values()),
            "reclaimed_total": sum(
                int(s.get("reclaimed", 0)) for s in stats.values()),
            "per_consumer": stats,
        }

    def stop(self, timeout_s: float = 30.0) -> Dict:
        """Graceful shutdown: SIGTERM every consumer (each finishes its
        in-flight window commit), join, return final metrics."""
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5)
            self._monitor = None
        with self._lock:
            procs = dict(self._procs)
        # final heartbeat merge BEFORE the consumers clear their entries
        try:
            for cid, s in self.router.live_workers(
                    max(self.consumer_ttl_s, 60.0)).items():
                self._last_stats[cid] = s
        except Exception as e:  # noqa: BLE001 — broker may be gone
            logger.debug("stream-fleet: final heartbeat sample "
                         "failed: %s", e)
        for p in procs.values():
            if p.is_alive():
                p.terminate()
        deadline = time.time() + timeout_s
        for p in procs.values():
            p.join(timeout=max(0.1, deadline - time.time()))
        for k, p in procs.items():
            if p.is_alive():
                logger.warning("stream-fleet: consumer t%d ignored "
                               "SIGTERM — SIGKILL", k)
                p.kill()
                p.join(timeout=2)
        # final shm sweep: no consumer pid survives stop()
        try:
            _shm_sweep_spec(self.queue,
                            [p.pid for p in procs.values()
                             if p.pid is not None])
        except Exception as e:  # noqa: BLE001 — sweep is best-effort
            logger.warning("stream-fleet: shm sweep on stop failed: %s", e)
        snap = self.metrics()
        logger.info("stream-fleet stopped: %s", {
            k: snap[k] for k in ("consumers", "windows_total",
                                 "records_trained_total", "restarts")})
        return snap


class FleetReloaders:
    """Serving-side adoption for a partitioned checkpoint root: one
    :class:`StreamingReloader` per partition namespace, each hot-swapping
    its model's freshest *committed* step (monotonic — never an older
    one) and observing per-consumer freshness into the
    ``zoo_stream_fleet_freshness_s`` histogram (labels: ``inst``,
    ``consumer``).

    ``models`` maps partition index -> serving model (the
    ``apply_checkpoint`` surface); ``guards`` optionally maps partition
    index -> :class:`GuardrailEvaluator`, giving each model its own
    adoption gate (a regression on one cohort must not block the
    others' reloads).
    """

    def __init__(self, models: Dict[int, Any], root: str, *,
                 poll_s: float = 0.5,
                 guards: Optional[Dict[int, GuardrailEvaluator]] = None,
                 start_at: Optional[int] = None):
        self._hist = REGISTRY.histogram(
            "zoo_stream_fleet_freshness_s",
            "per-consumer freshness lag (newest trained event time -> "
            "serving adoption) across a streaming fleet's partitions",
            labelnames=("inst", "consumer"),
            buckets=_FRESHNESS_BUCKETS)
        self._inst = f"{id(self):x}"
        self.reloaders: Dict[int, StreamingReloader] = {}
        for k, model in models.items():
            child = self._hist.labels(inst=self._inst,
                                      consumer=f"t{int(k)}")
            self.reloaders[int(k)] = StreamingReloader(
                model, os.path.join(root, f"p{int(k)}"), poll_s=poll_s,
                start_at=start_at, stats=_ConsumerStats(child),
                guard=(guards or {}).get(int(k)))

    def start(self) -> "FleetReloaders":
        for r in self.reloaders.values():
            r.start()
        return self

    def stop(self):
        for r in self.reloaders.values():
            r.stop()
        for k in self.reloaders:
            self._hist.remove(inst=self._inst, consumer=f"t{k}")

    def poll_now(self) -> int:
        """One synchronous adoption check on every partition; returns how
        many adopted a newer step."""
        return sum(1 for r in self.reloaders.values() if r.poll_now())

    # --- telemetry ----------------------------------------------------------
    def freshness_p99_by_consumer(self) -> Dict[int, Optional[float]]:
        import numpy as np
        out: Dict[int, Optional[float]] = {}
        for k, r in self.reloaders.items():
            s = r.freshness_samples
            out[k] = float(np.percentile(s, 99)) if s else None
        return out

    def snapshot(self) -> Dict[int, Dict]:
        return {k: r.stats.snapshot() for k, r in self.reloaders.items()}


class _ConsumerStats(StreamingStats):
    """Per-partition reloader stats that mirror every freshness sample
    into the fleet histogram child for this consumer label."""

    def __init__(self, hist_child):
        super().__init__(register=False)
        self._hist_child = hist_child

    def observe_freshness(self, lag_s: float):
        super().observe_freshness(lag_s)
        self._hist_child.observe(float(lag_s))
