"""Scale-out serving tier: N frontends x M workers over one broker
(counterpart of ``analytics_zoo_tpu/serving/fleet.py``).

M worker *processes* fan over one stream as a consumer group (disjoint
claims, PEL redelivery on death), each running its own
ContinuousScheduler + ModelMultiplexer with its own copy of the model on
its own device — shared-nothing, so aggregate goodput scales with
workers until the broker or the device saturates. On one card the M
workers share it, each with its own CUDA context. A :class:`ServingFleet`
supervisor spawns and monitors the workers; an :class:`Autoscaler`
control loop reads the occupancy each worker heartbeats through the
broker (``zoo_serving_sched_busy_seconds_total`` deltas) plus the broker
backlog, and adds a worker on sustained saturation / retires one on
sustained idle, with cooldown hysteresis. Frontends shed on queue age
BEFORE enqueue (429 + Retry-After, ``http_frontend``), so the stream
holds work that will be served, not work that will expire.

Topology::

    client -> frontend-1 \\                    / worker-1
    client -> frontend-2 --> broker (stream) --> worker-2
    client -> frontend-N /    one group       \\ worker-M
                  ^                                 |
                  '------ results (hash/out dir) <--'

Everything crosses the broker: requests, results, worker heartbeats.
The supervisor holds no state a worker crash can lose — a SIGKILLed
worker's in-flight claims sit in the PEL until a surviving consumer's
idle-reclaim re-delivers them.

Workers start with ``spawn`` (a forked child of a parent that has used
CUDA cannot use it), so the model factory crosses the process boundary
pickled: a module-level function or a ``functools.partial`` of one
(cloudpickle, when installed, also takes closures).

Run ``python -m analytics_zoo_tpu_torch.serving.fleet --queue ...`` (the
JAX package's ``zoo-serving-fleet``).
"""

from __future__ import annotations

import argparse
import functools
import json
import logging
import multiprocessing as mp
import os
import pickle
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..common import knobs
from ..obs import trace as _trace
from ..obs.registry import REGISTRY, InstancedEvents
from ..shm import sweep_spec as _shm_sweep_spec
from .queue_api import make_broker

logger = logging.getLogger("analytics_zoo_tpu_torch")


def _dumps(obj) -> bytes:
    """Pickle a model factory for the spawn boundary — cloudpickle when
    available (lambdas/closures), plain pickle otherwise."""
    try:
        import cloudpickle
        return cloudpickle.dumps(obj)
    except ImportError:
        return pickle.dumps(obj)


def _loads(blob: bytes):
    # cloudpickle output is plain-pickle loadable; no import needed here
    return pickle.loads(blob)


class SleepModel:
    """Host-side stand-in for a device-bound model: ``predict`` sleeps
    ``batch_ms`` (the GIL is released, so M worker processes on one host
    scale like M devices would) and returns ``x * k``. The fleet bench
    and CI smoke run on this — per-worker capacity is
    ``batch_size / batch_ms``, so linear-scaling gates measure the
    *topology*, not the host's arithmetic throughput."""

    def __init__(self, k: float = 2.0, batch_ms: float = 20.0):
        self.k = float(k)
        self.batch_ms = float(batch_ms)

    def predict(self, x):
        time.sleep(self.batch_ms / 1e3)
        return np.asarray(x) * self.k


def sleep_model_factory(k: float = 2.0, batch_ms: float = 20.0):
    """Module-level factory (plain-pickleable for spawn)."""
    return SleepModel(k=k, batch_ms=batch_ms)


class Autoscaler:
    """Occupancy-driven worker-count controller with hysteresis.

    One decision per :meth:`observe` tick, from three guards that all
    must agree before the count moves:

    - **threshold**: mean occupancy >= ``up_occupancy`` (or backlog >=
      ``depth_per_worker`` x workers) is *saturated*; occupancy <=
      ``down_occupancy`` AND empty backlog is *idle*;
    - **sustain**: the condition must hold continuously for
      ``up_sustain_s`` / ``down_sustain_s`` (one-tick spikes and gaps
      don't move capacity);
    - **cooldown**: after any action, hold ``cooldown_s`` (a scale-up's
      occupancy drop must not immediately argue for scale-down — the
      flap killer).

    Pure function of (now, signal): no threads, no clock reads — the
    hysteresis tests drive it with synthetic traces and an explicit
    ``now``.
    """

    def __init__(self, min_workers: int = 1,
                 max_workers: Optional[int] = None,
                 up_occupancy: Optional[float] = None,
                 down_occupancy: Optional[float] = None,
                 up_sustain_s: Optional[float] = None,
                 down_sustain_s: Optional[float] = None,
                 cooldown_s: Optional[float] = None,
                 depth_per_worker: int = 64):
        self.min_workers = max(1, int(min_workers))
        self.max_workers = int(knobs.get("ZOO_FLEET_MAX_WORKERS")
                               if max_workers is None else max_workers)
        self.up_occupancy = float(knobs.get("ZOO_FLEET_SCALE_OCCUPANCY")
                                  if up_occupancy is None else up_occupancy)
        self.down_occupancy = float(
            knobs.get("ZOO_FLEET_IDLE_OCCUPANCY")
            if down_occupancy is None else down_occupancy)
        self.up_sustain_s = float(
            knobs.get("ZOO_FLEET_SCALE_UP_SUSTAIN_S")
            if up_sustain_s is None else up_sustain_s)
        self.down_sustain_s = float(
            knobs.get("ZOO_FLEET_SCALE_DOWN_SUSTAIN_S")
            if down_sustain_s is None else down_sustain_s)
        self.cooldown_s = float(knobs.get("ZOO_FLEET_SCALE_COOLDOWN_S")
                                if cooldown_s is None else cooldown_s)
        self.depth_per_worker = int(depth_per_worker)
        self._above_since: Optional[float] = None
        self._below_since: Optional[float] = None
        self._last_action_t: Optional[float] = None
        self.scale_ups = 0
        self.scale_downs = 0

    def observe(self, now: float, occupancy: float,
                queue_depth: int = 0, workers: int = 1) -> int:
        """Feed one sample; returns the target worker count (== ``workers``
        when nothing should change)."""
        saturated = (occupancy >= self.up_occupancy
                     or (self.depth_per_worker > 0 and queue_depth
                         >= self.depth_per_worker * max(1, workers)))
        idle = occupancy <= self.down_occupancy and queue_depth == 0
        if saturated:
            self._below_since = None
            if self._above_since is None:
                self._above_since = now
        elif idle:
            self._above_since = None
            if self._below_since is None:
                self._below_since = now
        else:
            self._above_since = None
            self._below_since = None
        in_cooldown = (self._last_action_t is not None
                       and now - self._last_action_t < self.cooldown_s)
        target = workers
        if (saturated and workers < self.max_workers and not in_cooldown
                and now - self._above_since >= self.up_sustain_s):
            target = workers + 1
            self.scale_ups += 1
        elif (idle and workers > self.min_workers and not in_cooldown
                and now - self._below_since >= self.down_sustain_s):
            target = workers - 1
            self.scale_downs += 1
        if target != workers:
            self._last_action_t = now
            # a fresh decision needs fresh evidence: the sustain windows
            # restart after every action
            self._above_since = None
            self._below_since = None
        return target


def _dump_spans(trace_dir: str, worker_id: str):
    """Write this process's recorded spans as JSONL — the parent stitches
    them to the frontend's spans by trace id (one trace crosses the
    process boundary through the payload meta)."""
    spans = _trace.spans()
    if not spans:
        return
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"spans-{worker_id}.jsonl")
    with open(path, "w") as f:
        for s in spans:
            f.write(json.dumps(s.to_dict()) + "\n")


def _dump_metrics(trace_dir: str, worker_id: str, snap: Dict):
    """Write this worker's final engine metrics (the ``drain`` snapshot:
    stage percentiles, counters, transfer) as JSON beside its spans, so
    the parent can read where a worker's time went."""
    os.makedirs(trace_dir, exist_ok=True)
    with open(os.path.join(trace_dir, f"metrics-{worker_id}.json"),
              "w") as f:
        json.dump(snap, f, default=str)


def _worker_main(factory_blob: bytes, queue_spec: str, worker_id: str,
                 cfg_json: str):
    """Entry point of one fleet worker process (spawn target): build the
    model from the pickled factory, run a ClusterServing engine against
    the shared stream under this consumer id, heartbeat through the
    broker, drain gracefully on SIGTERM. With a ``trace_dir`` it writes
    its spans and its final engine metrics there on drain."""
    cfg = json.loads(cfg_json)
    for k, v in (cfg.get("env") or {}).items():
        os.environ[k] = str(v)
    if knobs.get("ZOO_TRACE"):
        _trace.arm()
    trace_dir = cfg.get("trace_dir")
    stop_ev = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop_ev.set())
    factory = _loads(factory_blob)
    model = factory()
    from .engine import ClusterServing
    serving = ClusterServing(
        model, queue=queue_spec,
        batch_size=cfg.get("batch_size"),
        batch_timeout_ms=cfg.get("batch_timeout_ms"),
        policy=cfg.get("policy", "continuous"),
        max_inflight=cfg.get("max_inflight"),
        slack_ms=cfg.get("slack_ms"),
        worker_id=worker_id,
        heartbeat_s=cfg.get("heartbeat_s"))
    serving.start()
    logger.info("fleet worker %s up (pid=%d, queue=%s)", worker_id,
                os.getpid(), queue_spec)
    snap = None
    try:
        while not stop_ev.wait(0.2):
            pass
        snap = serving.drain(timeout_s=float(cfg.get("drain_s", 15.0)))
    finally:
        if trace_dir:
            _dump_spans(trace_dir, worker_id)
            if snap is not None:
                _dump_metrics(trace_dir, worker_id, snap)


class ServingFleet:
    """Supervisor for M shared-nothing worker processes over one broker.

    ``model_factory`` is a zero-arg callable returning the model each
    worker serves (pickled to the spawn boundary — every worker builds
    its OWN model on its own device; nothing is shared but the
    stream). ``queue`` must be a cross-process spec (``file://`` or
    ``redis://``; ``memory://`` cannot cross a process boundary and is
    rejected).

    The monitor thread ticks every ``poll_s``: reaps dead processes
    (respawning unexpected deaths), samples worker heartbeats into
    per-worker occupancy (busy-seconds deltas), feeds the
    :class:`Autoscaler`, and reconciles the process set to the target
    count — retire via SIGTERM (drain), crash recovery via respawn.
    """

    def __init__(self, model_factory: Callable[[], Any], queue: str,
                 *,
                 workers: Optional[int] = None,
                 max_workers: Optional[int] = None,
                 policy: str = "continuous",
                 batch_size: Optional[int] = None,
                 batch_timeout_ms: Optional[float] = None,
                 max_inflight: Optional[int] = None,
                 slack_ms: Optional[float] = None,
                 autoscale: bool = True,
                 autoscaler: Optional[Autoscaler] = None,
                 heartbeat_s: Optional[float] = None,
                 worker_ttl_s: Optional[float] = None,
                 poll_s: float = 0.25,
                 drain_s: float = 15.0,
                 worker_env: Optional[Dict[str, str]] = None,
                 trace_dir: Optional[str] = None,
                 mp_start: str = "spawn"):
        if not isinstance(queue, str) or queue.startswith("memory://"):
            raise ValueError(
                "ServingFleet needs a cross-process queue spec (file:// "
                f"or redis://), got {queue!r} — memory:// lives in one "
                "process")
        self.queue = queue
        self._factory_blob = _dumps(model_factory)
        self.workers_initial = int(knobs.get("ZOO_FLEET_WORKERS")
                                   if workers is None else workers)
        self.heartbeat_s = float(knobs.get("ZOO_FLEET_HEARTBEAT_S")
                                 if heartbeat_s is None else heartbeat_s)
        self.worker_ttl_s = float(knobs.get("ZOO_FLEET_WORKER_TTL_S")
                                  if worker_ttl_s is None else worker_ttl_s)
        self.autoscale = autoscale
        self.autoscaler = autoscaler or Autoscaler(
            min_workers=max(1, self.workers_initial
                            if not autoscale else 1),
            max_workers=max_workers)
        if self.autoscaler.max_workers < self.workers_initial:
            self.autoscaler.max_workers = self.workers_initial
        self.poll_s = float(poll_s)
        self._cfg = {
            "policy": policy, "batch_size": batch_size,
            "batch_timeout_ms": batch_timeout_ms,
            "max_inflight": max_inflight, "slack_ms": slack_ms,
            "heartbeat_s": self.heartbeat_s, "drain_s": drain_s,
            "env": dict(worker_env or {}), "trace_dir": trace_dir,
        }
        self.broker = make_broker(queue)
        self._ctx = mp.get_context(mp_start)
        self._procs: Dict[str, Any] = {}
        self._retiring: set = set()
        self._target = self.workers_initial
        self._next_id = 0
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # last heartbeat stats per worker id, kept after death so the
        # fleet-wide cumulative aggregates (records_out, reclaimed)
        # survive the workers that produced them
        self._last_stats: Dict[str, Dict] = {}
        self._prev_busy: Dict[str, tuple] = {}
        self._live_now: Dict[str, Dict] = {}
        self._occupancy = 0.0
        # fleet-level obs: live/target worker gauges + lifecycle events,
        # per supervisor instance (inst label), series dropped on stop()
        self._events = InstancedEvents(
            REGISTRY.counter(
                "zoo_fleet_events_total",
                "fleet lifecycle events: worker spawns, unexpected-death "
                "respawns, autoscale decisions, graceful retirements",
                labelnames=("inst", "event")),
            ("spawned", "restarted", "scale_up", "scale_down", "retired"))
        inst = self._events.inst
        self._g_live = REGISTRY.gauge(
            "zoo_fleet_workers_live",
            "worker processes with a fresh heartbeat through the broker",
            labelnames=("inst",)).labels(inst=inst)
        self._g_target = REGISTRY.gauge(
            "zoo_fleet_workers_target",
            "worker count the supervisor is reconciling toward "
            "(autoscaler output)",
            labelnames=("inst",)).labels(inst=inst)
        self._inst = inst

    # --- lifecycle -----------------------------------------------------------
    def start(self) -> "ServingFleet":
        for _ in range(self.workers_initial):
            self._spawn()
        self._g_target.set(self._target)
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True, name="fleet-monitor")
        self._monitor.start()
        return self

    def _spawn(self):
        wid = f"w{self._next_id}"
        self._next_id += 1
        p = self._ctx.Process(
            target=_worker_main,
            args=(self._factory_blob, self.queue, wid,
                  json.dumps(self._cfg)),
            daemon=True, name=f"fleet-worker-{wid}")
        p.start()
        self._procs[wid] = p
        self._events["spawned"].inc()
        logger.info("fleet: spawned worker %s (pid=%d)", wid, p.pid)
        return wid

    def _retire(self, wid: str):
        p = self._procs.get(wid)
        if p is None or not p.is_alive():
            return
        self._retiring.add(wid)
        p.terminate()           # SIGTERM -> worker drains, dumps spans
        self._events["retired"].inc()
        logger.info("fleet: retiring worker %s (pid=%d)", wid, p.pid)

    def _monitor_loop(self):
        while not self._stop.wait(self.poll_s):
            try:
                self._tick(time.time())
            except Exception as e:  # noqa: BLE001 — supervisor must not die
                logger.warning("fleet monitor tick failed: %s", e)

    def _tick(self, now: float):
        with self._lock:
            # 1. reap: a retiring worker leaving is the plan; anything
            # else died under us and the reconcile below respawns it
            dead_pids: List[int] = []
            for wid, p in list(self._procs.items()):
                if p.is_alive():
                    continue
                p.join(timeout=0)
                del self._procs[wid]
                if p.pid is not None:
                    dead_pids.append(p.pid)
                if wid in self._retiring:
                    self._retiring.discard(wid)
                else:
                    self._events["restarted"].inc()
                    logger.warning(
                        "fleet: worker %s died (exitcode=%s) — respawning",
                        wid, p.exitcode)
            if dead_pids:
                # shm object plane: a SIGKILLed worker's slab pins die with
                # its pid — sweep its lease files so nothing leaks (unacked
                # entries replay and re-resolve their still-live blobs)
                try:
                    out = _shm_sweep_spec(self.queue, dead_pids)
                    if out.get("leases_swept") or out.get("freed"):
                        logger.info("fleet: shm sweep after reap: %s", out)
                except Exception as e:  # noqa: BLE001 — sweep is recovery,
                    logger.warning("fleet: shm sweep failed: %s", e)
            # 2. sample heartbeats -> per-worker occupancy from
            # busy-seconds deltas (rate of device-busy wall time)
            try:
                live = self.broker.live_workers(self.worker_ttl_s)
            except Exception as e:  # noqa: BLE001 — broker blip
                logger.debug("fleet: live_workers probe failed: %s", e)
                live = {}
            self._live_now = live
            occs: List[float] = []
            for wid, stats in live.items():
                self._last_stats[wid] = stats
                busy = float(stats.get("busy_s", 0.0))
                t = float(stats.get("t", now))
                prev = self._prev_busy.get(wid)
                self._prev_busy[wid] = (t, busy)
                if prev and t > prev[0]:
                    occs.append(min(1.0, max(
                        0.0, (busy - prev[1]) / (t - prev[0]))))
            if occs:
                self._occupancy = sum(occs) / len(occs)
            elif not live:
                self._occupancy = 0.0
            # else: live workers but no fresh beat since the last tick
            # (poll_s can outrun heartbeat_s) — hold the previous
            # estimate instead of feeding a spurious zero to the
            # autoscaler, which would reset its sustain window
            try:
                depth = self.broker.pending()
            except Exception as e:  # noqa: BLE001 — broker blip
                logger.debug("fleet: pending probe failed: %s", e)
                depth = 0
            # 3. autoscale on the sampled signal
            if self.autoscale:
                new = self.autoscaler.observe(
                    now, self._occupancy, queue_depth=depth,
                    workers=self._target)
                if new > self._target:
                    self._events["scale_up"].inc()
                    logger.info(
                        "fleet: scale up %d -> %d (occ=%.2f depth=%d)",
                        self._target, new, self._occupancy, depth)
                elif new < self._target:
                    self._events["scale_down"].inc()
                    logger.info(
                        "fleet: scale down %d -> %d (occ=%.2f)",
                        self._target, new, self._occupancy)
                self._target = new
            # 4. reconcile process set to target
            active = [w for w in self._procs if w not in self._retiring]
            while len(active) < self._target:
                active.append(self._spawn())
            for wid in sorted(
                    active,
                    key=lambda w: int(w[1:]))[self._target:]:
                self._retire(wid)
            # 5. gauges
            self._g_live.set(len(live))
            self._g_target.set(self._target)

    def scale_to(self, n: int):
        """Manual override: set the reconcile target (the next tick
        spawns/retires to it). With autoscale on, the autoscaler keeps
        adjusting from the new baseline."""
        with self._lock:
            self._target = max(1, min(int(n), self.autoscaler.max_workers))

    def wait_live(self, n: int, timeout_s: float = 30.0) -> bool:
        """Block until >= n workers heartbeat as live."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            try:
                if len(self.broker.live_workers(self.worker_ttl_s)) >= n:
                    return True
            except Exception as e:  # noqa: BLE001 — broker warming up
                logger.debug("fleet: wait_live probe failed: %s", e)
            time.sleep(0.05)
        return False

    def metrics(self) -> Dict:
        with self._lock:
            live = dict(self._live_now)
            stats = {w: dict(s) for w, s in self._last_stats.items()}
            ev = {k: int(c.value) for k, c in self._events.children.items()}
            return {
                "workers_target": self._target,
                "workers_procs": len(self._procs),
                "workers_live": len(live),
                "occupancy": round(self._occupancy, 4),
                "spawned": ev["spawned"],
                "restarts": ev["restarted"],
                "retired": ev["retired"],
                "scale_ups": self.autoscaler.scale_ups,
                "scale_downs": self.autoscaler.scale_downs,
                "records_out_total": sum(
                    int(s.get("records_out", 0)) for s in stats.values()),
                "reclaimed_total": sum(
                    int(s.get("reclaimed", 0)) for s in stats.values()),
                "per_worker": stats,
            }

    def kill_worker(self, wid: Optional[str] = None) -> Optional[str]:
        """SIGKILL one worker (chaos surface: no drain, no span dump —
        its pending claims must re-deliver via the broker's idle-reclaim).
        Returns the killed worker id, or None if none alive."""
        with self._lock:
            victims = [w for w, p in self._procs.items()
                       if p.is_alive() and w not in self._retiring]
            if wid is None:
                wid = victims[0] if victims else None
            if wid is None or wid not in self._procs:
                return None
            self._procs[wid].kill()
            logger.info("fleet: SIGKILLed worker %s (chaos)", wid)
            return wid

    def drain(self, timeout_s: float = 30.0) -> Dict:
        """Graceful fleet shutdown: SIGTERM every worker (each drains its
        admitted work), join, return the final metrics snapshot."""
        return self.stop(timeout_s=timeout_s)

    def stop(self, timeout_s: float = 10.0) -> Dict:
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5)
        with self._lock:
            procs = dict(self._procs)
        # one last heartbeat sample so the snapshot reflects final
        # cumulative counters (workers clear their hb entry on drain).
        # Liveness doesn't matter here, only the counters, so a stale
        # beat on a loaded host is still worth merging — sample with a
        # generous ttl instead of worker_ttl_s
        try:
            for wid, s in self.broker.live_workers(
                    max(self.worker_ttl_s, 60.0)).items():
                self._last_stats[wid] = s
        except Exception as e:  # noqa: BLE001 — broker may be gone
            logger.debug("fleet: final heartbeat sample failed: %s", e)
        for p in procs.values():
            if p.is_alive():
                p.terminate()
        deadline = time.time() + timeout_s
        for p in procs.values():
            p.join(timeout=max(0.1, deadline - time.time()))
        for wid, p in procs.items():
            if p.is_alive():
                logger.warning("fleet: worker %s ignored SIGTERM — "
                               "SIGKILL", wid)
                p.kill()
                p.join(timeout=2)
        # final shm sweep: no worker pid survives stop(), so any lease a
        # SIGKILLed worker left behind is dropped here
        try:
            _shm_sweep_spec(self.queue,
                            [p.pid for p in procs.values()
                             if p.pid is not None])
        except Exception as e:  # noqa: BLE001 — sweep is best-effort
            logger.warning("fleet: shm sweep on stop failed: %s", e)
        snap = self.metrics()
        self._events.close()
        REGISTRY.gauge("zoo_fleet_workers_live",
                       labelnames=("inst",)).remove(inst=self._inst)
        REGISTRY.gauge("zoo_fleet_workers_target",
                       labelnames=("inst",)).remove(inst=self._inst)
        logger.info("fleet stopped: %s", {
            k: snap[k] for k in ("workers_target", "records_out_total",
                                 "restarts", "scale_ups", "scale_downs")})
        return snap


def _model_loader(path: str):
    """Module-level factory for real models (plain-pickleable): each
    worker loads its own copy of an ``InferenceModel.save`` file onto its
    own device (the card; ``InferenceModel()`` raises on a host without
    one). TensorFlow exports (``.pb``, ``.h5``, a directory) need
    ``load_tf``, which this package does not have yet (ROADMAP A9)."""
    from ..pipeline.inference import InferenceModel
    if (path.endswith(".pb") or path.endswith(".h5")
            or os.path.isdir(path)):
        raise NotImplementedError(
            f"{path}: TensorFlow models need InferenceModel.load_tf, which "
            "is not ported yet (ROADMAP A9)")
    return InferenceModel().load(path)


def main(argv=None):
    """Supervise M serving workers over one broker.

    Pair with one or more ``python -m
    analytics_zoo_tpu_torch.serving.http_frontend`` frontends on the same
    ``--queue`` spec (frontends enqueue + fetch; this process only runs
    workers)."""
    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--queue", required=True,
                   help="cross-process broker spec: file:///dir or "
                        "redis://host:port/stream (optionally "
                        "?claim_idle_ms=...)")
    p.add_argument("--model", default=None,
                   help="model file each worker loads (InferenceModel."
                        "save); default: a SleepModel toy (topology "
                        "testing)")
    p.add_argument("--workers", type=int, default=None,
                   help="initial worker count (ZOO_FLEET_WORKERS)")
    p.add_argument("--max-workers", type=int, default=None,
                   help="autoscale ceiling (ZOO_FLEET_MAX_WORKERS)")
    p.add_argument("--no-autoscale", action="store_true",
                   help="pin the worker count (no occupancy control loop)")
    p.add_argument("--policy", choices=("continuous", "fixed"),
                   default="continuous")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--batch-timeout-ms", type=float, default=None)
    p.add_argument("--max-inflight", type=int, default=None)
    p.add_argument("--slack-ms", type=float, default=None)
    args = p.parse_args(argv)

    if args.model:
        factory = functools.partial(_model_loader, args.model)
    else:
        factory = sleep_model_factory
    fleet = ServingFleet(
        factory, args.queue, workers=args.workers,
        max_workers=args.max_workers, policy=args.policy,
        batch_size=args.batch_size,
        batch_timeout_ms=args.batch_timeout_ms,
        max_inflight=args.max_inflight, slack_ms=args.slack_ms,
        autoscale=not args.no_autoscale).start()
    stop_ev = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop_ev.set())
    signal.signal(signal.SIGINT, lambda *_: stop_ev.set())
    try:
        while not stop_ev.wait(1.0):
            pass
    finally:
        snap = fleet.drain()
        print(json.dumps(snap, default=str))


if __name__ == "__main__":
    main()
