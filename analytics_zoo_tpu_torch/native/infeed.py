"""Device infeed pump: pipelined, instrumented host→device data plane
(counterpart of ``analytics_zoo_tpu/native/infeed.py``; the same stages,
counters and ordering, with the transfer lanes copying to the card through
``native/transfer.put_tree``).

The reference hides infeed latency with per-executor JVM threads pulling from
Spark block manager (SURVEY.md §3.2); here it is a three-stage
pipeline that keeps the chip fed while the host assembles:

  assembly workers (N threads)  →  H2D transfer lanes  →  consumer
  gather/pad per batch, no GIL     parallel device_put,    train loop
                                   in-order delivery

The factory yields **zero-arg assembly tasks** (callables), one per batch
in batch order; the tasks are fanned out over N workers and re-ordered
before the transfer stage, so slow batch assembly does not serialize behind
the transfer. The transfer stage runs ``ZOO_H2D_LANES`` (default 2) copies
concurrently while a FIFO future window keeps delivery strictly in batch
order. The delivery queue's depth is adaptive: it grows while the consumer
is observed starving (bounded by a host-memory budget), and when the H2D
stage is the dominant producer-side cost the pump raises its lane count too
(bounded by ``MAX_H2D_LANES``), so a bursty producer gets buffer and a
bandwidth-bound one gets parallel transfer streams.

Every stage reports into a :class:`PipelineStats` — the counters surfaced
by ``estimator.data_pipeline_stats()`` and printed by ``bench.py`` — so
perf work can see where epoch time goes (assemble / H2D / step / stall),
each stage's MB/s, and whether the run was ``transfer_limited``.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

from ..common import knobs as _knobs
from ..obs import trace as _trace
from ..obs.registry import REGISTRY as _REGISTRY
from .transfer import MAX_H2D_LANES, default_h2d_lanes

_STOP = object()

# ceiling of the adaptive prefetch depth. Depth is also never grown past
# the staging budget (ZOO_INFEED_BUDGET_MB, 256 MB) over the batch bytes,
# so staged batches stay O(batch × depth). NOTE the delivery queue holds
# post-device_put batches — every staged batch is device-resident, so the
# budget bounds device memory as much as host memory; the defaults are
# deliberately conservative so adaptive growth cannot OOM a model that fit
# at depth 2.
_MAX_DEPTH = 8


class PipelineStats:
    """Monotonic per-stage timers/counters for the input pipeline.

    Stages: ``assemble`` (host batch gather/pad), ``h2d`` (device_put),
    ``step`` (engine dispatch, recorded by TrainEngine), ``stall`` (time
    the consumer waited on the delivery queue). Thread-safe; shared by the
    iterator, the pump, and the engine.

    Stages that report bytes (H2D always; assemble when the pump feeds it)
    get a ``<stage>_MBps`` rate in :meth:`snapshot`, and the snapshot carries
    a ``transfer_limited`` verdict: cumulative H2D seconds exceed cumulative
    step seconds, i.e. the wire — not the chip — bounds throughput. With
    ``lanes`` transfer lanes running concurrently, ``h2d_s`` is the sum of
    per-transfer times (per-lane seconds), so ``h2d_MBps`` is the average
    per-lane rate; aggregate wire rate is up to ``lanes ×`` that.
    """

    STAGES = ("assemble", "h2d", "step", "stall")

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()
        # ZOO_OBS gates the obs-plane coupling only (the counters are
        # unchanged either way), read per-construction like ckpt/plane.py
        # so toggling the knob in-process is honored
        if _knobs.get("ZOO_OBS"):
            # obs plane: expose this instance's counters on the unified
            # registry (weakly — a dead estimator's stats drop out of the
            # /metrics.prom exposition); the dict API stays the source
            _REGISTRY.register_object("zoo_infeed", self)

    def reset(self):
        with self._lock:
            self._time = {s: 0.0 for s in self.STAGES}
            self._count = {s: 0 for s in self.STAGES}
            self._bytes = {s: 0 for s in self.STAGES}
            self.depth = 0
            self.depth_peak = 0
            self.depth_growths = 0
            self.lanes = 0
            self.lane_growths = 0

    @property
    def h2d_bytes(self) -> int:
        with self._lock:
            return self._bytes["h2d"]

    def add(self, stage: str, seconds: float, count: int = 1,
            nbytes: int = 0):
        with self._lock:
            self._time[stage] += seconds
            self._count[stage] += count
            if nbytes:
                self._bytes[stage] += nbytes

    def observe_depth(self, depth: int, grew: bool = False):
        with self._lock:
            self.depth = depth
            self.depth_peak = max(self.depth_peak, depth)
            if grew:
                self.depth_growths += 1

    def observe_lanes(self, lanes: int, grew: bool = False):
        with self._lock:
            self.lanes = lanes
            if grew:
                self.lane_growths += 1

    def stage_seconds(self) -> dict:
        with self._lock:
            return dict(self._time)

    def snapshot(self) -> dict:
        with self._lock:
            out = {}
            for s in self.STAGES:
                out[f"{s}_s"] = round(self._time[s], 6)
                out[f"{s}_n"] = self._count[s]
                if self._bytes[s] and s != "h2d":
                    out[f"{s}_bytes"] = self._bytes[s]
                    out[f"{s}_MBps"] = (
                        round(self._bytes[s] / self._time[s] / 1e6, 1)
                        if self._time[s] > 0 else 0.0)
            out["h2d_bytes"] = self._bytes["h2d"]
            out["h2d_MBps"] = (
                round(self._bytes["h2d"] / self._time["h2d"] / 1e6, 1)
                if self._time["h2d"] > 0 else 0.0)
            # the wire binds when transfer time beats compute-dispatch
            # time. h2d_s SUMS per-lane seconds (lanes run concurrently),
            # so normalize by the lane count to approximate the stage's
            # wall time before comparing with the serial step stage; no
            # verdict without both signals
            out["transfer_limited"] = bool(
                self._count["h2d"] and self._count["step"]
                and self._time["h2d"] / max(self.lanes, 1)
                > self._time["step"])
            out["depth"] = self.depth
            out["depth_peak"] = self.depth_peak
            out["depth_growths"] = self.depth_growths
            out["lanes"] = self.lanes
            out["lane_growths"] = self.lane_growths
            return out


def _batch_nbytes(b) -> int:
    """Host/device bytes of a batch (``utils.Batch``: arrays, pinned
    staging slots or tensors)."""
    return sum(int(getattr(a, "nbytes", 0)) for a in b.leaves())


class _FlexQueue:
    """Bounded FIFO with adjustable capacity and close(); in-order by
    construction (single producer). Pure Python: the payloads' heavy work
    (numpy gathers, device_put) releases the GIL, so a Condition-based
    queue is not on the critical path."""

    def __init__(self, capacity: int):
        self._cv = threading.Condition()
        self._items: deque = deque()
        self.capacity = max(1, capacity)
        self._closed = False

    def put(self, item) -> bool:
        with self._cv:
            while len(self._items) >= self.capacity and not self._closed:
                self._cv.wait()
            if self._closed:
                return False
            self._items.append(item)
            self._cv.notify_all()
            return True

    def get(self, timeout: Optional[float] = None):
        with self._cv:
            deadline = None if timeout is None else (
                time.monotonic() + timeout)
            while not self._items and not self._closed:
                remaining = None if deadline is None else (
                    deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return None
                self._cv.wait(remaining)
            if self._items:
                item = self._items.popleft()
                self._cv.notify_all()
                return item
            return None                 # closed and drained

    def grow(self, capacity: int):
        with self._cv:
            if capacity > self.capacity:
                self.capacity = capacity
                self._cv.notify_all()

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()


def _default_workers() -> int:
    env = os.environ.get("ZOO_INFEED_WORKERS")
    if env:
        return max(1, int(env))
    return min(4, os.cpu_count() or 2)


class InfeedPump:
    """Wrap an assembly-task iterator factory; yields device-resident
    batches ahead of consumption.

    Parameters
    ----------
    batch_iter_factory : returns an iterator of zero-arg callables, each
        assembling one host batch; they are fanned out over ``workers``
        assembly threads and re-ordered.
    device_put : staging function applied by the transfer lanes (the
        iterator passes its own); delivery stays in batch order regardless
        of per-transfer timing.
    depth : initial delivery-queue depth; it grows while the consumer
        starves, up to the staging budget (``ZOO_INFEED_BUDGET_MB``, 256 MB
        — staged batches live on the device, so it bounds device memory as
        well as host bytes) over the first batch's size, capped at 8.
    workers : assembly thread count (``ZOO_INFEED_WORKERS``, default
        min(4, cpus)).
    stats : shared :class:`PipelineStats`; a private one is created if
        omitted (exposed as ``pump.stats``).

    The transfer lanes start at ``ZOO_H2D_LANES`` (default 2); the pump
    raises the count up to ``MAX_H2D_LANES`` when the consumer starves
    while the H2D stage dominates assembly.
    """

    def __init__(self, batch_iter_factory: Callable[[], Iterator],
                 device_put: Callable, depth: int = 2,
                 workers: Optional[int] = None,
                 stats: Optional[PipelineStats] = None):
        self._factory = batch_iter_factory
        self._device_put = device_put
        self._depth = max(1, depth)
        self._max_depth: Optional[int] = None   # set at the first growth
        self._workers = workers if workers is not None else _default_workers()
        self._lanes = default_h2d_lanes()
        self.stats = stats if stats is not None else PipelineStats()
        self.stats.observe_lanes(self._lanes)
        self._trace_token = None    # captured per-epoch at __iter__
        self._budget = int(_knobs.get("ZOO_INFEED_BUDGET_MB")) << 20

    # --- producer side -------------------------------------------------------
    # trace spans here use the handoff token captured at __iter__ time on
    # the CONSUMER thread (inside fit's epoch span): the assembly workers
    # and transfer lanes are pool threads where a contextvar alone would
    # lose the trace. Disarmed cost: one flag check per call.
    def _assemble(self, task):
        with _trace.span_under(self._trace_token, "infeed.assemble"):
            t0 = time.perf_counter()
            batch = task()
            self.stats.add("assemble", time.perf_counter() - t0,
                           nbytes=_batch_nbytes(batch))
        return batch

    def _transfer(self, host_batch):
        """One lane's work: stage a whole batch on the device. Runs
        concurrently on up to ``lanes`` threads; ordering is restored by
        the caller's FIFO future window."""
        with _trace.span_under(self._trace_token, "infeed.h2d"):
            t0 = time.perf_counter()
            dev = self._device_put(host_batch)
            self.stats.add("h2d", time.perf_counter() - t0,
                           nbytes=_batch_nbytes(host_batch))
        return dev

    def _producer(self, q: _FlexQueue, err: list):
        asm_pool = None
        lane_pool = ThreadPoolExecutor(MAX_H2D_LANES,
                                       thread_name_prefix="zoo-infeed-h2d")
        asm_window: deque = deque()   # in-flight assembly futures, in order
        h2d_window: deque = deque()   # in-flight transfer futures, in order

        def deliver(drain: bool = False) -> bool:
            """Move finished transfers to the delivery queue, oldest first:
            completed heads always; still-running ones only on the
            end-of-epoch ``drain``."""
            while h2d_window and (drain or h2d_window[0].done()):
                if not q.put(h2d_window.popleft().result()):
                    return False
            return True

        def submit_h2d(host_batch) -> bool:
            # cap in-flight transfers at the CURRENT lane count (it may
            # have been raised adaptively mid-epoch) BEFORE submitting —
            # the pool is sized for the ceiling, so the window is what
            # bounds concurrency
            while len(h2d_window) >= max(self._lanes, 1):
                if not q.put(h2d_window.popleft().result()):
                    return False
            h2d_window.append(lane_pool.submit(self._transfer, host_batch))
            return deliver()

        try:
            asm_pool = ThreadPoolExecutor(self._workers,
                                          thread_name_prefix="zoo-infeed-asm")
            for task in self._factory():
                # fan the assembly out, keep order via the window
                asm_window.append(asm_pool.submit(self._assemble, task))
                # hand the oldest to the transfer lanes once the window
                # covers the workers — its gather is done or about to be;
                # later tasks keep assembling meanwhile
                if len(asm_window) > self._workers:
                    if not submit_h2d(asm_window.popleft().result()):
                        return
            while asm_window:
                if not submit_h2d(asm_window.popleft().result()):
                    return
            if not deliver(drain=True):
                return
        except Exception as e:          # surface on the consumer side
            err.append(e)
        finally:
            if asm_pool is not None:
                asm_pool.shutdown(wait=False, cancel_futures=True)
            lane_pool.shutdown(wait=False, cancel_futures=True)
            # Blocking put: the sentinel must never be dropped, or the
            # consumer hangs forever at epoch end. If the queue is full
            # (consumer stuck in a long first-step jit compile) this waits
            # for a slot; the consumer's finally q.close() unblocks the
            # wait when iteration is abandoned.
            q.put(_STOP)

    # --- consumer side -------------------------------------------------------
    def _maybe_grow(self, q: _FlexQueue, sample_batch):
        if self._max_depth is None:
            bb = _batch_nbytes(sample_batch)
            self._max_depth = max(
                self._depth, min(_MAX_DEPTH, self._budget // max(bb, 1)))
        if q.capacity < self._max_depth:
            q.grow(min(q.capacity * 2, self._max_depth))
            self.stats.observe_depth(q.capacity, grew=True)
        # the consumer is starving while the producer still runs: when the
        # H2D stage — not assembly — is the dominant producer-side cost,
        # deeper buffering alone cannot help; open another transfer lane.
        # h2d_s sums per-lane seconds, so normalize by the lane count
        # before comparing (assemble stays summed: overestimating it only
        # makes lane growth more conservative)
        t = self.stats.stage_seconds()
        if self._lanes < MAX_H2D_LANES and \
                t["h2d"] / max(self._lanes, 1) > t["assemble"]:
            self._lanes += 1
            self.stats.observe_lanes(self._lanes, grew=True)

    def __iter__(self):
        # thread-handoff token: the consumer thread drives iteration from
        # inside fit's epoch span; the producer + lane threads parent their
        # spans here so one trace id covers fit → assemble → h2d
        self._trace_token = _trace.token()
        q = _FlexQueue(self._depth)
        self.stats.observe_depth(q.capacity)
        err: list = []
        t = threading.Thread(target=self._producer, args=(q, err),
                             daemon=True, name="zoo-infeed-pump")
        t.start()
        first = True
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                wait = time.perf_counter() - t0
                if item is _STOP or item is None:
                    break
                # the first get always waits on pipeline warmup — not a
                # steady-state starvation signal
                if not first:
                    self.stats.add("stall", wait)
                    if wait > 1e-4 and t.is_alive():
                        # consumer starved while the producer still runs:
                        # deepen the buffer (bounded by the memory budget)
                        # and/or open another transfer lane
                        self._maybe_grow(q, item)
                first = False
                yield item
        finally:
            q.close()                   # unblocks the producer's put()
            t.join(timeout=30)
            if t.is_alive():
                import logging
                logging.getLogger("analytics_zoo_tpu_torch").warning(
                    "infeed producer did not stop; abandoning its thread")
        if err:
            raise err[0]
