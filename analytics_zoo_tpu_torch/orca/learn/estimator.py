"""The Orca estimator (counterpart of ``analytics_zoo_tpu/orca/learn/
estimator.py``) over the one-device ``TrainEngine``.

``TPUEstimator`` keeps the JAX package's name so a reader finds the
counterpart; it trains a torch ``nn.Module`` on ``cuda`` unless the caller
passes ``device="cpu"`` (and raises without a GPU). ``fit``, ``evaluate``,
``predict``, the gradient-clipping setters, ``save``/``load`` and the stats
dicts follow the JAX estimator: each epoch of ``fit`` returns ``{"epoch",
"train_loss", "num_samples", "time_s"}``, with ``val_*`` keys when
``validation_data`` is given.

Planes, as in the JAX estimator:

* **checkpoint** (``ckpt/``): ``model_dir`` with a ``checkpoint_trigger``
  saves through a ``CheckpointPlane`` (async, atomic, in the JAX package's
  on-disk format); ``save_checkpoint``/``load_checkpoint``/
  ``latest_checkpoint``/``flush_checkpoints``; a failing epoch is retried
  from the latest committed checkpoint up to ``max_failure_retries``
  times. ``load_checkpoint`` also takes a directory the JAX package wrote,
  converted through ``interop``. Config keys ``ckpt_async``,
  ``ckpt_keep_last_k``, ``ckpt_keep_best_k``, ``ckpt_metric_mode``,
  ``ckpt_passphrase``, ``ckpt_max_inflight`` and ``ckpt_fsync`` tune it.
* **preemption** (``orca/learn/preemption.py``): a fit that can recover
  (``model_dir`` and a trigger or a retry count) latches SIGTERM, ends
  the epoch at the current step, checkpoints at once (flushed, with one
  blocking retry) and returns, the last epoch's stats flagged
  ``preempted`` and ``partial_epoch``.
* **host to device** (``native/``): batches come through the infeed pump
  (config ``infeed_depth``, ``infeed_workers``); ``data_pipeline_stats()``
  gives the stage counters, with the checkpoint plane's under ``"ckpt"``.
* **prologue**: ``prologue=`` (or config ``prologue``) runs a
  ``BatchPrologue`` at the start of every step.

``fit``, ``evaluate`` and ``predict`` take the inputs of
``orca/learn/utils.data_to_iterator``: arrays, XShards with
``feature_cols``/``label_cols`` and creator functions.

**Fused dispatch** (config ``steps_per_dispatch``: ``"auto"`` by default,
an int pins k, 1 disables), as in the JAX estimator: ``fit`` and
``evaluate`` run k steps per dispatch over stacked superbatches
(``TrainEngine.train_batch_group``: one CUDA-graph replay on the card, k
eager steps on the CPU), with the same trajectory as the per-step loop.
``"auto"`` times real steps (rolled back: parameters, optimizer state,
step, default generators and the iterator's shuffle counter end as if
the probe never ran) and sizes k so a group runs about 0.25 s
(``utils.auto_fuse_factor``); a step estimated at 10 ms or more of
compute (``utils.estimate_step_compute_s``, on the card) stays unfused.
k is capped by the superbatch bytes (``utils.MAX_GROUP_BYTES``), the
checkpoint trigger's ``fuse_cap()`` and the epoch length; the ragged tail
runs as single padded steps; triggers, preemption and TensorBoard are
observed at group boundaries. An iterator without ``supports_fused`` (an
``ImageNetPipeline``), an explicit ``steps_per_epoch`` and a module the
engine's ``graph_gate`` refuses on the card run unfused (the reason in
each epoch's stats as ``unfused_reason``). The probed k is
cached per input signature on the estimator; the JAX compile plane's
persisted probe result (``cache.get_aux("fuse")``) waits for ROADMAP A12.

**TensorBoard**: ``set_tensorboard(log_dir, app_name)`` writes each train
step's loss as the scalar ``Loss`` (step: the iteration) under
``<log_dir>/<app_name>/train`` at the end of each epoch, and each
numeric validation result at the epoch's last iteration under
``.../validation``, in the JAX package's events format
(``utils/tensorboard.py``); ``get_train_summary(tag)`` and
``get_validation_summary(tag)`` read them back as ``[(step, value)]``.

``Estimator.from_keras`` (and its alias ``from_jax``) builds a
``TPUEstimator`` from a module or a creator, as in the JAX package.

**Profiling**: ``fit(profile=True)`` adds per-step times to each epoch's
stats; ``fit(profile=<dir>)`` adds them too and traces the first epoch
(only) with ``torch.profiler`` into ``<dir>``, as the JAX estimator traces
its first epoch with ``jax.profiler``. The trace is a torch chrome trace
(``<worker>.<ms>.pt.trace.json``, TensorBoard's profiler-plugin layout),
not an xplane. On the card a fused epoch's groups are CUDA-graph replays:
the trace holds one ``cudaGraphLaunch`` a replay on the host and each
replayed kernel as a device record of its own, carrying that launch's
correlation id; the optimizer's ``Optimizer.step#`` ranges appear only
for eager and captured steps.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ...common.context import resolve_device
from ...native.infeed import PipelineStats
from ...obs import trace as _trace
from ...resilience.watchdog import watched
from ..data.shard import HostXShards
from . import utils as learn_utils
from .engine import TrainEngine
from .losses import convert_loss
from .metrics import convert_metrics_list
from .optimizers.optimizers_impl import convert_optimizer
from .preemption import PreemptionWatcher
from .trigger import TrainerState, Trigger

logger = logging.getLogger("analytics_zoo_tpu_torch")


class _StepTimer:
    """Per-step times for ``fit(profile=True)``: CUDA events on the current
    stream (the step's span on the device timeline, read once at the end
    of the epoch), or host wall time on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def start(self):
        self.marks.append([self._mark(), None, 1])

    def stop(self, steps: int = 1):
        """End the dispatch started last; it ran ``steps`` steps."""
        self.marks[-1][1] = self._mark()
        self.marks[-1][2] = steps

    def read(self) -> List[float]:
        """One time per step: a fused group's time is split evenly over
        its steps."""
        if self.cuda and self.marks:
            self.marks[-1][1].synchronize()
        out = []
        for a, b, k in self.marks:
            ms = (b - a) * 1e3 if not self.cuda else a.elapsed_time(b)
            out.extend([ms / k] * k)
        return out


def _start_trace(trace_dir: str, device: torch.device):
    """A started ``torch.profiler`` session that writes its chrome trace
    into ``trace_dir`` when stopped (the CPU's activity, and the card's
    on a ``cuda`` device)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(trace_dir))
    prof.start()
    return prof


def _draw_sample(it):
    """Draw the first batch of an unshuffled inline epoch, as the JAX
    estimator does to build its engine in ``fit`` and ``evaluate``, and
    return it. The draw advances the iterator's epoch counter (a
    ``BatchIterator``'s ``_epoch``, an ``ImageNetPipeline``'s
    ``_epoch_idx``) as it does there, so epoch e of a fit shuffles and
    crops with seed + e + 1 in both."""
    gen = it.epoch(shuffle=False, prefetch=False)
    sample = next(gen, None)
    gen.close()
    return sample


def _host_rows(preds, w):
    """The predictions' real rows (``w`` > 0; all without ``w``) on the
    host: the predict loop's wait on the card."""
    keep = slice(None) if w is None else w.cpu().numpy() > 0
    return tuple(p.cpu().numpy()[keep] for p in preds)


class Estimator:
    """Factory namespace, as the JAX package's ``Estimator`` (``from_torch``
    is in ``orca.learn.pytorch``)."""

    @staticmethod
    def from_keras(model_creator: Optional[Callable] = None, *,
                   model: Optional[torch.nn.Module] = None,
                   config: Optional[dict] = None, loss=None,
                   optimizer="adam", metrics=None,
                   model_dir: Optional[str] = None, backend: str = "gpu",
                   workers_per_node: int = 1, seed: int = 0, prologue=None,
                   device=None) -> "TPUEstimator":
        """An estimator over ``model``, an ``nn.Module``, or over what
        ``model_creator(config)`` returns: a module, or a tuple
        ``(module, loss, optimizer)``. ``backend`` and
        ``workers_per_node`` are accepted for source compatibility."""
        module = model if model is not None else model_creator(config or {})
        if isinstance(module, tuple):
            module, loss, optimizer = module
        if not isinstance(module, torch.nn.Module):
            raise TypeError(f"from_keras takes a torch.nn.Module (a Keras "
                            f"model's to_module()), not "
                            f"{type(module).__name__}")
        return TPUEstimator(module, loss=loss, optimizer=optimizer,
                            metrics=metrics, model_dir=model_dir,
                            config=config, seed=seed, device=device,
                            prologue=prologue)

    @staticmethod
    def from_jax(module=None, **kwargs) -> "TPUEstimator":
        return Estimator.from_keras(model=module, **kwargs)

    @staticmethod
    def latest_checkpoint(model_dir: str) -> Optional[str]:
        path, _ = learn_utils.find_latest_checkpoint(model_dir)
        return path


class TPUEstimator:
    """Trains, evaluates and predicts with one ``nn.Module`` on one
    device."""

    def __init__(self, module: torch.nn.Module, loss=None, optimizer="adam",
                 metrics=None, model_dir: Optional[str] = None,
                 config: Optional[dict] = None, seed: int = 0,
                 device=None, prologue=None):
        self.device = resolve_device(device)
        self.module = module.to(self.device)
        self.config = config or {}
        self.model_dir = model_dir
        self.loss_fn = convert_loss(loss) if loss is not None else None
        self.metrics = convert_metrics_list(metrics)
        if prologue is None:
            prologue = self.config.get("prologue")
        self.engine = TrainEngine(self.module, convert_optimizer(optimizer),
                                  self.loss_fn, self.metrics, self.device,
                                  seed=seed, prologue=prologue)
        # one stats object spans the iterator's assembly, the pump's
        # transfers and the engine's steps
        self._pipeline_stats = PipelineStats()
        self.engine.pipeline_stats = self._pipeline_stats
        self._trainer_state = TrainerState()
        self.train_stats: List[Dict[str, float]] = []
        self._ckpt_plane = None
        self._tb_dir: Optional[str] = None
        self._tb_train = None
        self._tb_val = None
        self._fuse_probe_cache: Dict[Any, int] = {}
        self.fuse = 1                   # k of the last fit (1: unfused)
        self.unfused_reason: Optional[str] = None   # the graph gate's
        self.eval_fuse = 1              # k of the last evaluate
        self.probe_steps = 0            # rolled-back train probe steps

    @staticmethod
    def latest_checkpoint(model_dir: str) -> Optional[str]:
        path, _ = learn_utils.find_latest_checkpoint(model_dir)
        return path

    # --- checkpoint plane ---------------------------------------------------
    def _ckpt(self, model_dir: str):
        """The CheckpointPlane for ``model_dir`` (one per estimator; rebound
        if a caller switches directories)."""
        from ...ckpt import CheckpointPlane
        if self._ckpt_plane is None or self._ckpt_plane.root != model_dir:
            if self._ckpt_plane is not None:
                self._ckpt_plane.close()
            cfg = self.config
            self._ckpt_plane = CheckpointPlane(
                model_dir,
                keep_last_k=cfg.get("ckpt_keep_last_k"),
                keep_best_k=cfg.get("ckpt_keep_best_k"),
                metric_mode=cfg.get("ckpt_metric_mode", "min"),
                passphrase=cfg.get("ckpt_passphrase"),
                async_save=bool(cfg.get("ckpt_async", True)),
                max_inflight=int(cfg.get("ckpt_max_inflight", 2)),
                fsync=bool(cfg.get("ckpt_fsync", True)))
        return self._ckpt_plane

    def flush_checkpoints(self, timeout: Optional[float] = None) -> bool:
        """Drain pending async checkpoint writes (no-op without a plane)."""
        if self._ckpt_plane is None:
            return True
        return self._ckpt_plane.flush(timeout)

    def save_checkpoint(self, model_dir: str, blocking: bool = False,
                        meta: Optional[Dict] = None) -> str:
        """Checkpoint through the plane: per-leaf content-addressed blobs
        and a manifest, committed atomically; by default written behind
        training on the plane's writer thread."""
        plane = self._ckpt(model_dir)
        self.engine.build()
        path = plane.save(self.engine.get_state(), self.engine.step,
                          score=self._trainer_state.score, meta=meta,
                          blocking=blocking)
        logger.info("checkpoint %s: %s",
                    "saved" if blocking else "queued", path)
        return path

    def load_checkpoint(self, model_dir: str,
                        step: Optional[int] = None) -> str:
        """Restore the newest committed checkpoint (or exactly ``step``),
        skipping uncommitted or corrupt ones; returns the path restored. A
        checkpoint the JAX package wrote is converted through ``interop``
        (parameters, and the optimizer state of Adam, AdamW or SGD)."""
        plane = self._ckpt(model_dir)
        try:
            path, state = plane.restore(step=step)
        except FileNotFoundError:
            raise FileNotFoundError(f"no checkpoint under {model_dir}")
        from_jax = "extra_vars" in state    # written by the JAX package
        if from_jax:
            from ... import interop
            params = interop.state_from_jax(state, self.module,
                                            None)["params"]
        else:
            params = state["params"]
        self.engine.materialize(state_dict=params)
        self.engine.build()
        if from_jax:
            state = interop.state_from_jax(state, self.module,
                                           self.engine.opt)
        self.engine.set_state(state)
        self._trainer_state.iteration = self.engine.step
        return path

    def shutdown(self):
        if self._ckpt_plane is not None:
            self._ckpt_plane.flush()
            self._ckpt_plane.close()
            self._ckpt_plane = None

    # --- pipeline observability ---------------------------------------------
    def data_pipeline_stats(self, reset: bool = False) -> Dict[str, Any]:
        """Cumulative input-pipeline stage counters (``assemble_s``,
        ``h2d_s`` with ``h2d_bytes``/``h2d_MBps``, ``step_s``, ``stall_s``,
        ``transfer_limited``, depth and lanes), with the checkpoint plane's
        counters under ``"ckpt"`` once it exists and the resilience plane's
        under ``"resilience"`` once any fired."""
        snap = self._pipeline_stats.snapshot()
        if self._ckpt_plane is not None:
            snap["ckpt"] = self._ckpt_plane.stats.snapshot()
        from ...resilience.stats import resilience_snapshot
        res = resilience_snapshot()
        if res:
            # resilience-plane counters (process-wide: faults fired,
            # watchdog trips, supervisor restarts, retries) — omitted on
            # healthy runs so existing consumers see no new key
            snap["resilience"] = res
        if reset:
            self._pipeline_stats.reset()
        return snap

    # --- gradient clipping --------------------------------------------------
    def set_constant_gradient_clipping(self, min_value: float,
                                       max_value: float):
        self.engine.set_gradient_clipping(min_value=min_value,
                                          max_value=max_value)
        return self

    def set_l2_norm_gradient_clipping(self, clip_norm: float):
        self.engine.set_gradient_clipping(norm=clip_norm)
        return self

    def clear_gradient_clipping(self):
        self.engine.clear_gradient_clipping()
        return self

    # --- tensorboard --------------------------------------------------------
    def set_tensorboard(self, log_dir: str, app_name: str):
        from ...utils.tensorboard import FileWriter
        self._tb_dir = os.path.join(log_dir, app_name)
        self._tb_train = FileWriter(os.path.join(self._tb_dir, "train"))
        self._tb_val = FileWriter(os.path.join(self._tb_dir, "validation"))
        return self

    def _summary(self, writer, sub: str, tag: str):
        from ...utils.tensorboard import read_scalars
        if writer is None:
            return []
        writer.flush()
        return read_scalars(os.path.join(self._tb_dir, sub)).get(tag, [])

    def get_train_summary(self, tag: str = "Loss"):
        return self._summary(self._tb_train, "train", tag)

    def get_validation_summary(self, tag: str):
        return self._summary(self._tb_val, "validation", tag)

    # --- fit ----------------------------------------------------------------
    def _iterator(self, data, batch_size, feature_cols, label_cols,
                  shuffle) -> learn_utils.BatchIterator:
        return learn_utils.data_to_iterator(
            data, batch_size, feature_cols, label_cols, shuffle=shuffle,
            config=self.config, device=self.device,
            stats=self._pipeline_stats)

    def fit(self, data, epochs: int = 1, batch_size: int = 32,
            feature_cols=None, label_cols=None, validation_data=None,
            session_config=None,
            checkpoint_trigger: Optional[Trigger] = None,
            steps_per_epoch: Optional[int] = None, shuffle: bool = True,
            verbose: bool = True, callbacks=None, profile=False,
            max_failure_retries: Optional[int] = None,
            initial_epoch: int = 0) -> List[Dict[str, float]]:
        """Train for ``epochs`` epochs (or ``steps_per_epoch`` steps each).
        ``profile=True`` adds per-step times to each epoch's stats: the
        host's wait for each batch, and each step's time (``step_ms``) from
        CUDA events recorded on the stream as the step starts and ends, so
        the host is never stalled (wall time on the CPU). ``profile`` a
        directory does the same and writes a ``torch.profiler`` trace of
        the first epoch there.

        With ``model_dir`` and a ``checkpoint_trigger`` the trigger saves
        checkpoints; with a trigger or ``max_failure_retries`` (default 5)
        a failing epoch is retried from the latest checkpoint, as in the
        JAX estimator. ``fit`` returns only once every queued checkpoint is
        durable. Such a recoverable fit also handles SIGTERM as a
        preemption notice: it checkpoints at the current step and returns
        early, the last stats carrying ``preempted`` and ``partial_epoch``.

        ``initial_epoch`` offsets the shuffle's epoch counter, as in the JAX
        estimator: a run resumed from a checkpoint with it draws the batch
        order of the uninterrupted run's later epochs."""
        it = self._iterator(data, batch_size, feature_cols, label_cols,
                            shuffle)
        if initial_epoch:
            for counter in ("_epoch", "_epoch_idx"):
                if hasattr(it, counter):
                    setattr(it, counter, int(initial_epoch))
        self.engine.materialize(_draw_sample(it))
        self.engine.build()
        self.unfused_reason = self.engine.graph_gate()
        trigger = (Trigger.convert_trigger(checkpoint_trigger)
                   if checkpoint_trigger else None)
        if trigger is not None:
            trigger.arm(self._trainer_state)
        opted_in = (trigger is not None or max_failure_retries is not None
                    or "max_failure_retries" in self.config)
        retries_left = (self.config.get("max_failure_retries", 5)
                        if max_failure_retries is None
                        else max_failure_retries)
        can_recover = (self.model_dir is not None and retries_left > 0
                       and opted_in)
        if can_recover and learn_utils.find_latest_checkpoint(
                self.model_dir)[0] is None:
            # a restore point exists before the first step
            self.save_checkpoint(self.model_dir)
        try:
            fuse = self._choose_fuse(it, steps_per_epoch, trigger)
        except (KeyboardInterrupt, SystemExit):
            raise
        except (ValueError, TypeError):
            raise           # config and validation errors surface
        except Exception as e:
            # the auto probe runs real (rolled-back) steps before the fit
            # loop's retry handler exists: a recoverable fit trains
            # unfused, as in the JAX estimator
            if not can_recover:
                raise
            logger.warning("fuse probe failed (%s: %s); training unfused",
                           type(e).__name__, e)
            fuse = 1
        self.fuse = fuse
        watcher = PreemptionWatcher() if can_recover else None
        try:
            with (watcher if watcher is not None
                  else contextlib.nullcontext()):
                # root span of the training trace (obs plane): epoch,
                # dispatch, infeed-lane and ckpt-writer spans chain under
                # this trace id
                with _trace.span("fit", epochs=epochs,
                                 initial_epoch=initial_epoch):
                    return self._fit_loop(
                        it, epochs, steps_per_epoch, batch_size,
                        feature_cols, label_cols, validation_data, trigger,
                        profile, verbose, can_recover, retries_left,
                        watcher, fuse)
        finally:
            # a failed async write gets one blocking retry
            if not self.flush_checkpoints() and self.model_dir is not None:
                try:
                    self.save_checkpoint(self.model_dir, blocking=True)
                except Exception as save_err:       # noqa: BLE001
                    logger.error("final checkpoint could not be written "
                                 "(%s)", save_err)

    # --- fused dispatch -----------------------------------------------------
    def _fuse_cfg(self):
        """Config ``steps_per_dispatch``, parsed once for fit and evaluate:
        "auto" (default) or a pinned positive int (1 disables fusion)."""
        cfg = self.config.get("steps_per_dispatch", "auto")
        if cfg == "auto":
            return "auto"
        return max(1, int(cfg)) if cfg else 1

    @staticmethod
    def _iter_batch_bytes(it) -> int:
        row_bytes = sum(int(np.asarray(a[:1]).nbytes)
                        for a in tuple(it.x) + tuple(it.y or ()))
        return row_bytes * it.local_bs

    @staticmethod
    def _probe_key(kind: str, it):
        return (kind, it.local_bs) + tuple(
            (np.asarray(a[:1]).shape[1:], str(np.asarray(a[:1]).dtype))
            for a in tuple(it.x) + tuple(it.y or ()))

    @staticmethod
    def _apply_fuse_caps(k, batch_bytes, steps, trigger=None) -> int:
        """Caps shared by the pinned and auto paths, for train and eval:
        superbatch memory, checkpoint cadence, epoch length."""
        if batch_bytes > 0:
            byte_cap = max(learn_utils.MAX_GROUP_BYTES // batch_bytes, 1)
            if k > byte_cap:
                logger.warning(
                    "steps_per_dispatch %d capped to %d so a stacked "
                    "superbatch stays under %dMB", k, byte_cap,
                    learn_utils.MAX_GROUP_BYTES >> 20)
                k = byte_cap
        # never fuse past the trigger's interval (a composite reports its
        # tightest child's)
        cap = trigger.fuse_cap() if trigger is not None else None
        if cap:
            k = min(k, cap)
        return max(1, min(k, steps))

    def _graph_refused(self) -> bool:
        """Whether the engine's graph gate keeps this module unfused on the
        card (logged; ``fit`` read the gate into ``unfused_reason``)."""
        reason = self.unfused_reason
        if reason is not None:
            logger.warning("training unfused on %s: %s", self.device, reason)
        return reason is not None

    def _choose_fuse(self, it, steps_per_epoch, trigger=None) -> int:
        """The fusion factor of this fit: 1 for an iterator without
        ``supports_fused``, an explicit ``steps_per_epoch`` or a module the
        graph gate refuses; else config ``steps_per_dispatch`` pinned, or
        ``"auto"`` probed once per input signature; then capped."""
        if not getattr(it, "supports_fused", False) or \
                steps_per_epoch is not None:
            return 1
        if self._graph_refused():
            return 1
        cfg = self._fuse_cfg()
        batch_bytes = self._iter_batch_bytes(it)
        if cfg != "auto":
            k = cfg
        elif it.steps_per_epoch < 2:
            return 1
        else:
            key = self._probe_key("train", it)
            k = self._fuse_probe_cache.get(key)
            if k is None:
                k = self._auto_probe_fuse(it, batch_bytes)
                self._fuse_probe_cache[key] = k
        return self._apply_fuse_caps(k, batch_bytes, it.steps_per_epoch,
                                     trigger)

    def _sync(self):
        """Wait for the work queued so far (the probes' timing)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _auto_probe_fuse(self, it, batch_bytes: int) -> int:
        """Time the pipelined loop of real train steps, then roll the
        engine back to a snapshot: the probe leaves the trajectory as if
        it never ran. On the card the first probe step is counted for its
        FLOPs (``estimate_step_compute_s``); a compute-dominated step (>=
        10 ms) stays unfused without the timing."""
        eng = self.engine
        # the probe's epoch must not advance the shuffle counter: restore
        # it on every exit
        epoch_counter = getattr(it, "_epoch", None)
        gen = it.epoch(shuffle=False, prefetch=False)
        snap = None
        try:
            b0 = next(gen)
            m = max(2, min(6, it.steps_per_epoch - 1,
                           int((64 << 20) // max(batch_bytes, 1)) or 2))
            probe = [b0]
            for _ in range(m):
                b = next(gen, None)
                if b is None:
                    break
                probe.append(b)       # the copy happens here, untimed
            snap = eng.snapshot()
            steps0 = eng.step
            compute_s = learn_utils.estimate_step_compute_s(
                lambda: eng.train_batch(b0), self.device)
            if compute_s is not None and compute_s >= 0.01:
                return 1              # compute-dominated
            if compute_s is None:
                eng.train_batch(b0)   # built and warm
            self._sync()
            dt = float("inf")
            for _ in range(2):        # min of 2 washes out spikes
                t0 = time.perf_counter()
                for i in range(m):
                    eng.train_batch(probe[i % len(probe)])
                self._sync()
                dt = min(dt, (time.perf_counter() - t0) / m)
        finally:
            if snap is not None:
                self.probe_steps += eng.step - steps0
                eng.restore_snapshot(snap)
            gen.close()
            if epoch_counter is not None:
                it._epoch = epoch_counter
        k = learn_utils.auto_fuse_factor(dt, it.steps_per_epoch,
                                         batch_bytes=batch_bytes,
                                         compute_s=compute_s)
        if k > 1:
            logger.info("fusing %d train steps per dispatch "
                        "(pipelined probe %.2f ms/step)", k, dt * 1e3)
        return k

    def _choose_eval_fuse(self, it, sample, num_steps) -> int:
        """The fusion factor of ``evaluate``: evaluation changes nothing but
        its metric states, so the probe times real steps on ``sample``
        and drops their states. The probed k is cached per input
        signature (``fit(validation_data=)`` evaluates every epoch);
        ``num_steps`` keeps the per-step loop."""
        if not getattr(it, "supports_fused", False) or \
                num_steps is not None or it.steps_per_epoch < 2:
            return 1
        if self.engine.graph_gate(training=False) is not None:
            return 1
        cfg = self._fuse_cfg()
        batch_bytes = self._iter_batch_bytes(it)
        if cfg != "auto":
            k = cfg
        else:
            key = self._probe_key("eval", it)
            k = self._fuse_probe_cache.get(key)
            if k is None:
                k = self._auto_probe_eval_fuse(it, sample, batch_bytes)
                self._fuse_probe_cache[key] = k
        return self._apply_fuse_caps(k, batch_bytes, it.steps_per_epoch)

    def _auto_probe_eval_fuse(self, it, sample, batch_bytes: int) -> int:
        eng = self.engine
        sample = sample.to(self.device)
        states = eng.init_metric_states()
        compute_s = learn_utils.estimate_step_compute_s(
            lambda: eng.eval_batch(states, sample), self.device)
        if compute_s is not None and compute_s >= 0.01:
            return 1
        states, _, _ = eng.eval_batch(states, sample)    # warm
        self._sync()
        dt = float("inf")
        m = 6
        for _ in range(2):          # min of 2 washes out spikes
            t0 = time.perf_counter()
            for _ in range(m):
                states, _, _ = eng.eval_batch(states, sample)
            self._sync()
            dt = min(dt, (time.perf_counter() - t0) / m)
        return learn_utils.auto_fuse_factor(dt, it.steps_per_epoch,
                                            batch_bytes=batch_bytes,
                                            compute_s=compute_s)

    def _fit_loop(self, it, epochs, steps_per_epoch, batch_size,
                  feature_cols, label_cols, validation_data, trigger,
                  profile, verbose, can_recover, retries_left, watcher,
                  fuse=1):
        epoch_stats = []
        ep = 0
        while ep < epochs:
            try:
                with _trace.span("epoch", epoch=ep):
                    stats = self._fit_epoch(it, ep, steps_per_epoch,
                                            trigger, profile, watcher, fuse)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                if not can_recover or retries_left <= 0:
                    raise
                retries_left -= 1
                path = self.load_checkpoint(self.model_dir)
                logger.warning(
                    "training failed at epoch %d (%s: %s); restored "
                    "checkpoint %s, retrying (%d retries left)",
                    ep + 1, type(e).__name__, e, path, retries_left)
                continue                 # re-run the failed epoch
            if watcher is not None and watcher.triggered:
                # preemption notice: checkpoint at once (the grace window is
                # short, so no validation first) and make it durable; the
                # epoch is partial and flagged so
                self.save_checkpoint(self.model_dir)
                if not self.flush_checkpoints():
                    # the async write failed: one blocking retry
                    try:
                        self.save_checkpoint(self.model_dir, blocking=True)
                    except Exception as save_err:   # noqa: BLE001
                        logger.error(
                            "preemption checkpoint could not be written "
                            "(%s); resume will use the previous restore "
                            "point", save_err)
                stats["preempted"] = True
                stats["partial_epoch"] = True
                epoch_stats.append(stats)
                logger.warning(
                    "stopping after a preemption notice "
                    "(checkpointed at step %d)", self.engine.step)
                break
            if validation_data is not None:
                val = self.evaluate(validation_data, batch_size=batch_size,
                                    feature_cols=feature_cols,
                                    label_cols=label_cols, verbose=False)
                stats.update({f"val_{k}": v for k, v in val.items()})
                self._trainer_state.score = val.get(
                    next(iter(self.metrics), "loss"), val.get("loss"))
                if self._tb_val is not None:
                    for k, v in val.items():
                        if isinstance(v, (int, float)):
                            self._tb_val.add_scalar(
                                k, float(v), self._trainer_state.iteration)
            if trigger and self.model_dir and trigger(self._trainer_state):
                self.save_checkpoint(self.model_dir)
            if verbose:
                logger.info("epoch %d: %s", ep + 1, stats)
            epoch_stats.append(stats)
            ep += 1
        self.train_stats.extend(epoch_stats)
        return epoch_stats

    def _fit_epoch(self, it, ep: int, steps_per_epoch: Optional[int],
                   trigger, profile, watcher=None,
                   fuse: int = 1) -> Dict[str, Any]:
        """One epoch of the hot loop; raises through to ``fit``'s retry.
        With ``fuse`` > 1 the iterator yields stacked superbatches and
        each dispatch runs ``fuse`` steps (``train_batch_group``); the
        trigger and the preemption watcher are checked between
        dispatches. ``profile`` a directory traces epoch 0 into it."""
        t0 = time.time()
        losses = []                # device scalars, or (k,) per group
        tb_steps = []
        nsteps = steps_per_epoch or it.steps_per_epoch
        timer = _StepTimer(self.device) if profile else None
        data_s = 0.0
        steps_done = 0
        tracer = (_start_trace(profile, self.device)
                  if isinstance(profile, str) and ep == 0 else None)
        batches = iter(it.epoch(fuse=fuse) if fuse > 1 else it.epoch())
        try:
            while fuse > 1 or steps_done < nsteps:
                td = time.perf_counter()
                batch = next(batches, None)
                if batch is None:
                    break
                data_s += time.perf_counter() - td
                if timer is not None:
                    timer.start()
                if batch.fused > 1:
                    loss = self.engine.train_batch_group(batch)
                else:
                    loss = self.engine.train_batch(batch)
                took = batch.fused
                if timer is not None:
                    timer.stop(took)
                steps_done += took
                losses.append(loss.reshape(-1))
                self._trainer_state.iteration += took
                if self._tb_train is not None:
                    it_now = self._trainer_state.iteration
                    tb_steps.extend(range(it_now - took + 1, it_now + 1))
                if trigger and self.model_dir:
                    self._trainer_state.epoch_finished = False
                    if trigger(self._trainer_state):
                        self.save_checkpoint(self.model_dir)
                if watcher is not None and watcher.triggered:
                    break        # preemption: end the epoch at this step
        finally:
            close = getattr(batches, "close", None)
            if close is not None:
                close()                 # stops the pump's threads
            if tracer is not None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)   # the last kernels
                tracer.stop()           # writes the trace
        # the host's wait on the card (a launch returns before the card
        # finishes): a watchdog section, so a wedged card is a hang
        host_losses = watched("engine.sync",
                              lambda: torch.cat(losses).cpu().numpy())
        if self._tb_train is not None:
            for step, lv in zip(tb_steps, host_losses):
                self._tb_train.add_scalar("Loss", float(lv), step)
            self._tb_train.flush()
        mean_loss = float(np.mean(host_losses))
        self._trainer_state.epoch += 1
        self._trainer_state.epoch_finished = True
        self._trainer_state.loss = mean_loss
        stats = {"epoch": ep + 1, "train_loss": mean_loss,
                 "num_samples": len(it.x[0]) if hasattr(it, "x") else None,
                 "time_s": round(time.time() - t0, 3)}
        if self.unfused_reason is not None:
            stats["unfused_reason"] = self.unfused_reason
        if timer is not None:
            step_ms = timer.read()
            n = max(len(host_losses), 1)
            stats["profile"] = {"mean_data_s": data_s / n,
                                "mean_step_s": sum(step_ms) / 1e3 / n,
                                "steps": len(host_losses),
                                "step_ms": step_ms}
        return stats

    # --- evaluate -----------------------------------------------------------
    def evaluate(self, data, batch_size: int = 32, feature_cols=None,
                 label_cols=None, num_steps: Optional[int] = None,
                 verbose: bool = True) -> Dict[str, float]:
        """Weighted mean loss over the real rows, the metrics, and
        ``num_samples``."""
        it = self._iterator(data, batch_size, feature_cols, label_cols,
                            False)
        sample = _draw_sample(it)
        self.engine.materialize(sample)
        fuse = self._choose_eval_fuse(it, sample, num_steps)
        self.eval_fuse = fuse
        states = self.engine.init_metric_states()
        losses, counts = [], []         # per step, in step order
        batches = (it.epoch(shuffle=False, fuse=fuse) if fuse > 1
                   else it.epoch(shuffle=False))
        for i, batch in enumerate(batches):
            if num_steps is not None and i >= num_steps:
                break
            if batch.fused > 1:
                states, batch_loss, n = self.engine.eval_batch_group(
                    states, batch)
            else:
                states, batch_loss, n = self.engine.eval_batch(states, batch)
            losses.append(batch_loss.reshape(-1))
            counts.append(n.reshape(-1))
        getattr(batches, "close", lambda: None)()
        loss_sum, count = watched(
            "engine.sync", lambda: (float(torch.cat(losses).sum()),
                                    float(torch.cat(counts).sum())))
        result = self.engine.finalize_metrics(states, loss_sum, count)
        if verbose:
            logger.info("validation: %s", result)
        return result

    # --- predict ------------------------------------------------------------
    def predict(self, data, batch_size: int = 32, feature_cols=None) -> Any:
        """An ndarray (a tuple of them for a module with several outputs),
        one row per input row: the padded tail rows are dropped. For
        XShards input, the XShards with each partition's rows under
        ``"prediction"``, as in the JAX estimator."""
        shards = learn_utils.xshards_from_arrays(data, feature_cols, None)
        it = learn_utils.BatchIterator(shards, batch_size, pad_tail=True,
                                       device=self.device,
                                       stats=self._pipeline_stats)
        outs = []
        for batch in it.epoch(shuffle=False):
            batch = batch.to(self.device)
            preds = self.engine.predict_batch(batch.x)
            multi = isinstance(preds, (list, tuple))
            preds = tuple(preds) if multi else (preds,)
            host = watched("engine.sync", _host_rows, preds, batch.w)
            outs.append(host if multi else host[0])
        if isinstance(outs[0], tuple):
            result = tuple(np.concatenate([o[i] for o in outs])
                           for i in range(len(outs[0])))
        else:
            result = np.concatenate(outs)
        if not isinstance(data, HostXShards):
            return result
        # cut the predictions back into the input's partitions
        parts, off = [], 0
        for part in shards.collect():
            n = len(part["x"][0])
            parts.append(tuple(r[off:off + n] for r in result)
                         if isinstance(result, tuple)
                         else result[off:off + n])
            off += n
        return learn_utils.update_predict_xshards(data, HostXShards(parts))

    # --- persistence --------------------------------------------------------
    def get_model(self) -> Dict[str, torch.Tensor]:
        return self.engine.get_state()["params"]

    def save(self, path: str) -> str:
        """Module, optimizer state and step, with ``torch.save``."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.save(self.engine.get_state(), path)
        return path

    def load(self, path: str) -> "TPUEstimator":
        self.engine.set_state(torch.load(path, map_location=self.device))
        return self
