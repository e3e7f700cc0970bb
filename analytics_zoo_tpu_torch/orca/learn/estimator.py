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
``feature_cols``/``label_cols`` and creator functions. Every step runs on
its own (``fuse`` is always 1).

**TensorBoard**: ``set_tensorboard(log_dir, app_name)`` writes each train
step's loss as the scalar ``Loss`` (step: the iteration) under
``<log_dir>/<app_name>/train`` at the end of each epoch, and each
numeric validation result at the epoch's last iteration under
``.../validation``, in the JAX package's events format
(``utils/tensorboard.py``); ``get_train_summary(tag)`` and
``get_validation_summary(tag)`` read them back as ``[(step, value)]``.

``Estimator.from_keras`` builds a ``TPUEstimator`` from a module or a
creator, as in the JAX package. Not ported yet: ``profile=<trace dir>``.
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
        self.marks.append([self._mark(), None])

    def stop(self):
        self.marks[-1][1] = self._mark()

    def read(self) -> List[float]:
        if not self.cuda:
            return [(b - a) * 1e3 for a, b in self.marks]
        if self.marks:
            self.marks[-1][1].synchronize()
        return [a.elapsed_time(b) for a, b in self.marks]


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
        counters under ``"ckpt"`` once it exists."""
        snap = self._pipeline_stats.snapshot()
        if self._ckpt_plane is not None:
            snap["ckpt"] = self._ckpt_plane.stats.snapshot()
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
            verbose: bool = True, callbacks=None, profile: bool = False,
            max_failure_retries: Optional[int] = None,
            initial_epoch: int = 0) -> List[Dict[str, float]]:
        """Train for ``epochs`` epochs (or ``steps_per_epoch`` steps each).
        ``profile=True`` adds per-step times to each epoch's stats: the
        host's wait for each batch, and each step's time (``step_ms``) from
        CUDA events recorded on the stream as the step starts and ends, so
        the host is never stalled (wall time on the CPU).

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
        if isinstance(profile, str):
            raise NotImplementedError("profile=<trace dir> is not ported "
                                      "yet; profile=True is")
        it = self._iterator(data, batch_size, feature_cols, label_cols,
                            shuffle)
        if initial_epoch:
            for counter in ("_epoch", "_epoch_idx"):
                if hasattr(it, counter):
                    setattr(it, counter, int(initial_epoch))
        self.engine.materialize(_draw_sample(it))
        self.engine.build()
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
        watcher = PreemptionWatcher() if can_recover else None
        try:
            with (watcher if watcher is not None
                  else contextlib.nullcontext()):
                return self._fit_loop(it, epochs, steps_per_epoch,
                                      batch_size, feature_cols, label_cols,
                                      validation_data, trigger, profile,
                                      verbose, can_recover, retries_left,
                                      watcher)
        finally:
            # a failed async write gets one blocking retry
            if not self.flush_checkpoints() and self.model_dir is not None:
                try:
                    self.save_checkpoint(self.model_dir, blocking=True)
                except Exception as save_err:       # noqa: BLE001
                    logger.error("final checkpoint could not be written "
                                 "(%s)", save_err)

    def _fit_loop(self, it, epochs, steps_per_epoch, batch_size,
                  feature_cols, label_cols, validation_data, trigger,
                  profile, verbose, can_recover, retries_left, watcher):
        epoch_stats = []
        ep = 0
        while ep < epochs:
            try:
                stats = self._fit_epoch(it, ep, steps_per_epoch, trigger,
                                        profile, watcher)
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
                   trigger, profile: bool, watcher=None) -> Dict[str, Any]:
        t0 = time.time()
        losses = []                    # device scalars, read at epoch end
        nsteps = steps_per_epoch or it.steps_per_epoch
        timer = _StepTimer(self.device) if profile else None
        data_s = 0.0
        batches = iter(it.epoch())
        try:
            while len(losses) < nsteps:
                td = time.perf_counter()
                batch = next(batches, None)
                if batch is None:
                    break
                data_s += time.perf_counter() - td
                if timer is not None:
                    timer.start()
                loss = self.engine.train_batch(batch)
                if timer is not None:
                    timer.stop()
                losses.append(loss)
                self._trainer_state.iteration += 1
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
        host_losses = torch.stack(losses).cpu().numpy()
        if self._tb_train is not None:
            first = self._trainer_state.iteration - len(host_losses) + 1
            for i, lv in enumerate(host_losses):
                self._tb_train.add_scalar("Loss", float(lv), first + i)
            self._tb_train.flush()
        mean_loss = float(np.mean(host_losses))
        self._trainer_state.epoch += 1
        self._trainer_state.epoch_finished = True
        self._trainer_state.loss = mean_loss
        stats = {"epoch": ep + 1, "train_loss": mean_loss,
                 "num_samples": len(it.x[0]) if hasattr(it, "x") else None,
                 "time_s": round(time.time() - t0, 3)}
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
        _draw_sample(it)
        states = self.engine.init_metric_states()
        losses, counts = [], []
        batches = it.epoch(shuffle=False)
        for i, batch in enumerate(batches):
            if num_steps is not None and i >= num_steps:
                break
            states, batch_loss, n = self.engine.eval_batch(states, batch)
            losses.append(batch_loss)
            counts.append(n)
        getattr(batches, "close", lambda: None)()
        loss_sum = float(torch.stack(losses).sum())
        count = float(torch.stack(counts).sum())
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
            keep = (slice(None) if batch.w is None
                    else batch.w.cpu().numpy() > 0)
            host = tuple(p.cpu().numpy()[keep] for p in preds)
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
