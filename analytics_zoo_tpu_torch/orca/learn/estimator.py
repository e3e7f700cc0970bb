"""The Orca estimator (counterpart of ``analytics_zoo_tpu/orca/learn/
estimator.py``) over the one-device ``TrainEngine``.

``TPUEstimator`` keeps the JAX package's name so a reader finds the
counterpart; it trains a torch ``nn.Module`` on ``cuda`` unless the caller
passes ``device="cpu"`` (and raises without a GPU). ``fit``, ``evaluate``,
``predict``, the gradient-clipping setters, ``save``/``load`` and the stats
dicts follow the JAX estimator: each epoch of ``fit`` returns ``{"epoch",
"train_loss", "num_samples", "time_s"}``, with ``val_*`` keys when
``validation_data`` is given.

Every step runs on its own (``fuse`` is always 1). Not ported yet: the
checkpoint plane (``model_dir``, ``checkpoint_trigger``,
``save_checkpoint``), retry from checkpoint, preemption, tensorboard and
XShards/pandas inputs; ``model_dir`` and ``checkpoint_trigger`` raise
instead of being ignored.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ...common.context import resolve_device
from . import utils as learn_utils
from .engine import TrainEngine
from .losses import convert_loss
from .metrics import convert_metrics_list
from .optimizers.optimizers_impl import convert_optimizer
from .trigger import TrainerState

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


class TPUEstimator:
    """Trains, evaluates and predicts with one ``nn.Module`` on one
    device."""

    def __init__(self, module: torch.nn.Module, loss=None, optimizer="adam",
                 metrics=None, model_dir: Optional[str] = None,
                 config: Optional[dict] = None, seed: int = 0,
                 device=None):
        if model_dir is not None:
            raise NotImplementedError("model_dir (the checkpoint plane) is "
                                      "not ported yet")
        self.device = resolve_device(device)
        self.module = module.to(self.device)
        self.config = config or {}
        self.loss_fn = convert_loss(loss) if loss is not None else None
        self.metrics = convert_metrics_list(metrics)
        self.engine = TrainEngine(self.module, convert_optimizer(optimizer),
                                  self.loss_fn, self.metrics, self.device,
                                  seed=seed)
        self._trainer_state = TrainerState()
        self.train_stats: List[Dict[str, float]] = []

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

    # --- fit ----------------------------------------------------------------
    def fit(self, data, epochs: int = 1, batch_size: int = 32,
            feature_cols=None, label_cols=None, validation_data=None,
            session_config=None, checkpoint_trigger=None,
            steps_per_epoch: Optional[int] = None, shuffle: bool = True,
            verbose: bool = True, callbacks=None, profile: bool = False,
            max_failure_retries: Optional[int] = None
            ) -> List[Dict[str, float]]:
        """Train for ``epochs`` epochs (or ``steps_per_epoch`` steps each).
        ``profile=True`` adds per-step times to each epoch's stats: the
        host's wait for each batch, and each step's time (``step_ms``) from
        CUDA events recorded on the stream as the step starts and ends, so
        the host is never stalled (wall time on the CPU).
        ``max_failure_retries`` only acts with a checkpoint to retry from,
        so without ``model_dir`` it changes nothing, as in the JAX
        estimator."""
        if checkpoint_trigger is not None:
            raise NotImplementedError("checkpoint_trigger (the checkpoint "
                                      "plane) is not ported yet")
        if isinstance(profile, str):
            raise NotImplementedError("profile=<trace dir> is not ported "
                                      "yet; profile=True is")
        it = learn_utils.data_to_iterator(data, batch_size, feature_cols,
                                          label_cols, shuffle=shuffle,
                                          config=self.config)
        # the JAX estimator draws a sample batch to build its engine, which
        # advances the iterator's shuffle-epoch counter: epoch e of a fit
        # shuffles with seed + e + 1 in both
        it._epoch += 1
        self.engine.build()
        epoch_stats = []
        for ep in range(epochs):
            stats = self._fit_epoch(it, ep, steps_per_epoch, profile)
            if validation_data is not None:
                val = self.evaluate(validation_data, batch_size=batch_size,
                                    feature_cols=feature_cols,
                                    label_cols=label_cols, verbose=False)
                stats.update({f"val_{k}": v for k, v in val.items()})
                self._trainer_state.score = val.get(
                    next(iter(self.metrics), "loss"), val.get("loss"))
            if verbose:
                logger.info("epoch %d: %s", ep + 1, stats)
            epoch_stats.append(stats)
        self.train_stats.extend(epoch_stats)
        return epoch_stats

    def _fit_epoch(self, it, ep: int, steps_per_epoch: Optional[int],
                   profile: bool) -> Dict[str, Any]:
        t0 = time.time()
        losses = []                    # device scalars, read at epoch end
        nsteps = steps_per_epoch or it.steps_per_epoch
        timer = _StepTimer(self.device) if profile else None
        data_s = 0.0
        batches = iter(it.epoch())
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
        host_losses = torch.stack(losses).cpu().numpy()
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
        it = learn_utils.data_to_iterator(data, batch_size, feature_cols,
                                          label_cols, shuffle=False,
                                          config=self.config)
        states = self.engine.init_metric_states()
        losses, counts = [], []
        for i, batch in enumerate(it.epoch(shuffle=False)):
            if num_steps is not None and i >= num_steps:
                break
            states, batch_loss, n = self.engine.eval_batch(states, batch)
            losses.append(batch_loss)
            counts.append(n)
        loss_sum = float(torch.stack(losses).sum())
        count = float(torch.stack(counts).sum())
        result = self.engine.finalize_metrics(states, loss_sum, count)
        if verbose:
            logger.info("validation: %s", result)
        return result

    # --- predict ------------------------------------------------------------
    def predict(self, data, batch_size: int = 32, feature_cols=None) -> Any:
        """An ndarray (a tuple of them for a module with several outputs),
        one row per input row: the padded tail rows are dropped."""
        shard = learn_utils.xshards_from_arrays(data, feature_cols, None)
        it = learn_utils.BatchIterator(shard, batch_size, pad_tail=True)
        outs = []
        for batch in it.epoch(shuffle=False):
            preds = self.engine.predict_batch(batch.x)
            multi = isinstance(preds, (list, tuple))
            preds = tuple(preds) if multi else (preds,)
            keep = (slice(None) if batch.w is None
                    else np.asarray(batch.w) > 0)
            host = tuple(p.cpu().numpy()[keep] for p in preds)
            outs.append(host if multi else host[0])
        if isinstance(outs[0], tuple):
            return tuple(np.concatenate([o[i] for o in outs])
                         for i in range(len(outs[0])))
        return np.concatenate(outs)

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
