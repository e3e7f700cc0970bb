"""The low-level pipeline Estimator (counterpart of ``analytics_zoo_tpu/
pipeline/estimator/estimator.py``): a model and an optimizer, stepped one
minibatch at a time by the caller's loop (``train_minibatch``) or over a
dataset (``train``).

It runs on the port's ``TPUEstimator`` (built per loss, on ``cuda``
unless ``device="cpu"``), whose module keeps its weights between
estimators. Gradient clipping: ``set_constant_gradient_clipping(min,
max)`` clips each gradient entry to ``[-c, c]`` with ``c = max(|min|,
|max|)`` (optax ``clip``, as the JAX class builds it), and
``set_l2_norm_gradient_clipping(n)`` rescales the gradients to a global
norm of at most ``n``, both before the optimizer's update. As in the JAX
class, whose setters each wrap ``optax.chain(clip, optimizer)``, the
clippings stack and the latest setter's applies first; a setter starts a
fresh optimizer state, and ``clear_gradient_clipping`` raises: construct
a new Estimator instead.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np

from ...common.context import resolve_device
from ...orca.learn.estimator import TPUEstimator
from ...orca.learn.utils import Batch


class Estimator:
    def __init__(self, model, optim_methods=None,
                 model_dir: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.optim = optim_methods or "sgd"
        self.model_dir = model_dir
        self._est: Optional[TPUEstimator] = None
        self._loss = None
        self._clips: List[tuple] = []      # in call order

    def _estimator_for(self, loss, metrics=None) -> TPUEstimator:
        if self._est is None or self._loss is not loss:
            self._est = TPUEstimator(self.model, loss=loss,
                                     optimizer=self.optim, metrics=metrics,
                                     model_dir=self.model_dir,
                                     device=self.device)
            self._est.engine.set_clip_chain(reversed(self._clips))
            self._loss = loss
        return self._est

    def train_minibatch(self, x, y, loss="mean_squared_error") -> float:
        """One optimizer step on one minibatch; returns its loss."""
        eng = self._estimator_for(loss).engine
        x = (x,) if not isinstance(x, (tuple, list)) else tuple(x)
        y = (y,) if not isinstance(y, (tuple, list)) else tuple(y)
        n = np.asarray(x[0]).shape[0]
        batch = Batch(x=tuple(np.asarray(a) for a in x),
                      y=tuple(np.asarray(a) for a in y),
                      w=np.ones(n, np.float32))
        eng.materialize(batch)
        eng.build()
        return float(eng.train_batch(batch))

    def train(self, train_set: Iterable, criterion="mean_squared_error",
              end_trigger=None, checkpoint_trigger=None,
              validation_set=None, validation_method=None,
              batch_size: int = 32, epochs: int = 1) -> List[float]:
        """``train_set``: an iterable of ``(x, y)`` minibatches (one loss
        a step) or a ``{'x', 'y'}`` dict (through ``TPUEstimator.fit``:
        one mean loss an epoch)."""
        if isinstance(train_set, dict):
            stats = self._estimator_for(criterion).fit(
                train_set, epochs=epochs, batch_size=batch_size,
                verbose=False)
            return [s["train_loss"] for s in stats]
        losses = []
        for _ in range(epochs):
            for x, y in train_set:
                losses.append(self.train_minibatch(x, y, loss=criterion))
        return losses

    def evaluate(self, validation_set, validation_method=None,
                 batch_size: int = 32) -> Dict[str, float]:
        est = TPUEstimator(self.model,
                           loss=self._loss or "mean_squared_error",
                           optimizer=self.optim, metrics=validation_method,
                           device=self.device)
        return est.evaluate(validation_set, batch_size=batch_size,
                            verbose=False)

    def _add_clip(self, *clip):
        self._clips.append(clip)
        self._est = None            # a fresh optimizer state, as in JAX
        return self

    def set_constant_gradient_clipping(self, min_value: float,
                                       max_value: float):
        c = max(abs(min_value), abs(max_value))
        return self._add_clip("value", -c, c)

    def set_l2_norm_gradient_clipping(self, clip_norm: float):
        return self._add_clip("norm", clip_norm)

    def clear_gradient_clipping(self):
        raise NotImplementedError(
            "construct a fresh Estimator to clear clipping, as in the JAX "
            "package")
