"""TrainingOperator (counterpart of ``analytics_zoo_tpu/orca/learn/pytorch/
training_operator.py``): the user hook surface of the reference's Ray torch
path (``setup``, ``train_epoch``, ``train_batch``, ``validate``,
``predict_batch``, ``state_dict``/``load_state_dict``, and the ``config``,
``model``, ``optimizer``, ``world_rank`` and ``criterion`` properties).

The default hooks delegate to the estimator's ``TrainEngine``; a subclass
that overrides ``train_batch`` adds its own per-batch logic around the
engine's step (logging, a curriculum) and calls ``super()`` for the step.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator

import numpy as np


class TrainingOperator:
    def __init__(self, config: Dict, engine, world_rank: int = 0):
        self._config = config
        self._engine = engine
        self._world_rank = world_rank
        self.setup(config)

    # --- overridable hooks --------------------------------------------------
    def setup(self, config: Dict):
        """Called once, when the operator is made."""

    def train_epoch(self, iterator: Iterator, info: Dict) -> Dict[str, float]:
        """Train on every batch of ``iterator`` through :meth:`train_batch`;
        the epoch's mean loss and its count of real rows."""
        losses, n = [], 0
        for batch_idx, batch in enumerate(iterator):
            m = self.train_batch(batch, {"batch_idx": batch_idx, **info})
            losses.append(m["train_loss"])
            n += m.get("num_samples", 0)
        return {"train_loss": float(np.mean(losses)) if losses else 0.0,
                "num_samples": n}

    def train_batch(self, batch, batch_info: Dict) -> Dict[str, float]:
        """One engine step: the loss as a Python float, and the batch's
        real rows (its padded tail rows carry weight 0)."""
        loss = self._engine.train_batch(batch)
        n = (len(batch.x[0]) if batch.w is None     # None: no padding
             else int(batch.w.sum()))
        return {"train_loss": float(loss), "num_samples": n}

    def validate(self, val_iterator: Iterator, info: Dict, metrics
                 ) -> Dict[str, float]:
        """The weighted mean loss and the metrics over ``val_iterator``."""
        states = self._engine.init_metric_states()
        loss_sum, count = 0.0, 0.0
        for batch in val_iterator:
            states, bl, n = self._engine.eval_batch(states, batch)
            loss_sum += float(bl)
            count += float(n)
        return self._engine.finalize_metrics(states, loss_sum, count)

    def predict_batch(self, batch):
        return self._engine.predict_batch(batch.x)

    def state_dict(self) -> Dict[str, Any]:
        return self._engine.get_state()

    def load_state_dict(self, state_dict: Dict[str, Any]):
        self._engine.set_state(state_dict)

    # --- properties ---------------------------------------------------------
    @property
    def config(self) -> Dict:
        return self._config

    @property
    def model(self):
        return self._engine.module

    @property
    def optimizer(self):
        return self._engine.opt

    @property
    def world_rank(self) -> int:
        return self._world_rank

    @property
    def criterion(self):
        return self._engine.loss_fn
