"""Common base for built-in models (counterpart of
``analytics_zoo_tpu/models/common/zoo_model.py``): a thin holder of an
``nn.Module`` that trains, evaluates and predicts through the port's
``TPUEstimator``.

The estimator runs on ``cuda`` unless ``device="cpu"`` is given, to the
model's constructor or to ``compile``.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch


class ZooModel:
    def __init__(self, module: torch.nn.Module, device=None):
        self.module = module
        self.device = device
        self._estimator = None  # set by compile/fit

    # --- training hookup ----------------------------------------------------
    def compile(self, loss=None, optimizer="adam", metrics=None, **kwargs):
        from ...orca.learn.estimator import TPUEstimator
        kwargs.setdefault("device", self.device)
        self._estimator = TPUEstimator(self.module, loss=loss,
                                       optimizer=optimizer, metrics=metrics,
                                       **kwargs)
        return self

    @property
    def estimator(self):
        if self._estimator is None:
            self.compile()
        return self._estimator

    def fit(self, data, **kwargs):
        return self.estimator.fit(data, **kwargs)

    def evaluate(self, data, **kwargs):
        return self.estimator.evaluate(data, **kwargs)

    def predict(self, x, batch_size: int = 1024, **kwargs) -> np.ndarray:
        est = self.estimator
        if isinstance(x, np.ndarray) or (
                isinstance(x, (list, tuple)) and
                all(isinstance(a, np.ndarray) for a in x)):
            return est.predict({"x": x}, batch_size=batch_size, **kwargs)
        return est.predict(x, batch_size=batch_size, **kwargs)

    # --- persistence --------------------------------------------------------
    def save_model(self, path: str, over_write: bool = False):
        """The module's config, the engine state and the class name, with
        ``torch.save``."""
        if os.path.exists(path) and not over_write:
            raise FileExistsError(path)
        torch.save({"module_cfg": self._module_config(),
                    "state": self.estimator.engine.get_state(),
                    "cls": type(self).__name__}, path)
        return path

    def _module_config(self) -> Dict[str, Any]:
        return dict(getattr(self.module, "config", {}) or {})

    @classmethod
    def load_model(cls, path: str):
        raise NotImplementedError(
            "use the estimator save/load for generic checkpoints; "
            "model-zoo load_model lands with the serialization milestone")

    def get_weights(self) -> Dict[str, np.ndarray]:
        return {k: v.numpy()
                for k, v in self.estimator.engine.get_state()[
                    "params"].items()}
