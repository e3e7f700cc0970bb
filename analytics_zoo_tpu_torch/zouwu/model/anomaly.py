"""Anomaly detectors (counterpart of ``analytics_zoo_tpu/zouwu/model/
anomaly.py``) — reference: pyzoo/zoo/zouwu/model/anomaly/anomaly.py
(ThresholdDetector with absolute bounds or (y, yhat) distance +
ratio-derived threshold; AEDetector autoencoder reconstruction error;
DBScanDetector).

``ThresholdDetector`` is numpy, as in the JAX package. ``AEDetector``'s
dense autoencoder is an ``nn.Module`` trained by the port's
``TPUEstimator`` on ``device`` (``cuda`` unless the caller passes
``device="cpu"``). ``DBScanDetector`` imports sklearn when it runs."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ...common.context import resolve_device
from .nets import _dense


class DetectorBase:
    def detect(self, y, **kwargs):
        raise NotImplementedError


def anomaly_indexes(anomaly_scores: np.ndarray, threshold: float) -> np.ndarray:
    return np.nonzero(anomaly_scores > threshold)[0]


class ThresholdDetector(DetectorBase):
    """(reference: anomaly.py ThresholdDetector/ThresholdEstimator)"""

    def __init__(self):
        self.th = None
        self.ratio = 0.01
        self.absolute_bounds: Optional[Tuple[float, float]] = None

    def set_params(self, mode: str = "default", ratio: float = 0.01,
                   threshold=None, **_):
        self.ratio = ratio
        if threshold is not None and isinstance(threshold, tuple):
            self.absolute_bounds = threshold
        elif threshold is not None:
            self.th = float(threshold)
        return self

    def fit(self, y: np.ndarray, y_pred: Optional[np.ndarray] = None):
        """Derive the distance threshold from the ratio of highest-error
        points (reference ThresholdEstimator.fit)."""
        if y_pred is not None:
            dist = np.abs(np.asarray(y) - np.asarray(y_pred)).reshape(len(y), -1).mean(-1)
            self.th = float(np.quantile(dist, 1 - self.ratio))
        else:
            self.absolute_bounds = (float(np.quantile(y, self.ratio / 2)),
                                    float(np.quantile(y, 1 - self.ratio / 2)))
        return self

    def detect(self, y: np.ndarray, y_pred: Optional[np.ndarray] = None
               ) -> np.ndarray:
        y = np.asarray(y)
        if y_pred is not None:
            if self.th is None:
                self.fit(y, y_pred)
            dist = np.abs(y - np.asarray(y_pred)).reshape(len(y), -1).mean(-1)
            return anomaly_indexes(dist, self.th)
        if self.absolute_bounds is None:
            self.fit(y)
        lo, hi = self.absolute_bounds
        flat = y.reshape(len(y), -1).mean(-1)
        return np.nonzero((flat < lo) | (flat > hi))[0]


class _DenseAE(nn.Module):
    """Dense(hidden) -> tanh -> Dense(dim), flax's Dense init."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.Dense_0 = _dense(dim, hidden)
        self.Dense_1 = _dense(hidden, dim)

    def forward(self, x):
        return self.Dense_1(torch.tanh(self.Dense_0(x)))


class AEDetector(DetectorBase):
    """Autoencoder reconstruction-error detector (reference: anomaly.py
    AEDetector — keras dense AE; here a dense AE on the port's
    estimator)."""

    def __init__(self, roll_len: int = 24, ratio: float = 0.1,
                 compress_rate: float = 0.8, batch_size: int = 100,
                 epochs: int = 20, verbose: int = 0, sub_scalef: float = 1,
                 lr: float = 1e-3, device=None):
        self.device = resolve_device(device)
        self.roll_len = roll_len
        self.ratio = ratio
        self.compress_rate = compress_rate
        self.batch_size = batch_size
        self.epochs = epochs
        self.lr = lr

    def _roll(self, y: np.ndarray) -> np.ndarray:
        y = np.asarray(y, np.float32).reshape(-1)
        if self.roll_len <= 1 or len(y) < self.roll_len:
            return y[:, None]
        n = len(y) - self.roll_len + 1
        idx = np.arange(self.roll_len)[None, :] + np.arange(n)[:, None]
        return y[idx]

    def detect(self, y: np.ndarray, **_) -> np.ndarray:
        from ...orca.learn.estimator import TPUEstimator
        from ...orca.learn.optimizers import Adam

        windows = self._roll(y)
        dim = windows.shape[1]
        hidden = max(int(dim * (1 - self.compress_rate)), 1)
        mean, std = windows.mean(), windows.std() + 1e-8
        norm = (windows - mean) / std
        est = TPUEstimator(_DenseAE(dim, hidden), loss="mse",
                           optimizer=Adam(lr=self.lr), device=self.device)
        est.fit({"x": norm, "y": norm}, epochs=self.epochs,
                batch_size=min(self.batch_size, len(norm)), verbose=False)
        recon = est.predict({"x": norm}, batch_size=1024)
        err = np.mean((recon - norm) ** 2, axis=-1)
        th = np.quantile(err, 1 - self.ratio)
        window_idx = anomaly_indexes(err, th)
        # map window index -> center point index in original series
        return np.unique(np.clip(window_idx + self.roll_len // 2, 0,
                                 len(np.asarray(y).reshape(-1)) - 1))


class DBScanDetector(DetectorBase):
    """(reference: anomaly.py DBScanDetector — sklearn DBSCAN labels -1)"""

    def __init__(self, eps: float = 0.5, min_samples: int = 5, **kwargs):
        self.eps, self.min_samples, self.kwargs = eps, min_samples, kwargs

    def detect(self, y: np.ndarray, **_) -> np.ndarray:
        from sklearn.cluster import DBSCAN
        arr = np.asarray(y, np.float32).reshape(len(y), -1)
        labels = DBSCAN(eps=self.eps, min_samples=self.min_samples,
                        **self.kwargs).fit_predict(arr)
        return np.nonzero(labels == -1)[0]
