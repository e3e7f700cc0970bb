"""AnomalyDetector (counterpart of ``analytics_zoo_tpu/models/
anomalydetection/anomaly_detector.py``): stacked LSTMs with dropout that
predict the next value of a series; the anomalies are the points with the
largest prediction error.

Parameters carry flax's names: the cells ``LSTMCell_{i}`` (the JAX module
names their ``nn.RNN`` wrappers ``lstm_{i}``, which hold no parameters, so
flax names the cells by class and index) and ``head``. Each cell runs its
sequence in one cuDNN call on the card; dropout (the port's, drawing from
the training engine's generator) follows every layer, the last one after
its last step is taken.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
from torch import nn

from ...pipeline.api.keras.layers.recurrent import LSTMCell
from ...pipeline.api.keras.layers.self_attention import Dropout, dense
from ..common.zoo_model import ZooModel


class AnomalyDetectorNet(nn.Module):
    def __init__(self, feature_shape: Tuple[int, int] = (10, 1),
                 hidden_layers: Tuple[int, ...] = (8, 32, 15),
                 dropouts: Tuple[float, ...] = (0.2, 0.2, 0.2)):
        super().__init__()
        self.config = dict(feature_shape=tuple(feature_shape),
                           hidden_layers=tuple(hidden_layers),
                           dropouts=tuple(dropouts))
        width = int(feature_shape[1])
        self.drops = nn.ModuleList()
        self.n = len(hidden_layers)
        for i, (units, drop) in enumerate(zip(hidden_layers, dropouts)):
            self.add_module(f"LSTMCell_{i}", LSTMCell(width, int(units)))
            self.drops.append(Dropout(float(drop)))
            width = int(units)
        self.head = dense(width, 1)

    def forward(self, x):
        h = x
        for i, drop in enumerate(self.drops):
            h, _ = getattr(self, f"LSTMCell_{i}")(h)
            if i == self.n - 1:
                h = h[:, -1, :]
            h = drop(h)
        return self.head(h)


class AnomalyDetector(ZooModel):
    def __init__(self, feature_shape,
                 hidden_layers: Sequence[int] = (8, 32, 15),
                 dropouts: Sequence[float] = (0.2, 0.2, 0.2), device=None,
                 **_):
        assert len(hidden_layers) == len(dropouts), \
            "sizes of dropouts and hidden_layers should be equal"
        module = AnomalyDetectorNet(
            feature_shape=tuple(int(d) for d in feature_shape),
            hidden_layers=tuple(int(u) for u in hidden_layers),
            dropouts=tuple(float(d) for d in dropouts))
        super().__init__(module, device)

    # --- reference helpers --------------------------------------------------
    @staticmethod
    def unroll(data: np.ndarray, unroll_length: int, predict_step: int = 1):
        """Sliding windows of ``unroll_length`` rows and the target
        ``predict_step`` rows after each (reference unroll)."""
        data = np.asarray(data)
        xs, ys = [], []
        for i in range(len(data) - unroll_length - predict_step + 1):
            xs.append(data[i:i + unroll_length])
            ys.append(data[i + unroll_length + predict_step - 1, 0]
                      if data.ndim > 1 else
                      data[i + unroll_length + predict_step - 1])
        return np.stack(xs), np.asarray(ys, np.float32)

    @staticmethod
    def detect_anomalies(y_true: np.ndarray, y_pred: np.ndarray,
                         anomaly_size: int):
        """The ``anomaly_size`` largest absolute errors (reference
        detectAnomalies): ``[(index, true, predicted)]``."""
        y_true = np.asarray(y_true).reshape(-1)
        y_pred = np.asarray(y_pred).reshape(-1)
        err = np.abs(y_true - y_pred)
        th = np.sort(err)[-anomaly_size] if anomaly_size > 0 else np.inf
        idx = np.where(err >= th)[0]
        return [(int(i), float(y_true[i]), float(y_pred[i])) for i in idx]
