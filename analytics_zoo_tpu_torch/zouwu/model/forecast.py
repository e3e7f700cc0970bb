"""Zouwu forecasters (counterpart of ``analytics_zoo_tpu/zouwu/model/
forecast.py``): the reference's forecaster family (pyzoo/zoo/zouwu/model/
forecast/: abstract.py Forecaster, lstm_forecaster.py, tcn_forecaster.py,
seq2seq_forecaster.py, mtnet_forecaster.py) with the same constructor/fit/
predict/evaluate/save/restore surface, over the port's ``TPUEstimator``.

Each forecaster trains on ``device`` (``cuda`` unless the caller passes
``device="cpu"``; without a GPU it raises). The nets take their input
width at construction (``feature_dim`` / ``input_feature_num``), where the
JAX package's flax modules infer it from the first batch.

As in the JAX package, ``_make_optimizer`` builds ``SGD(lr=lr)``, and
``SGD`` takes ``learningrate``: ``lr`` falls into its ``**_``, so
``optimizer="sgd"`` trains at SGD's default 1e-3 whatever ``lr`` says.
The port reproduces that (a reference caveat, shown by
``tests/test_torch_zouwu.py``).

A forecaster's net is drawn from seed 0 whatever the caller's torch RNG
holds, as the JAX estimator initialises from ``PRNGKey(0)``: two
forecasters of one configuration start from the same weights (the two
packages' draws differ).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ...orca.learn.estimator import TPUEstimator
from ...orca.learn.optimizers import Adam, RMSprop, SGD
from . import nets


def build_net(net_spec: Tuple[str, Dict], seed: int = 0) -> torch.nn.Module:
    """``nets.<name>(**kwargs)`` drawn from ``seed``, leaving torch's
    global RNG as it was."""
    name, kwargs = net_spec
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return getattr(nets, name)(**kwargs)


def _make_optimizer(name: str, lr: float):
    table = {"adam": Adam, "sgd": SGD, "rmsprop": RMSprop}
    return table.get(str(name).lower(), Adam)(lr=lr) if not callable(name) \
        else name


_METRIC_FNS = {
    "mse": lambda y, p: float(np.mean((p - y) ** 2)),
    "mean_squared_error": lambda y, p: float(np.mean((p - y) ** 2)),
    "rmse": lambda y, p: float(np.sqrt(np.mean((p - y) ** 2))),
    "mae": lambda y, p: float(np.mean(np.abs(p - y))),
    "mean_absolute_error": lambda y, p: float(np.mean(np.abs(p - y))),
    "mape": lambda y, p: float(np.mean(np.abs((p - y) /
                                              np.clip(np.abs(y), 1e-8, None)))
                               * 100),
    "smape": lambda y, p: float(np.mean(2 * np.abs(p - y) /
                                        np.clip(np.abs(y) + np.abs(p), 1e-8,
                                                None)) * 100),
    "r2": lambda y, p: float(1 - np.sum((p - y) ** 2) /
                             max(np.sum((y - y.mean()) ** 2), 1e-12)),
}


def evaluate_metrics(y, pred, metrics: Sequence[str]):
    y = np.asarray(y)
    pred = np.asarray(pred).reshape(y.shape)
    return {m: _METRIC_FNS[m.lower()](y, pred) for m in metrics}


class Forecaster:
    """(reference abstract: zouwu/model/forecast/abstract.py)

    ``net_spec``: ``(class name in nets, constructor kwargs)`` of the
    module, which a saved pipeline records to rebuild it."""

    def __init__(self, module, loss="mse", optimizer="Adam", lr: float = 1e-3,
                 device=None, net_spec: Tuple[str, Dict] = None):
        self.module = module
        self.net_spec = net_spec
        self.estimator = TPUEstimator(module, loss=loss,
                                      optimizer=_make_optimizer(optimizer, lr),
                                      device=device)
        self.device = self.estimator.device
        self._fitted = False

    @staticmethod
    def from_spec(net_spec: Tuple[str, Dict], device=None, **kwargs
                  ) -> "Forecaster":
        """A forecaster over a new ``nets.<name>(**kwargs)``."""
        return Forecaster(build_net(net_spec), device=device,
                          net_spec=net_spec, **kwargs)

    def fit(self, x, y=None, validation_data=None, epochs: int = 1,
            metric: str = "mse", batch_size: int = 32, **kwargs):
        """x: (n, past_seq_len, feature_dim); y: (n, ...) target windows
        (reference: tcn_forecaster.py:70)."""
        if y is None and isinstance(x, tuple):
            x, y = x
        data = {"x": np.asarray(x, np.float32),
                "y": np.asarray(y, np.float32)}
        if validation_data is not None:
            validation_data = {"x": np.asarray(validation_data[0], np.float32),
                               "y": np.asarray(validation_data[1], np.float32)}
        stats = self.estimator.fit(data, epochs=epochs, batch_size=batch_size,
                                   validation_data=validation_data,
                                   verbose=False, **kwargs)
        self._fitted = True
        return stats

    def predict(self, x, batch_size: int = 1024) -> np.ndarray:
        if not self._fitted:
            raise RuntimeError("forecaster needs to be fitted before predict")
        return np.asarray(self.estimator.predict(
            {"x": np.asarray(x, np.float32)}, batch_size=batch_size))

    def evaluate(self, x, y, metrics: Sequence[str] = ("mse",),
                 multioutput: str = "uniform_average"):
        pred = self.predict(x)
        y = np.asarray(y, np.float32)
        if multioutput == "raw_values" and y.ndim >= 2:
            return {m: np.stack([
                _METRIC_FNS[m.lower()](y[..., i],
                                       pred.reshape(y.shape)[..., i])
                for i in range(y.shape[-1])]) for m in metrics}
        return evaluate_metrics(y, pred, metrics)

    def save(self, checkpoint_file: str):
        self.estimator.save(checkpoint_file)

    def restore(self, checkpoint_file: str):
        self.estimator.load(checkpoint_file)
        self._fitted = True


class LSTMForecaster(Forecaster):
    """(reference: lstm_forecaster.py:21-69)"""

    def __init__(self, target_dim: int = 1, feature_dim: int = 1,
                 lstm_units: Tuple[int, ...] = (16, 8), dropouts=0.2,
                 metric: str = "mean_squared_error", lr: float = 0.001,
                 loss: str = "mse", optimizer: str = "Adam", device=None,
                 **_):
        if isinstance(dropouts, (int, float)):
            dropouts = tuple([float(dropouts)] * len(tuple(lstm_units)))
        spec = ("LSTMNet", dict(input_dim=int(feature_dim),
                                target_dim=target_dim,
                                lstm_units=tuple(int(u) for u in lstm_units),
                                dropouts=tuple(dropouts)))
        self.feature_dim = feature_dim
        super().__init__(build_net(spec), loss=loss, optimizer=optimizer,
                         lr=lr, device=device, net_spec=spec)


class TCNForecaster(Forecaster):
    """(reference: tcn_forecaster.py:21-69)"""

    def __init__(self, past_seq_len: int, future_seq_len: int,
                 input_feature_num: int, output_feature_num: int,
                 num_channels: Sequence[int] = (30,) * 8, kernel_size: int = 7,
                 dropout: float = 0.2, optimizer: str = "Adam",
                 loss: str = "mse", lr: float = 0.001, device=None, **_):
        spec = ("TCNNet", dict(past_seq_len=past_seq_len,
                               future_seq_len=future_seq_len,
                               input_dim=input_feature_num,
                               output_feature_num=output_feature_num,
                               num_channels=tuple(int(c)
                                                  for c in num_channels),
                               kernel_size=kernel_size, dropout=dropout))
        self.data_config = {
            "past_seq_len": past_seq_len, "future_seq_len": future_seq_len,
            "input_feature_num": input_feature_num,
            "output_feature_num": output_feature_num}
        super().__init__(build_net(spec), loss=loss, optimizer=optimizer,
                         lr=lr, device=device, net_spec=spec)

    def fit(self, x, y=None, validation_data=None, epochs=1, metric="mse",
            batch_size=32, **kwargs):
        if y is not None:
            self._check_data(np.asarray(x), np.asarray(y))
        return super().fit(x, y, validation_data, epochs, metric, batch_size,
                           **kwargs)

    def _check_data(self, x, y):
        """(reference: tcn_forecaster.py:93-110)"""
        c = self.data_config
        assert x.ndim == 3 and y.ndim == 3, \
            "x and y must be 3-dim (n, seq_len, feature_num)"
        assert x.shape[1] == c["past_seq_len"], \
            f"x seq_len {x.shape[1]} != past_seq_len {c['past_seq_len']}"
        assert x.shape[2] == c["input_feature_num"], \
            f"x feature_num {x.shape[2]} != {c['input_feature_num']}"
        assert y.shape[1] == c["future_seq_len"], \
            f"y seq_len {y.shape[1]} != future_seq_len {c['future_seq_len']}"
        assert y.shape[2] == c["output_feature_num"], \
            f"y feature_num {y.shape[2]} != {c['output_feature_num']}"


class Seq2SeqForecaster(Forecaster):
    """(reference: seq2seq_forecaster.py)"""

    def __init__(self, past_seq_len: int, future_seq_len: int,
                 input_feature_num: int, output_feature_num: int,
                 lstm_hidden_dim: int = 128, dropout: float = 0.2,
                 optimizer: str = "Adam", loss: str = "mse",
                 lr: float = 0.001, device=None, **_):
        spec = ("Seq2SeqNet", dict(input_dim=input_feature_num,
                                   future_seq_len=future_seq_len,
                                   output_feature_num=output_feature_num,
                                   latent_dim=lstm_hidden_dim,
                                   dropout=dropout))
        super().__init__(build_net(spec), loss=loss,
                         optimizer=optimizer, lr=lr, device=device,
                         net_spec=spec)


class MTNetForecaster(Forecaster):
    """(reference: mtnet_forecaster.py — wraps MTNet keras; here the lite
    cnn+attention+AR variant in nets.MTNetLite)"""

    def __init__(self, target_dim: int = 1, feature_dim: int = 1,
                 long_series_num: int = 1, series_length: int = 1,
                 ar_window_size: int = 1, cnn_height: int = 1,
                 cnn_hid_size: int = 32, lr: float = 0.001,
                 loss: str = "mae", metric: str = "mean_absolute_error",
                 device=None, **_):
        spec = ("MTNetLite", dict(input_dim=feature_dim,
                                  target_dim=target_dim,
                                  ar_window=max(ar_window_size, 1),
                                  cnn_kernel=max(cnn_height, 1),
                                  cnn_channels=cnn_hid_size))
        super().__init__(build_net(spec), loss=loss, optimizer="Adam",
                         lr=lr, device=device, net_spec=spec)
