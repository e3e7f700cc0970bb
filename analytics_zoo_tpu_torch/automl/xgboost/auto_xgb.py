"""AutoXGBoost (counterpart of ``analytics_zoo_tpu/automl/xgboost/
auto_xgb.py``; parity: pyzoo/zoo/orca/automl/xgboost/auto_xgb.py —
AutoXGBRegressor/AutoXGBClassifier over the search engine).

When xgboost is importable these classes run HPO over real xgboost
models; otherwise they use the bundled histogram GBT engine (hist_gbt.py
— same second-order hist algorithm family, sklearn-compatible surface),
as the JAX package chooses. Tree training runs on the host by design
(numpy); only the trial scheduler (the device-leased TPUSearchEngine) is
shared with the torch models. ``device`` picks the engine's inventory as
everywhere in the port: ``None`` is every visible card, and without a
GPU it raises unless given ``device="cpu"``."""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import numpy as np

from ...common.context import resolve_device

logger = logging.getLogger("analytics_zoo_tpu_torch")


from . import hist_gbt


class _BuiltinBackend:
    """xgboost-shaped namespace over the bundled histogram GBT."""

    XGBRegressor = hist_gbt.ZooGBTRegressor
    XGBClassifier = hist_gbt.ZooGBTClassifier


def _backend():
    try:
        import xgboost
        return xgboost
    except ImportError:
        logger.info(
            "xgboost not installed — AutoXGBoost using the bundled "
            "histogram-GBT backend (automl/xgboost/hist_gbt.py)")
        return _BuiltinBackend


class _XGBModelBuilder:
    def __init__(self, model_cls, fixed: Dict[str, Any]):
        self.model_cls = model_cls
        self.fixed = fixed

    def build(self, config: Dict[str, Any]):
        params = dict(self.fixed)
        params.update(config)
        return self.model_cls(**params)


class _AutoXGB:
    _objective = None
    _metric_default = None

    def __init__(self, cpus_per_trial: int = 1, name: str = "auto_xgb",
                 remote_dir: Optional[str] = None, logs_dir: str = "/tmp",
                 device=None, **xgb_configs):
        self.device = resolve_device(device)
        self.xgb = _backend()
        self.fixed = dict(xgb_configs)
        self.name = name
        self.best_model = None
        self.best_config = None

    def _model_cls(self):
        raise NotImplementedError

    def fit(self, data, validation_data=None, metric: Optional[str] = None,
            metric_mode: str = "min", search_space: Optional[dict] = None,
            n_sampling: int = 4, search_alg=None, epochs: int = 1, **_):
        from ..search.search_engine import TPUSearchEngine
        from .. import hp

        x, y = data
        vx, vy = validation_data if validation_data is not None else (x, y)
        metric = metric or self._metric_default
        search_space = search_space or {
            "n_estimators": hp.randint(50, 300),
            "max_depth": hp.randint(2, 10),
            "lr": hp.loguniform(1e-3, 0.3),
        }
        builder = _XGBModelBuilder(self._model_cls(), self.fixed)
        score_of = self._score

        class _TrialModel:
            """fit_eval contract of TPUSearchEngine.compile (tree training
            runs on the host; the leased device only schedules it)."""

            def __init__(self, config, device):
                cfg = dict(config)
                if "lr" in cfg:
                    cfg["learning_rate"] = cfg.pop("lr")
                cfg.pop("batch_size", None)
                self.model = builder.build(cfg)

            def fit_eval(self, train, val, epochs=1, metric=metric):
                tx, ty = train
                vx_, vy_ = val
                self.model.fit(tx, ty)
                score = score_of(vy_, self.model.predict(vx_), metric)
                return score, {metric: score}, self.model

        engine = TPUSearchEngine(name=self.name, device=self.device)
        self.engine = engine            # its trials, as AutoTSTrainer's
        engine.compile((x, y), _TrialModel, search_space,
                       n_sampling=n_sampling, epochs=epochs,
                       validation_data=(vx, vy), metric=metric,
                       metric_mode=metric_mode)
        engine.run()
        best = engine.get_best_trial()
        self.best_config = best.config
        self.best_model = best.model_state
        return self

    @staticmethod
    def _score(y_true, y_pred, metric: str) -> float:
        y_true = np.asarray(y_true)
        y_pred = np.asarray(y_pred)
        if metric in ("mae",):
            return float(np.mean(np.abs(y_true - y_pred)))
        if metric in ("mse", "rmse"):
            mse = float(np.mean((y_true - y_pred) ** 2))
            return mse ** 0.5 if metric == "rmse" else mse
        if metric in ("error", "accuracy"):
            acc = float(np.mean(y_true == y_pred))
            return 1 - acc if metric == "error" else acc
        if metric == "logloss":
            p = np.clip(y_pred, 1e-7, 1 - 1e-7)
            return float(-np.mean(y_true * np.log(p) +
                                  (1 - y_true) * np.log(1 - p)))
        raise ValueError(f"unknown metric {metric!r}")

    def predict(self, x):
        return self.best_model.predict(x)

    def get_best_model(self):
        return self.best_model

    def get_best_config(self):
        return self.best_config


class AutoXGBRegressor(_AutoXGB):
    _metric_default = "rmse"

    def _model_cls(self):
        return self.xgb.XGBRegressor


class AutoXGBClassifier(_AutoXGB):
    _metric_default = "error"

    def _model_cls(self):
        return self.xgb.XGBClassifier
