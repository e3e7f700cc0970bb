"""AutoXGBoost (counterpart of ``analytics_zoo_tpu/automl/xgboost``)."""

from .auto_xgb import AutoXGBClassifier, AutoXGBRegressor
