"""AutoML (counterpart of ``analytics_zoo_tpu/automl``): the hp DSL, the
device-leased search engine with the ASHA ``TrialRuntime``
(``scheduler``), ``ModelBuilder``, ``AutoEstimator`` and AutoXGBoost
(``xgboost``)."""

from . import hp
from .auto_estimator import AutoEstimator
from .model_builder import ModelBuilder
from .search.search_engine import SearchEngine, TPUSearchEngine, Trial

__all__ = ["hp", "AutoEstimator", "ModelBuilder", "SearchEngine",
           "TPUSearchEngine", "Trial"]
