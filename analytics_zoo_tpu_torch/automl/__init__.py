"""AutoML (counterpart of ``analytics_zoo_tpu/automl``): the hp DSL, the
device-leased search engine, ``ModelBuilder`` and ``AutoEstimator``. Not
ported yet: the ASHA ``TrialRuntime`` and AutoXGBoost (ROADMAP A5)."""

from . import hp
from .auto_estimator import AutoEstimator
from .model_builder import ModelBuilder
from .search.search_engine import SearchEngine, TPUSearchEngine, Trial

__all__ = ["hp", "AutoEstimator", "ModelBuilder", "SearchEngine",
           "TPUSearchEngine", "Trial"]
