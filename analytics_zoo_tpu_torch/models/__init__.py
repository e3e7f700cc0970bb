"""The model zoo (counterpart of ``analytics_zoo_tpu/models``), with the
JAX package's exports. They load on first access: the Keras layers that
the models build on import ``models.common`` themselves."""

import importlib

_EXPORTS = {
    "AnomalyDetector": "anomalydetection", "AnomalyDetectorNet":
    "anomalydetection", "ColumnFeatureInfo": "recommendation",
    "NeuralCF": "recommendation", "NeuralCFNet": "recommendation",
    "SessionRecommender": "recommendation",
    "SessionRecommenderNet": "recommendation",
    "WideAndDeep": "recommendation", "WideAndDeepNet": "recommendation",
    "Seq2Seq": "seq2seq", "Seq2SeqNet": "seq2seq",
    "TextClassifier": "textclassification",
    "TextClassifierNet": "textclassification", "KNRM": "textmatching",
    "KNRMNet": "textmatching"}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f".{_EXPORTS[name]}", __name__)
    return getattr(module, name)
