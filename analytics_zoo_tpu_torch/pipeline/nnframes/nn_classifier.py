"""NNFrames, the DataFrame pipeline API (counterpart of
``analytics_zoo_tpu/pipeline/nnframes/nn_classifier.py``): ``NNEstimator``
and ``NNClassifier`` ``fit(df)`` an ``nn.Module`` on a pandas DataFrame's
feature and label columns and return an ``NNModel`` /
``NNClassifierModel``, whose ``transform(df)`` appends the prediction
column. Training goes through the port's ``TPUEstimator`` on ``device``
(default: the card; ``"cpu"`` asks for the CPU).

As in the JAX package, the model is a module (a Keras model's
``to_module()``), not a ``KerasNet``. pandas is imported by none of this
module's code until a DataFrame arrives.
"""

from __future__ import annotations

import numpy as np


def _col_to_array(df, col: str) -> np.ndarray:
    """A column of scalars -> (n, 1) f32; of lists or arrays -> (n, k)."""
    vals = df[col].to_numpy()
    if len(vals) and isinstance(vals[0], (list, tuple, np.ndarray)):
        return np.stack([np.asarray(v, np.float32) for v in vals])
    return vals.astype(np.float32).reshape(-1, 1)


class NNEstimator:
    """fit(df) trains ``model`` on ``featuresCol``/``labelCol`` with
    ``criterion``. ``feature_preprocessing`` and ``label_preprocessing``
    are accepted for API parity: shapes come from the data."""

    def __init__(self, model, criterion="mean_squared_error",
                 feature_preprocessing=None, label_preprocessing=None,
                 device=None):
        self.model = model
        self.criterion = criterion
        self.device = device
        self._features_col = "features"
        self._label_col = "label"
        self._predictions_col = "prediction"
        self._batch_size = 32
        self._max_epoch = 10
        self._optim_method = "adam"
        self._learning_rate = None      # None = optimizer's own default
        self._caching_sample = True

    # --- Spark-ML style setters ---------------------------------------------
    def setFeaturesCol(self, name: str) -> "NNEstimator":
        self._features_col = name
        return self

    def setLabelCol(self, name: str) -> "NNEstimator":
        self._label_col = name
        return self

    def setPredictionCol(self, name: str) -> "NNEstimator":
        self._predictions_col = name
        return self

    def setBatchSize(self, bs: int) -> "NNEstimator":
        self._batch_size = int(bs)
        return self

    def setMaxEpoch(self, n: int) -> "NNEstimator":
        self._max_epoch = int(n)
        return self

    def setOptimMethod(self, opt) -> "NNEstimator":
        self._optim_method = opt
        return self

    def setLearningRate(self, lr: float) -> "NNEstimator":
        self._learning_rate = float(lr)
        return self

    def setCachingSample(self, b: bool) -> "NNEstimator":
        self._caching_sample = bool(b)
        return self

    # snake_case aliases
    set_features_col = setFeaturesCol
    set_label_col = setLabelCol
    set_prediction_col = setPredictionCol
    set_batch_size = setBatchSize
    set_max_epoch = setMaxEpoch
    set_optim_method = setOptimMethod
    set_learning_rate = setLearningRate
    set_caching_sample = setCachingSample

    def _make_estimator(self):
        from ...orca.learn.estimator import TPUEstimator
        from ...orca.learn.optimizers.optimizers_impl import \
            convert_optimizer
        opt = self._optim_method
        if isinstance(opt, str) and self._learning_rate is not None:
            # only an explicit setLearningRate overrides; an lr-less
            # optimizer (adadelta) then raises, as in the JAX package
            opt = convert_optimizer(opt, learning_rate=self._learning_rate)
        return TPUEstimator(self.model, loss=self.criterion, optimizer=opt,
                            device=self.device)

    def _label_array(self, df) -> np.ndarray:
        return _col_to_array(df, self._label_col)

    def fit(self, df) -> "NNModel":
        x = _col_to_array(df, self._features_col)
        y = self._label_array(df)
        est = self._make_estimator()
        est.fit({"x": x, "y": y}, epochs=self._max_epoch,
                batch_size=self._batch_size, verbose=False)
        return self._make_model(est)

    def _make_model(self, est) -> "NNModel":
        m = NNModel(self.model, estimator=est)
        m._features_col = self._features_col
        m._predictions_col = self._predictions_col
        m._batch_size = self._batch_size
        return m


class NNModel:
    """transform(df) appends the prediction column."""

    def __init__(self, model, estimator=None, device=None):
        self.model = model
        if estimator is None:
            from ...orca.learn.estimator import TPUEstimator
            estimator = TPUEstimator(model, loss="mean_squared_error",
                                     optimizer="adam", device=device)
        self.estimator = estimator
        self._features_col = "features"
        self._predictions_col = "prediction"
        self._batch_size = 32

    def setFeaturesCol(self, name: str) -> "NNModel":
        self._features_col = name
        return self

    def setPredictionCol(self, name: str) -> "NNModel":
        self._predictions_col = name
        return self

    def setBatchSize(self, bs: int) -> "NNModel":
        self._batch_size = int(bs)
        return self

    set_features_col = setFeaturesCol
    set_prediction_col = setPredictionCol
    set_batch_size = setBatchSize

    def _predict_array(self, df) -> np.ndarray:
        x = _col_to_array(df, self._features_col)
        return np.asarray(self.estimator.predict(
            {"x": x}, batch_size=self._batch_size))

    def transform(self, df):
        preds = self._predict_array(df)
        out = df.copy()
        out[self._predictions_col] = list(preds)
        return out

    def save(self, path: str):
        self.estimator.save(path)

    @classmethod
    def load(cls, model, path: str, device=None) -> "NNModel":
        m = cls(model, device=device)
        m.estimator.load(path)
        return m


class NNClassifier(NNEstimator):
    """Classification: labels are class ids; the prediction is the
    argmax."""

    def __init__(self, model, criterion="sparse_categorical_crossentropy",
                 feature_preprocessing=None, device=None):
        super().__init__(model, criterion, feature_preprocessing,
                         device=device)

    def _label_array(self, df) -> np.ndarray:
        return df[self._label_col].to_numpy().astype(np.int32)

    def _make_model(self, est) -> "NNClassifierModel":
        m = NNClassifierModel(self.model, estimator=est)
        m._features_col = self._features_col
        m._predictions_col = self._predictions_col
        m._batch_size = self._batch_size
        return m


class NNClassifierModel(NNModel):
    def transform(self, df):
        probs = self._predict_array(df)
        out = df.copy()
        out[self._predictions_col] = np.argmax(probs, -1).astype(np.int64)
        return out
