"""Loss objects of the Keras API (counterpart of ``analytics_zoo_tpu/
pipeline/api/keras/objectives.py``): each is a thin callable over the
port's loss table (``orca/learn/losses.py``), so ``compile(loss=...)``
takes a name, one of these classes or a plain function alike."""

from __future__ import annotations

from typing import Callable

from ....orca.learn import losses as L


class _LossObject:
    fn: Callable = None

    def __init__(self, **kwargs):
        self.kwargs = kwargs

    def __call__(self, y_true, y_pred):
        return type(self).fn(y_true, y_pred, **self.kwargs)


class MeanSquaredError(_LossObject):
    fn = staticmethod(L.mean_squared_error)


class MeanAbsoluteError(_LossObject):
    fn = staticmethod(L.mean_absolute_error)


class BinaryCrossEntropy(_LossObject):
    fn = staticmethod(L.binary_crossentropy)


class CategoricalCrossEntropy(_LossObject):
    fn = staticmethod(L.categorical_crossentropy)


class SparseCategoricalCrossEntropy(_LossObject):
    fn = staticmethod(L.sparse_categorical_crossentropy)


class Hinge(_LossObject):
    fn = staticmethod(L.hinge)


class KullbackLeiblerDivergence(_LossObject):
    fn = staticmethod(L.kld)


mse = MSE = MeanSquaredError
mae = MAE = MeanAbsoluteError
