"""tfpark (counterpart of ``analytics_zoo_tpu/tfpark/__init__.py``): the
surface TensorFlow users of Analytics Zoo arrive through.

* ``TFDataset``: every constructor of the JAX class, each landing in host
  arrays ``x`` / ``y`` that the estimators take as a ``{'x', 'y'}`` dict
  (``from_tfrecord_file`` over the port's ``orca/data/tfrecord``;
  ``from_tf_data_dataset`` imports TensorFlow when it is called;
  ``from_rdd`` and ``from_feature_set`` raise, as in JAX).
* ``KerasModel``: a Keras ``Sequential``/``Model`` (compiled with the loss
  and optimizer) or any ``nn.Module`` (under a ``TPUEstimator``), with
  ``fit``/``evaluate``/``predict``. A ``TFDataset`` gives ``fit`` its
  batch size before the keyword does, and ``predict`` its ``x`` only.
* ``ZooOptimizer(optimizer, grad_accum_steps)``: gradient accumulation,
  optax ``MultiSteps`` (``orca/learn/optimizers``' ``MultiSteps``).
  Its update is a host branch, so on the card a fit with it runs
  unfused, the reason in each epoch's stats (``unfused_reason``).
* ``GANEstimator``: ``orca/learn/gan_estimator.py``'s.
* ``TFOptimizer`` and ``TFEstimator`` raise ``NotImplementedError``, as in
  JAX. ``TFNet`` (a frozen TensorFlow graph) is not ported: it needs
  TensorFlow, which the card's machine lacks.

Entry points run on ``cuda`` unless ``device="cpu"`` is given.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np

from ..orca.learn.gan_estimator import GANEstimator

__all__ = ["GANEstimator", "KerasModel", "TFDataset", "TFEstimator",
           "TFOptimizer", "ZooOptimizer"]


class TFDataset:
    """Holds host arrays ``x`` and ``y`` (None: unlabelled) and the batch
    size the constructor was given (None when it was not)."""

    def __init__(self, x, y=None, batch_size: int = -1,
                 batch_per_thread: int = -1, **_):
        self.x = x
        self.y = y
        self.batch_size = batch_size if batch_size > 0 else None

    @classmethod
    def from_ndarrays(cls, tensors, batch_size: int = -1,
                      batch_per_thread: int = -1, val_tensors=None, **kw):
        """``(x, y)`` or ``x`` alone."""
        if isinstance(tensors, (list, tuple)) and len(tensors) == 2:
            return cls(tensors[0], tensors[1], batch_size, batch_per_thread)
        return cls(tensors, None, batch_size, batch_per_thread)

    @classmethod
    def from_rdd(cls, rdd, **kwargs):
        raise NotImplementedError(
            "Spark RDDs do not exist in this runtime; load data with "
            "orca.data (XShards / read_csv) instead")

    @classmethod
    def from_feature_set(cls, dataset, **kwargs):
        raise NotImplementedError(
            "use orca.data XShards in place of a FeatureSet here")

    @classmethod
    def from_image_set(cls, image_set, batch_size: int = -1, **kwargs):
        """An ``ImageSet``'s images, and its labels when every image has
        one."""
        x = np.stack(image_set.get_image())
        labels = image_set.get_label()
        y = (np.asarray(labels)
             if labels and all(lb is not None for lb in labels) else None)
        return cls(x, y, batch_size)

    @classmethod
    def from_text_set(cls, text_set, batch_size: int = -1, **kwargs):
        """A word2idx'd ``TextSet``: the index rows, and the labels when
        every feature has one."""
        x = np.stack([f.indices for f in text_set.features])
        labels = [getattr(f, "label", None) for f in text_set.features]
        y = (np.asarray(labels) if all(lb is not None for lb in labels)
             else None)
        return cls(x, y, batch_size)

    @classmethod
    def from_string_rdd(cls, string_rdd, batch_size: int = -1, **kwargs):
        """Any iterable of strings, as an ``(n,)`` object array."""
        return cls(np.asarray(list(string_rdd), dtype=object), None,
                   batch_size)

    @classmethod
    def from_bytes_rdd(cls, bytes_rdd, batch_size: int = -1, **kwargs):
        return cls(np.asarray(list(bytes_rdd), dtype=object), None,
                   batch_size)

    @classmethod
    def from_tfrecord_file(cls, paths, feature_cols, label_cols=None,
                           batch_size: int = -1, **kwargs):
        """TFRecord files (or a directory of them) through the port's
        reader: one array a column, a single column unwrapped."""
        from ..orca.data.tfrecord import read_tfrecords_as_xshards
        parts = read_tfrecords_as_xshards(
            paths, feature_cols=feature_cols,
            label_cols=label_cols).collect()
        if not parts:
            raise ValueError(f"no records in {paths!r}")

        def merged(key):
            cols = tuple(np.concatenate([np.asarray(p[key][i])
                                         for p in parts])
                         for i in range(len(parts[0][key])))
            return cols[0] if len(cols) == 1 else cols

        y = merged("y") if "y" in parts[0] else None
        return cls(merged("x"), y, batch_size)

    @classmethod
    def from_dataframe(cls, df, feature_cols, labels_cols=None, **kwargs):
        x = np.stack([np.asarray(v) for v in
                      df[feature_cols].to_numpy()]).astype(np.float32)
        y = df[labels_cols].to_numpy() if labels_cols else None
        return cls(x, y, kwargs.get("batch_size", -1))

    @classmethod
    def from_tf_data_dataset(cls, dataset, batch_size: int = -1, **kwargs):
        """A finite ``tf.data.Dataset`` read into host arrays (this
        constructor alone imports TensorFlow)."""
        import tensorflow as tf  # noqa: F401
        xs, ys = [], []
        for item in dataset.as_numpy_iterator():
            if isinstance(item, tuple) and len(item) == 2:
                xs.append(item[0])
                ys.append(item[1])
            else:
                xs.append(item)
        x = np.stack(xs)
        y = np.stack(ys) if ys else None
        return cls(x, y, batch_size)

    def to_dict(self) -> Dict[str, Any]:
        return {"x": self.x} if self.y is None else {"x": self.x,
                                                     "y": self.y}


def _as_data(x, y):
    if isinstance(x, TFDataset):
        return x.to_dict()
    return {"x": x, "y": y} if y is not None else x


class KerasModel:
    """Wraps a Keras ``Sequential``/``Model`` of the port (compiled with
    ``loss``, ``optimizer`` and ``metrics``) or any ``nn.Module`` (under a
    ``TPUEstimator``). ``device`` (default: the card) overrides a Keras
    model's own."""

    def __init__(self, model, loss="mean_squared_error", optimizer="adam",
                 metrics=None, device=None):
        from ..pipeline.api.keras.engine.topology import KerasNet
        if isinstance(model, KerasNet):
            if device is not None:
                model.device = device
            model.compile(optimizer=optimizer, loss=loss, metrics=metrics)
            self._est = model.estimator
        else:
            from ..orca.learn.estimator import TPUEstimator
            self._est = TPUEstimator(model, loss=loss, optimizer=optimizer,
                                     metrics=metrics, device=device)

    @property
    def estimator(self):
        return self._est

    def fit(self, x, y=None, batch_size=32, epochs=1, distributed=True,
            **kwargs):
        bs = getattr(x, "batch_size", None) or batch_size
        return self._est.fit(_as_data(x, y), epochs=epochs, batch_size=bs,
                             **kwargs)

    def evaluate(self, x, y=None, batch_per_thread=32, distributed=True):
        return self._est.evaluate(_as_data(x, y),
                                  batch_size=batch_per_thread)

    def predict(self, x, batch_per_thread=32, distributed=True):
        data = ({"x": x.x} if isinstance(x, TFDataset)
                else ({"x": x} if not isinstance(x, dict) else x))
        return self._est.predict(data, batch_size=batch_per_thread)

    def save_weights(self, path):
        self._est.save(path)

    def load_weights(self, path):
        self._est.load(path)


class TFOptimizer:
    @classmethod
    def from_loss(cls, *args, **kwargs):
        raise NotImplementedError(
            "TF1 graph export is not part of this stack: write the model "
            "as a torch module (or a Keras pipeline net) and use "
            "orca.learn.Estimator.from_keras")

    from_keras = from_loss
    from_train_op = from_loss


def ZooOptimizer(optimizer, grad_accum_steps: int = 1):
    """Gradient accumulation over ``grad_accum_steps`` micro-batches, one
    update of ``optimizer`` per window (optax ``MultiSteps``: the update
    takes the micro-gradients' mean). Returns an optimizer factory for
    any estimator or ``compile``; one step or fewer is ``optimizer``
    itself."""
    from ..orca.learn.optimizers.optimizers_impl import (convert_optimizer,
                                                         multi_steps)
    if grad_accum_steps <= 1:
        return convert_optimizer(optimizer)
    return multi_steps(optimizer, grad_accum_steps)


class TFEstimator:
    """The JAX package's model_fn estimator, which raises there too."""

    def __init__(self, model_fn: Callable, *args, **kwargs):
        raise NotImplementedError(
            "model_fn-style TF estimators are replaced by "
            "orca.learn.Estimator.from_keras(model_creator)")
