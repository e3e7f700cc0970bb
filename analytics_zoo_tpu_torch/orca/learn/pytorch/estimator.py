"""The Orca PyTorch estimator (counterpart of ``analytics_zoo_tpu/orca/learn/
pytorch/estimator.py``): ``Estimator.from_torch`` with the reference's
creator functions, over the port's ``TPUEstimator``.

The JAX package converts the creators' torch objects to flax and optax
(``torch_bridge.py``, ``fx_bridge.py``). Here nothing is converted: the
module ``model_creator(config)`` returns trains as it is, on ``device``
(``cuda`` unless the caller passes ``device="cpu"``), under the optimizer
``optimizer_creator(model, config)`` returns over its parameters (Adam at
its default lr without a creator, as in the JAX package). The loss
follows the JAX package's rules: ``loss_creator`` is instantiated when it
is a class and called with ``config`` otherwise, and a torch loss maps
through :func:`convert_torch_loss`'s table onto ``orca/learn/losses.py``,
so that the train step averages per-example losses over the real rows of
a padded batch. Creators that return flax modules or optax transforms
raise ``TypeError``.

Accepted as the JAX package accepts them, and unused as there:
``backend``, ``workers_per_node``, ``use_tqdm``, ``sync_stats``,
``log_level``, ``scheduler_creator`` and ``scheduler_step_freq`` (no
scheduler is stepped).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from ....common.context import resolve_device
from .. import losses as L
from .. import utils as learn_utils
from ..estimator import TPUEstimator

_JAX_ROOTS = ("jax", "jaxlib", "flax", "optax", "analytics_zoo_tpu")


def _is_torch_module(obj) -> bool:
    return isinstance(obj, torch.nn.Module) and not isinstance(
        obj, torch.nn.modules.loss._Loss)


def _is_torch_loss(obj) -> bool:
    """A torch loss instance, or a torch loss class."""
    base = torch.nn.modules.loss._Loss
    return isinstance(obj, base) or (isinstance(obj, type)
                                     and issubclass(obj, base))


def _from_jax(obj) -> bool:
    """Whether ``obj`` (a function, or an instance through its class)
    comes from JAX, flax, optax or the JAX package."""
    mod = getattr(obj, "__module__", None) or ""
    return mod.split(".")[0] in _JAX_ROOTS


def _nll_loss(y_true, y_pred):
    return L.sparse_categorical_crossentropy(y_true, torch.exp(y_pred),
                                             from_logits=False)


# the JAX package's table (torch_bridge.convert_torch_loss): each torch loss
# class by name -> a per-example loss of orca/learn/losses.py
_TORCH_LOSSES = {
    "MSELoss": L.mean_squared_error,
    "L1Loss": L.mean_absolute_error,
    "BCELoss": L.binary_crossentropy,
    "BCEWithLogitsLoss": partial(L.binary_crossentropy, from_logits=True),
    "CrossEntropyLoss": partial(L.sparse_categorical_crossentropy,
                                from_logits=True),
    "NLLLoss": _nll_loss,
    "SmoothL1Loss": L.huber,
    "HingeEmbeddingLoss": L.hinge,
    "KLDivLoss": L.kld,
}


def convert_torch_loss(loss) -> Optional[Callable]:
    """A torch loss instance or class -> the per-example loss of the JAX
    package's table; any other callable (or None) passes through. The
    instance's own arguments (``reduction``, ``weight``, ...) are not read,
    as in the JAX package."""
    if loss is None or callable(loss) and not _is_torch_loss(loss):
        return loss
    name = loss.__name__ if isinstance(loss, type) else type(loss).__name__
    if name not in _TORCH_LOSSES:
        raise ValueError(f"unsupported torch loss {name}")
    return _TORCH_LOSSES[name]


def _resolve_loss(loss_creator, cfg):
    """A class is instantiated; anything else is called with ``cfg``."""
    if loss_creator is None:
        return None
    if isinstance(loss_creator, type):
        return loss_creator()
    return loss_creator(cfg)


class Estimator:
    @staticmethod
    def from_torch(*, model_creator: Callable,
                   optimizer_creator: Optional[Callable] = None,
                   loss_creator: Optional[Callable] = None,
                   scheduler_creator: Optional[Callable] = None,
                   training_operator_cls=None,
                   config: Optional[dict] = None,
                   backend: str = "torch_distributed",
                   metrics=None, model_dir: Optional[str] = None,
                   workers_per_node: int = 1, use_tqdm: bool = False,
                   scheduler_step_freq: str = "batch",
                   sync_stats: bool = True, log_level=None,
                   device=None, **_) -> "PyTorchTPUEstimator":
        """Build the estimator from the creators: the module is moved to
        ``device`` before ``optimizer_creator`` sees it, so the optimizer
        holds the parameters that train."""
        cfg = dict(config or {})
        dev = resolve_device(device)
        model = model_creator(cfg)
        if not _is_torch_module(model):
            raise TypeError(
                f"model_creator returned {type(model).__module__}."
                f"{type(model).__name__}; the PyTorch port takes torch "
                "objects: return a torch.nn.Module")
        model.to(dev)
        optimizer = "adam"
        if optimizer_creator is not None:
            opt = optimizer_creator(model, cfg)
            if not isinstance(opt, torch.optim.Optimizer):
                raise TypeError(
                    f"optimizer_creator returned {type(opt).__module__}."
                    f"{type(opt).__name__}; the PyTorch port takes torch "
                    "objects: return a torch.optim.Optimizer")
            optimizer = lambda params: opt      # noqa: E731  (the instance)
        loss = _resolve_loss(loss_creator, cfg)
        if loss is not None and _from_jax(loss):
            raise TypeError(
                f"loss_creator returned {loss!r}; the PyTorch port takes "
                "torch objects: return a torch loss or a function of torch "
                "tensors")
        est = PyTorchTPUEstimator(model, loss=convert_torch_loss(loss),
                                  optimizer=optimizer, metrics=metrics,
                                  model_dir=model_dir, config=cfg,
                                  device=dev)
        est.training_operator_cls = training_operator_cls
        return est

    @staticmethod
    def latest_checkpoint(model_dir: str) -> Optional[str]:
        return TPUEstimator.latest_checkpoint(model_dir)


class PyTorchTPUEstimator(TPUEstimator):
    """``TPUEstimator`` plus the torch conveniences: DataLoader and Dataset
    inputs, and ``training_operator_cls``."""

    training_operator_cls = None

    def fit(self, data, epochs=1, batch_size=32, **kwargs):
        """As ``TPUEstimator.fit``, after a DataLoader (or a creator of
        one) is read into arrays. With ``training_operator_cls`` the
        operator's ``train_epoch`` runs each epoch instead."""
        data = _maybe_from_dataloader(data, self.config, batch_size)
        if self.training_operator_cls is not None:
            return self._fit_with_operator(data, epochs, batch_size,
                                           **kwargs)
        return super().fit(data, epochs=epochs, batch_size=batch_size,
                           **kwargs)

    def _fit_with_operator(self, data, epochs, batch_size,
                           feature_cols=None, label_cols=None, **_):
        """The operator path, as in the JAX package: a shuffled iterator
        with no build draw (epoch e shuffles with seed + e), no checkpoint
        trigger and no retries."""
        self.engine.build()
        op = self.training_operator_cls(self.config, self.engine,
                                        world_rank=0)
        it = learn_utils.data_to_iterator(
            data, batch_size, feature_cols, label_cols, shuffle=True,
            config=self.config, device=self.device,
            stats=self._pipeline_stats)
        stats = []
        for ep in range(epochs):
            s = op.train_epoch(it.epoch(), {"epoch_idx": ep})
            s["epoch"] = ep + 1
            stats.append(s)
        self._operator = op
        return stats

    def evaluate(self, data, batch_size=32, **kwargs):
        data = _maybe_from_dataloader(data, self.config, batch_size)
        return super().evaluate(data, batch_size=batch_size, **kwargs)

    def predict(self, data, batch_size=32, **kwargs):
        data = _maybe_from_dataloader(data, self.config, batch_size)
        return super().predict(data, batch_size=batch_size, **kwargs)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _maybe_from_dataloader(data, config, batch_size):
    """A torch DataLoader or Dataset (or a creator returning one) read
    once, in its own order, into ``{"x", "y"}`` arrays; anything else is
    returned as it is (an ordinary data creator is called downstream)."""
    import torch.utils.data as tud
    produced = data
    if callable(data) and not isinstance(data, (list, tuple, dict)):
        try:
            produced = data(config or {}, batch_size)
        except TypeError:
            return data
        if not isinstance(produced, (tud.DataLoader, tud.Dataset)):
            return data
    if isinstance(produced, tud.Dataset) and not isinstance(
            produced, tud.IterableDataset):
        produced = tud.DataLoader(produced, batch_size=len(produced))
    if isinstance(produced, tud.DataLoader):
        xs, ys = [], []
        for batch in produced:
            if isinstance(batch, (list, tuple)) and len(batch) == 2:
                x, y = batch
                xs.append(_host(x))
                ys.append(_host(y))
            else:
                xs.append(_host(batch))
        x = np.concatenate(xs)
        if ys:
            return {"x": x, "y": np.concatenate(ys)}
        return {"x": x}
    return data
