"""Model builders bridging creator functions to the search engine
(counterpart of ``analytics_zoo_tpu/automl/model_builder.py``).

Reference: pyzoo/zoo/automl/model/model_builder.py + base_pytorch_model.py
/ base_keras_model.py (build(config) -> model with fit_eval). The JAX
package converts a torch or Keras creator's model to flax; here the
creator returns an ``nn.Module`` (or a port Keras net, whose module and
compile arguments are taken) and it trains as it is, through the port's
``TPUEstimator`` on the trial's leased device, as ``Estimator.from_torch``
trains it (``orca/learn/pytorch``):

* loss: ``loss_creator`` (a class is instantiated, anything else called
  with the config), mapped through the torch loss table; else a Keras
  net's compiled loss; else ``config["loss"]`` by name;
* optimizer: ``optimizer_creator(model, config)`` — a
  ``torch.optim.Optimizer`` over the model's parameters, a port optimizer
  or a factory; else ``Adam(lr=config["lr"])`` where the config has an
  ``lr``; else a Keras net's compiled optimizer; else Adam.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..common.context import resolve_device


class ModelBuilder:
    def __init__(self, model_creator: Callable,
                 optimizer_creator: Optional[Callable] = None,
                 loss_creator: Optional[Callable] = None,
                 metric_extra: Optional[list] = None):
        self.model_creator = model_creator
        self.optimizer_creator = optimizer_creator
        self.loss_creator = loss_creator
        self.metric_extra = metric_extra or []

    def __call__(self, config: Dict, device) -> "TrialModel":
        return TrialModel(self, config, device)


class TrialModel:
    def __init__(self, builder: ModelBuilder, config: Dict, device):
        self.builder = builder
        self.config = dict(config)
        self.device = resolve_device(device)
        self.estimator = None

    def _build_estimator(self, metric: str):
        from ..orca.learn.estimator import TPUEstimator
        from ..orca.learn.losses import convert_loss
        from ..orca.learn.optimizers import Adam
        from ..orca.learn.pytorch.estimator import (_resolve_loss,
                                                    convert_torch_loss)

        model = self.builder.model_creator(self.config)
        optimizer: Any = "adam"
        compiled: Dict[str, Any] = {}
        if not isinstance(model, torch.nn.Module) and hasattr(
                model, "to_module"):            # a port Keras net
            compiled = dict(getattr(model, "_compile_args", {}) or {})
            model = model.to_module()
            optimizer = compiled.get("optimizer", optimizer)
        if not isinstance(model, torch.nn.Module):
            raise TypeError(
                f"model_creator returned {type(model).__module__}."
                f"{type(model).__name__}; the PyTorch port takes a "
                "torch.nn.Module or a Keras net of the port")
        model.to(self.device)
        loss = convert_torch_loss(_resolve_loss(self.builder.loss_creator,
                                                self.config))
        if loss is None:
            loss = compiled.get("loss")
        if loss is None and self.config.get("loss"):
            loss = convert_loss(self.config["loss"])
        if self.builder.optimizer_creator is not None:
            opt = self.builder.optimizer_creator(model, self.config)
            if isinstance(opt, torch.optim.Optimizer):
                optimizer = lambda params: opt      # noqa: E731
            else:
                optimizer = opt
        elif "lr" in self.config:
            optimizer = Adam(lr=float(self.config["lr"]))
        metrics = [metric] if metric not in ("loss",) else None
        return TPUEstimator(model, loss=loss, optimizer=optimizer,
                            metrics=metrics, config=self.config,
                            device=self.device)

    def fit_eval(self, data, validation_data=None, epochs: int = 1,
                 metric: str = "mse", state: Any = None,
                 trial_context=None) -> Tuple[float, Dict, Any]:
        """Train to a (cumulative) epoch budget and score on validation data.

        The extended protocol of the JAX package (both kwargs optional):

        * ``state`` — the state a previous ``fit_eval`` returned
          (``TrainEngine.get_state()`` + ``epochs_done``): training resumes
          from it and ``epochs`` is the *cumulative* target, so a trial
          paused at epoch 3 and resumed with ``epochs=9`` trains 6 more,
          on the batch order of the uninterrupted run (``fit(...,
          initial_epoch=...)``).
        * ``trial_context`` — a ``scheduler.TrialContext``: training runs
          segment by segment between rung boundaries, reporting the
          validation score at each boundary; the scheduler may raise
          ``TrialPaused``/``TrialPreempted`` out of ``report``/``heartbeat``
          after capturing a checkpoint via ``set_state_fn``.
        """
        est = self.estimator = self.estimator or self._build_estimator(metric)
        batch_size = int(self.config.get("batch_size", 32))
        data = data(self.config, batch_size) if callable(data) else data
        if validation_data is None:
            validation_data = data
        elif callable(validation_data):
            validation_data = validation_data(self.config, batch_size)
        epochs_done = 0
        if state is not None:
            est.engine.set_state(state)
            epochs_done = int(state.get("epochs_done", 0))

        def snapshot():
            s = est.engine.get_state()
            s["epochs_done"] = epochs_done
            return s

        if trial_context is not None:
            trial_context.set_state_fn(snapshot)
        total = int(epochs)
        result = None
        while epochs_done < total:
            if trial_context is not None:
                trial_context.heartbeat(epochs_done)
                boundary = min(total,
                               trial_context.next_boundary(epochs_done)
                               or total)
            else:
                boundary = total
            est.fit(data, epochs=boundary - epochs_done,
                    batch_size=batch_size, verbose=False,
                    initial_epoch=epochs_done)
            epochs_done = boundary
            result = est.evaluate(validation_data, batch_size=batch_size,
                                  verbose=False)
            score = result.get(metric, result.get("loss"))
            if trial_context is not None:
                trial_context.report(epochs_done, float(score))
        if result is None:      # resumed at/past the budget: score only
            result = est.evaluate(validation_data, batch_size=batch_size,
                                  verbose=False)
            score = result.get(metric, result.get("loss"))
        return float(score), result, snapshot()
