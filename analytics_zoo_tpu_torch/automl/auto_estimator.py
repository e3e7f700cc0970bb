"""AutoEstimator — HPO front door (counterpart of
``analytics_zoo_tpu/automl/auto_estimator.py``; reference: pyzoo/zoo/orca/
automl/auto_estimator.py: from_torch/from_keras + fit(data, search_space,
n_sampling, epochs, metric) + get_best_model).

Trials run on ``device`` (``None``: every visible card, one trial a card
at a time; without a GPU it raises unless given ``device="cpu"``).
``from_keras`` takes creators of a port Keras net (``pipeline.api.keras``)
or of an ``nn.Module``. An optimizer name maps to the port's
optax-formula optimizer at optax's defaults, with ``config["lr"]`` (1e-3
without one), as the JAX package maps it to ``optax.<name>(lr)``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from ..common.context import resolve_device
from .model_builder import ModelBuilder
from .search.search_engine import TPUSearchEngine
from .search.search_engine import UNSET as _UNSET


class AutoEstimator:
    def __init__(self, model_builder: ModelBuilder,
                 logs_dir: Optional[str] = None, resources_per_trial=None,
                 name: str = "auto_estimator", device=None):
        self.model_builder = model_builder
        self.device = resolve_device(device)
        self.searcher = TPUSearchEngine(name=name, logs_dir=logs_dir,
                                        device=self.device)
        self._fitted = False

    @staticmethod
    def from_torch(*, model_creator: Callable,
                   optimizer: Optional[Callable] = None,
                   loss: Optional[Callable] = None,
                   logs_dir: Optional[str] = None,
                   resources_per_trial=None,
                   name: str = "auto_torch", device=None) -> "AutoEstimator":
        """(reference: auto_estimator.py:34)"""
        builder = ModelBuilder(model_creator,
                               optimizer_creator=_wrap_opt(optimizer),
                               loss_creator=_wrap_loss(loss))
        return AutoEstimator(builder, logs_dir, resources_per_trial, name,
                             device=device)

    @staticmethod
    def from_keras(*, model_creator: Callable,
                   logs_dir: Optional[str] = None,
                   resources_per_trial=None, loss=None, optimizer=None,
                   name: str = "auto_keras", device=None) -> "AutoEstimator":
        """(reference: auto_estimator.py:75; ``loss``/``optimizer`` cover
        creators whose net is not compiled)"""
        builder = ModelBuilder(model_creator,
                               optimizer_creator=_wrap_opt(optimizer),
                               loss_creator=_wrap_loss(loss))
        return AutoEstimator(builder, logs_dir, resources_per_trial, name,
                             device=device)

    def fit(self, data, epochs: int = 1, validation_data=None,
            metric: Optional[str] = None, metric_mode: Optional[str] = None,
            metric_threshold=None, n_sampling: int = 1,
            search_space: Optional[Dict] = None, search_alg=None,
            scheduler=None, scheduler_params: Optional[Dict] = None,
            keep_model_states=_UNSET, **_) -> "AutoEstimator":
        """(reference: auto_estimator.py:99)

        ``scheduler="asha"`` runs trials through the fault-tolerant rung
        scheduler (``automl.scheduler.TrialRuntime``): ``epochs`` becomes
        the max per-trial budget, losing trials pause at rung boundaries
        via checkpoint and only the top 1/eta train on; ``scheduler_params``
        tunes {eta, grace_period, max_trial_retries, retry_backoff_s}.

        ``metric_threshold`` maps to the engine's ``stop_score`` (the
        reference's tune stop condition)."""
        if self._fitted:
            raise RuntimeError(
                "This AutoEstimator has already been fitted and cannot fit "
                "again.")  # same guard as the reference
        metric = metric or "loss"
        if metric_mode is None:
            metric_mode = "max" if any(
                s in metric for s in ("acc", "auc", "top", "r2")) else "min"
        self.searcher.compile(data, self.model_builder, search_space or {},
                              n_sampling=n_sampling, epochs=epochs,
                              validation_data=validation_data, metric=metric,
                              metric_mode=metric_mode, search_alg=search_alg,
                              stop_score=metric_threshold,
                              scheduler=scheduler,
                              scheduler_params=scheduler_params,
                              keep_model_states=keep_model_states)
        self.searcher.run()
        self._fitted = True
        return self

    def search_summary(self) -> Dict:
        """Study telemetry (scheduler rungs/counters/device utilization
        when scheduler='asha' ran; trials by state, epochs and device
        utilization otherwise)."""
        return self.searcher.summary()

    def get_best_model(self):
        """Rebuild the winning trial's estimator with its trained weights
        (reference: auto_estimator.py:121)."""
        best = self.searcher.get_best_trial()
        model = self.model_builder(best.config, self.device)
        est = model._build_estimator(self.searcher.metric)
        if best.model_state is not None:
            est.engine.set_state(best.model_state)
        return est

    def get_best_config(self) -> Dict:
        return dict(self.searcher.get_best_trial().config)

    @property
    def best_trial(self):
        return self.searcher.get_best_trial()

    def get_trials(self):
        return self.searcher._trials


def _wrap_opt(optimizer):
    """A name -> a creator of the port's optimizer at optax's defaults
    (``optax.sgd``/``adam``/``rmsprop``/``adagrad`` with the config's lr);
    anything else passes through."""
    if optimizer is None:
        return None
    if isinstance(optimizer, str):
        def creator(model, config):
            from ..orca.learn.optimizers import SGD, Adagrad, Adam, RMSprop
            lr = config.get("lr", 1e-3)
            return {"sgd": lambda: SGD(learningrate=lr),
                    "adam": lambda: Adam(lr=lr),
                    # optax.rmsprop's decay 0.9 (the port's RMSprop
                    # defaults to the JAX class's 0.99)
                    "rmsprop": lambda: RMSprop(lr=lr, decayrate=0.9),
                    "adagrad": lambda: Adagrad(learningrate=lr),
                    }[optimizer.lower()]()
        return creator
    return optimizer


def _wrap_loss(loss):
    if loss is None:
        return None
    if isinstance(loss, str):
        from ..orca.learn.losses import convert_loss
        fn = convert_loss(loss)
        return lambda config: fn
    if callable(loss) and not isinstance(loss, type):
        return lambda config: loss
    return loss
