"""Optimizers (counterpart of ``analytics_zoo_tpu/orca/learn/optimizers/
optimizers_impl.py``, whose wrappers build optax transforms).

Here each wrapper builds a ``torch.optim`` optimizer over the module's
parameters: ``to_torch()`` returns a factory ``params -> Optimizer``. The
update rules are optax's, and the three ported optimizers agree with it in
exact arithmetic (they differ only in rounding order):

* ``SGD``: optax ``chain(add_decayed_weights(wd), sgd(lr, momentum,
  nesterov))`` is torch's SGD with ``weight_decay=wd`` and dampening 0:
  g += wd*p, trace = momentum*trace + g (torch starts its buffer at g, which
  is optax's zero trace plus g), update = g + momentum*trace with nesterov,
  else trace; p -= lr*update. ``dampening`` is accepted and ignored, as in
  the JAX package.
* ``Adam``: optax's mu_hat / (sqrt(nu_hat) + eps) with bias-corrected
  moments is torch's (m/bc1) / (sqrt(v)/sqrt(bc2) + eps), written the other
  way round.
* ``AdamWeightDecay``: optax ``adamw`` updates p -= lr*(adam + wd*p);
  torch's AdamW first scales p by (1 - lr*wd), then p -= lr*adam: the same
  sum.

A schedule (``Default``, ``Poly``, ``Warmup``, ``SequentialSchedule``)
rides on the factory as ``factory.lr_at(step)``: the engine sets every
param group's lr to it before each update, with the count of earlier
updates, which is optax's ``scale_by_schedule`` (optax multiplies the
update by ``lr(count)``; each of the three rules above is linear in its
lr, AdamW's decay term included). A constant lr leaves ``lr_at`` None.
``Adagrad``, ``Adadelta``, ``Adamax``, ``RMSprop``, ``Ftrl`` and
``LBFGS`` raise "not ported yet" when constructed.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

from .schedule import Default, Scheduler

OptimizerFactory = Callable[[Iterable[torch.nn.Parameter]],
                            torch.optim.Optimizer]


class Optimizer:
    """Base wrapper: ``to_torch()`` yields a factory ``params ->
    torch.optim.Optimizer``."""

    def __init__(self, lr: float, schedule: Optional[Scheduler] = None):
        self.lr = lr
        self.schedule = schedule or Default()
        if not isinstance(self.schedule, Scheduler):
            raise ValueError(f"{self.schedule!r} is not a schedule of "
                             "orca.learn.optimizers.schedule")

    def lr_at(self, step: int) -> float:
        """The lr of the update that follows ``step`` earlier updates."""
        return self.schedule.lr_at(step, self.lr)

    def _factory(self, make: OptimizerFactory) -> OptimizerFactory:
        """``make`` with the schedule as ``make.lr_at`` (None: constant)."""
        make.lr_at = (None if type(self.schedule) is Default
                      else self.lr_at)
        return make

    def to_torch(self) -> OptimizerFactory:
        raise NotImplementedError


class SGD(Optimizer):
    def __init__(self, learningrate: float = 1e-3, momentum: float = 0.0,
                 dampening: float = 0.0, nesterov: bool = False,
                 weightdecay: float = 0.0, leaningrate_schedule=None, **_):
        super().__init__(learningrate, leaningrate_schedule)
        self.momentum, self.nesterov = momentum, nesterov
        self.weightdecay = weightdecay

    def to_torch(self):
        return self._factory(lambda params: torch.optim.SGD(
            params, lr=self.lr, momentum=self.momentum,
            nesterov=self.nesterov, weight_decay=self.weightdecay))


class Adam(Optimizer):
    def __init__(self, lr: float = 1e-3, beta_1: float = 0.9,
                 beta_2: float = 0.999, epsilon: float = 1e-8,
                 decay: float = 0.0, schedule=None, **_):
        super().__init__(lr, schedule)
        if decay:
            raise NotImplementedError("Adam's lr decay is a schedule and is "
                                      "not ported yet")
        self.b1, self.b2, self.eps = beta_1, beta_2, epsilon

    def to_torch(self):
        return self._factory(lambda params: torch.optim.Adam(
            params, lr=self.lr, betas=(self.b1, self.b2), eps=self.eps))


class ParallelAdam(Adam):
    """Adam: in the JAX package its parallelism comes from sharding the
    optimizer state over the mesh; numerically it is Adam."""


class AdamWeightDecay(Optimizer):
    """AdamW, the optimizer of BERT fine-tuning."""

    def __init__(self, lr: float = 1e-3, weight_decay: float = 0.01,
                 beta_1: float = 0.9, beta_2: float = 0.999,
                 epsilon: float = 1e-6, schedule=None, **_):
        super().__init__(lr, schedule)
        self.wd, self.b1, self.b2, self.eps = (weight_decay, beta_1, beta_2,
                                               epsilon)

    def to_torch(self):
        return self._factory(lambda params: torch.optim.AdamW(
            params, lr=self.lr, betas=(self.b1, self.b2), eps=self.eps,
            weight_decay=self.wd))


class _NotPorted(Optimizer):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"optimizer {type(self).__name__} is not ported yet (SGD, Adam, "
            "ParallelAdam and AdamWeightDecay are)")


class Adagrad(_NotPorted):
    pass


class Adadelta(_NotPorted):
    pass


class Adamax(_NotPorted):
    pass


class RMSprop(_NotPorted):
    pass


class Ftrl(_NotPorted):
    pass


class LBFGS(_NotPorted):
    pass


_BY_NAME = {"sgd": SGD, "adam": Adam, "adagrad": Adagrad,
            "adadelta": Adadelta, "adamax": Adamax, "rmsprop": RMSprop,
            "ftrl": Ftrl, "adamw": AdamWeightDecay}


def convert_optimizer(opt, learning_rate: Optional[float] = None
                      ) -> OptimizerFactory:
    """Optimizer | name | torch.optim factory -> factory ``params ->
    torch.optim.Optimizer``. A factory is any callable taking the
    parameters, e.g. ``lambda ps: torch.optim.SGD(ps, lr=0.1)`` or a
    ``torch.optim.Optimizer`` subclass whose other arguments have
    defaults. An explicit ``learning_rate`` overrides a name's default."""
    if isinstance(opt, Optimizer):
        return opt.to_torch()
    if isinstance(opt, str):
        key = opt.lower()
        if key not in _BY_NAME:
            raise ValueError(f"unknown optimizer '{opt}'")
        cls = _BY_NAME[key]
        if learning_rate is None:
            return cls().to_torch()
        name = "learningrate" if cls is SGD else "lr"
        return cls(**{name: learning_rate}).to_torch()
    if isinstance(opt, torch.optim.Optimizer):
        raise ValueError("pass a factory (params -> torch.optim.Optimizer), "
                         "not an optimizer already bound to parameters")
    if callable(opt):
        return opt
    raise ValueError(f"cannot convert {opt!r} to an optimizer")
