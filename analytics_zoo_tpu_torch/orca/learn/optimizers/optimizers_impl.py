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

A schedule (any of ``schedule.py``) rides on the factory as
``factory.lr_at(step)``: the engine sets every param group's lr to it
before each update, with the count of earlier updates, which is optax's
``scale_by_schedule`` (optax multiplies the update by ``lr(count)``; each
of the three rules above is linear in its lr, AdamW's decay term
included). A constant lr leaves ``lr_at`` None. Adam's ``decay`` d is the
JAX class's lr function ``schedule(step) / (1 + d * step)``.

**On the card every optimizer is capture-safe** (a fused group is one
CUDA-graph replay, ``orca/learn/graphs.py``): its lr is a 0-dim float32
device tensor per param group, which the engine writes before each eager
update and a graph copies from its per-replay table; ``SGD`` is built
``fused=True`` (torch's fused kernel takes the lr tensor without reading
it back), ``Adam``/``AdamWeightDecay`` ``capturable=True`` (step counts
and bias corrections on the device), and the rules below keep their step
count on the device. On the CPU the lr stays a float, as before.

Five more compute optax's formulas, which are not torch's built-ins', so
each is its own ``torch.optim.Optimizer`` here (in f32, the order of
operations optax's):

* ``Adagrad`` (optax ``adagrad``): the accumulator starts at 0.1 (torch's
  at 0), acc += g^2, update = g * rsqrt(acc + 1e-7) with eps inside the
  root (torch adds it outside), and 0 where acc is 0. ``weightdecay``
  adds wd * p to g first; ``learningrate_decay`` d is the schedule
  lr / (1 + d * step), as the JAX class builds it.
* ``RMSprop`` (optax ``rmsprop``): nu = (1 - decay) g^2 + decay nu from
  0, update = g * rsqrt(nu + eps), eps inside the root.
* ``Adamax`` (optax ``adamax``): mu = (1 - b1) g + b1 mu, nu = max(|g| +
  eps, b2 nu), update = mu / (1 - b1^t) / nu. The JAX class's eps, 1e-38,
  is below f32's smallest normal (1.18e-38): stored in f32 it is the
  subnormal 9.99995e-39, and a parameter whose gradient has been 0 at
  every step divides 0 by it (0) or, where subnormals are flushed to
  zero, by 0 (NaN). The port keeps the subnormal (torch flushes none
  unless ``torch.set_flush_denormal(True)``, on the CPU or the card).
* ``Adadelta`` (optax ``adadelta``, rho 0.9, eps 1e-10, lr 1): e_g = (1 -
  rho) g^2 + rho e_g; delta = sqrt(e_x + eps) / sqrt(e_g + eps) * g; e_x
  = (1 - rho) delta^2 + rho e_x; update = delta.
* ``Ftrl``: the JAX class builds ``optax.ftrl`` where optax has it, and
  otherwise (optax 0.2.6 has none) ``adagrad(lr,
  initial_accumulator_value)`` with ``l2_regularization_strength`` as
  weight decay; l1 and ``learningrate_power`` are dropped. The port
  reproduces that fallback.

``LBFGS(max_iter, learningrate)`` builds ``torch.optim.LBFGS(lr=...,
max_iter=...)``, as the JAX class builds ``optax.lbfgs(lr)``. Neither
trains in a ``fit``: optax's zoom line search needs ``value``, ``grad``
and ``value_fn``, torch's LBFGS a ``closure``, and neither engine passes
them, so the first step raises ``TypeError`` in both packages (ROADMAP,
reference caveats).
"""

from __future__ import annotations

import inspect
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

    def _scheduled(self) -> bool:
        return type(self.schedule) is not Default

    def _factory(self, make: OptimizerFactory) -> OptimizerFactory:
        """``make`` with the schedule as ``make.lr_at`` (None: constant)."""
        make.lr_at = self.lr_at if self._scheduled() else None
        return make

    def _lr(self, params) -> float | torch.Tensor:
        """The lr to build the optimizer with: a float32 device tensor when
        the parameters are on the card, else the float."""
        dev = params[0].device if params else torch.device("cpu")
        if dev.type != "cuda":
            return self.lr
        return torch.tensor(float(self.lr), dtype=torch.float32, device=dev)

    def to_torch(self) -> OptimizerFactory:
        raise NotImplementedError


def _on_card(params) -> bool:
    return bool(params) and params[0].device.type == "cuda"


class SGD(Optimizer):
    def __init__(self, learningrate: float = 1e-3, momentum: float = 0.0,
                 dampening: float = 0.0, nesterov: bool = False,
                 weightdecay: float = 0.0, leaningrate_schedule=None, **_):
        super().__init__(learningrate, leaningrate_schedule)
        self.momentum, self.nesterov = momentum, nesterov
        self.weightdecay = weightdecay

    def to_torch(self):
        return self._factory(lambda params: torch.optim.SGD(
            params, lr=self._lr(params), momentum=self.momentum,
            nesterov=self.nesterov, weight_decay=self.weightdecay,
            fused=True if _on_card(params) else None))


class Adam(Optimizer):
    def __init__(self, lr: float = 1e-3, beta_1: float = 0.9,
                 beta_2: float = 0.999, epsilon: float = 1e-8,
                 decay: float = 0.0, schedule=None, **_):
        super().__init__(lr, schedule)
        self.b1, self.b2, self.eps, self.decay = (beta_1, beta_2, epsilon,
                                                  decay)

    def _scheduled(self) -> bool:
        return super()._scheduled() or bool(self.decay)

    def lr_at(self, step: int) -> float:
        """The schedule's lr over ``1 + decay * step`` (the JAX class's)."""
        return super().lr_at(step) / (1.0 + self.decay * step)

    def to_torch(self):
        return self._factory(lambda params: torch.optim.Adam(
            params, lr=self._lr(params), betas=(self.b1, self.b2),
            eps=self.eps, capturable=_on_card(params)))


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
            params, lr=self._lr(params), betas=(self.b1, self.b2),
            eps=self.eps, weight_decay=self.wd,
            capturable=_on_card(params)))


class _OptaxRule(torch.optim.Optimizer):
    """A ``torch.optim.Optimizer`` applying p += -lr * direction(g), with
    g = grad + weight_decay * p (optax's ``add_decayed_weights`` first in
    the chain). Subclasses give ``_direction(g, state, group)``. Every
    operation is a device operation (the lr a float or a device tensor),
    so a step captures into a CUDA graph."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0,
                 **defaults):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      **defaults))

    def _direction(self, g, state, group):
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                u = self._direction(g, self.state[p], group)
                p.add_(u * -group["lr"])
        return loss


class AdagradRule(_OptaxRule):
    """optax ``scale_by_rss``: state ``sum`` (its ``sum_of_squares``)."""

    def __init__(self, params, lr, weight_decay=0.0,
                 initial_accumulator_value=0.1, eps=1e-7):
        super().__init__(params, lr, weight_decay,
                         initial_accumulator_value=initial_accumulator_value,
                         eps=eps)

    def _direction(self, g, state, group):
        if "sum" not in state:
            state["sum"] = torch.full_like(
                g, group["initial_accumulator_value"])
        acc = state["sum"]
        acc.copy_(g * g + acc)
        inv = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]),
                          torch.zeros_like(acc))
        return inv * g


class RMSpropRule(_OptaxRule):
    """optax ``scale_by_rms``: state ``square_avg`` (its ``nu``)."""

    def __init__(self, params, lr, decay=0.9, eps=1e-8):
        super().__init__(params, lr, decay=decay, eps=eps)

    def _direction(self, g, state, group):
        if "square_avg" not in state:
            state["square_avg"] = torch.zeros_like(g)
        nu, d = state["square_avg"], group["decay"]
        nu.copy_((1 - d) * (g * g) + d * nu)
        return torch.rsqrt(nu + group["eps"]) * g


class AdamaxRule(_OptaxRule):
    """optax ``scale_by_adamax``: state ``step`` (its ``count``),
    ``exp_avg`` (``mu``) and ``exp_inf`` (``nu``)."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps)

    def _direction(self, g, state, group):
        if "step" not in state:
            # the count lives with the parameter (on the card: no host
            # read per step, and a captured step advances it)
            state["step"] = torch.zeros((), dtype=torch.float32,
                                        device=g.device)
            state["exp_avg"] = torch.zeros_like(g)
            state["exp_inf"] = torch.zeros_like(g)
        b1, b2 = group["b1"], group["b2"]
        state["step"] += 1
        mu, nu = state["exp_avg"], state["exp_inf"]
        mu.copy_((1 - b1) * g + b1 * mu)
        nu.copy_(torch.maximum(g.abs() + group["eps"], b2 * nu))
        # 1 - b1^t in f32, as optax computes it
        correction = 1.0 - torch.pow(
            torch.tensor(b1, dtype=torch.float32, device=g.device),
            state["step"])
        return (mu / correction) / nu


class AdadeltaRule(_OptaxRule):
    """optax ``scale_by_adadelta``: states ``square_avg`` (its ``e_g``) and
    ``acc_delta`` (``e_x``)."""

    def __init__(self, params, lr=1.0, rho=0.9, eps=1e-6):
        super().__init__(params, lr, rho=rho, eps=eps)

    def _direction(self, g, state, group):
        if "square_avg" not in state:
            state["square_avg"] = torch.zeros_like(g)
            state["acc_delta"] = torch.zeros_like(g)
        rho, eps = group["rho"], group["eps"]
        e_g, e_x = state["square_avg"], state["acc_delta"]
        e_g.copy_((1 - rho) * (g * g) + rho * e_g)
        delta = torch.sqrt(e_x + eps) / torch.sqrt(e_g + eps) * g
        e_x.copy_((1 - rho) * (delta * delta) + rho * e_x)
        return delta


class Adagrad(Optimizer):
    def __init__(self, learningrate: float = 1e-3,
                 learningrate_decay: float = 0.0, weightdecay: float = 0.0,
                 **_):
        super().__init__(learningrate)
        self.lr_decay, self.weightdecay = learningrate_decay, weightdecay

    def lr_at(self, step: int) -> float:
        return self.lr / (1.0 + self.lr_decay * step)

    def to_torch(self):
        make = self._factory(lambda params: AdagradRule(
            params, lr=self._lr(params), weight_decay=self.weightdecay))
        if self.lr_decay:
            make.lr_at = self.lr_at
        return make


class Adadelta(Optimizer):
    def __init__(self, decayrate: float = 0.9, epsilon: float = 1e-10, **_):
        super().__init__(1.0)
        self.rho, self.eps = decayrate, epsilon

    def to_torch(self):
        return self._factory(lambda params: AdadeltaRule(
            params, lr=self._lr(params), rho=self.rho, eps=self.eps))


class Adamax(Optimizer):
    def __init__(self, lr: float = 2e-3, beta_1: float = 0.9,
                 beta_2: float = 0.999, epsilon: float = 1e-38, **_):
        super().__init__(lr)
        self.b1, self.b2, self.eps = beta_1, beta_2, epsilon

    def to_torch(self):
        return self._factory(lambda params: AdamaxRule(
            params, lr=self._lr(params), b1=self.b1, b2=self.b2,
            eps=self.eps))


class RMSprop(Optimizer):
    def __init__(self, lr: float = 1e-2, decayrate: float = 0.99,
                 epsilon: float = 1e-8, **_):
        super().__init__(lr)
        self.decay, self.eps = decayrate, epsilon

    def to_torch(self):
        return self._factory(lambda params: RMSpropRule(
            params, lr=self._lr(params), decay=self.decay, eps=self.eps))


class Ftrl(Optimizer):
    def __init__(self, learningrate: float = 1e-3,
                 learningrate_power: float = -0.5,
                 initial_accumulator_value: float = 0.1,
                 l1_regularization_strength: float = 0.0,
                 l2_regularization_strength: float = 0.0, **_):
        super().__init__(learningrate)
        self.lr_power = learningrate_power
        self.init_acc = initial_accumulator_value
        self.l1, self.l2 = (l1_regularization_strength,
                            l2_regularization_strength)

    def to_torch(self):
        return self._factory(lambda params: AdagradRule(
            params, lr=self._lr(params), weight_decay=self.l2,
            initial_accumulator_value=self.init_acc))


class MultiSteps(torch.optim.Optimizer):
    """optax ``MultiSteps(inner, every_k_schedule=k)``: gradient
    accumulation. Each ``step`` folds the parameters' gradients into a
    running mean, ``acc + (g - acc) / (mini_step + 1)`` as optax keeps it
    (a mean, not a sum); the k-th step hands that mean to the inner
    optimizer as the gradients, applies its update and starts a new
    window. The k - 1 steps before it change neither the parameters nor
    the inner state (so the inner step count, Adam's bias correction, and
    a schedule advance once per window).

    The counters ``mini_step`` and ``gradient_step`` are host integers:
    which step applies the update is decided on the host, a branch that a
    CUDA graph cannot replay, so the training engine refuses to capture
    it (``graph_refusal``) and trains unfused on the card.

    ``state_dict`` is the inner optimizer's with a ``"multi_steps"`` entry
    (the counters and each parameter's ``acc``, by the parameter's index
    in the inner state's numbering); ``interop`` maps it to and from
    optax's ``MultiStepsState``.
    """

    graph_refusal = ("MultiSteps (ZooOptimizer) applies its update on "
                     "every k-th step only, a host branch a CUDA graph "
                     "cannot replay")

    def __init__(self, params, make_inner: OptimizerFactory, every_k: int):
        params = list(params)
        inner = make_inner(params)
        super().__init__(params, dict(inner.defaults))
        self.inner = inner
        # one set of groups: the engine sets the lr on ours, the inner
        # optimizer reads it
        self.param_groups = inner.param_groups
        self.every_k = int(every_k)
        self.mini_step = 0
        self.gradient_step = 0

    def _params(self):
        return [p for g in self.param_groups for p in g["params"]]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        n = self.mini_step
        for p in self._params():
            if p.grad is None:
                continue
            st = self.state[p]
            if "acc" not in st:
                st["acc"] = torch.zeros_like(p)
            acc = st["acc"]
            acc.add_((p.grad - acc) / (n + 1))
        if n < self.every_k - 1:
            self.mini_step = n + 1
            return loss
        for p in self._params():
            if p.grad is not None:
                p.grad.copy_(self.state[p]["acc"])
        self.inner.step()
        for p in self._params():
            if "acc" in self.state[p]:
                self.state[p]["acc"].zero_()
        self.mini_step = 0
        self.gradient_step += 1
        return loss

    def state_dict(self):
        sd = self.inner.state_dict()
        index = {id(p): i for i, p in enumerate(self._params())}
        sd["multi_steps"] = {
            "mini_step": self.mini_step,
            "gradient_step": self.gradient_step,
            "acc": {index[id(p)]: st["acc"]
                    for p, st in self.state.items() if "acc" in st}}
        return sd

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        ms = state_dict.pop("multi_steps", None)
        self.inner.load_state_dict(state_dict)
        self.param_groups = self.inner.param_groups
        self.state.clear()
        if ms is None:
            self.mini_step = self.gradient_step = 0
            return
        self.mini_step = int(ms["mini_step"])
        self.gradient_step = int(ms["gradient_step"])
        params = self._params()
        for i, acc in ms["acc"].items():
            p = params[int(i)]
            self.state[p]["acc"] = torch.as_tensor(acc).to(
                device=p.device, dtype=p.dtype).clone()


def multi_steps(opt, every_k: int) -> OptimizerFactory:
    """A factory of :class:`MultiSteps` over ``opt`` (anything
    :func:`convert_optimizer` takes). A schedule of the inner optimizer
    advances once per window, as optax's inner count does: the engine
    asks ``lr_at`` with its count of micro-steps, and the update of
    window j reads the inner schedule at j."""
    inner = convert_optimizer(opt)
    k = int(every_k)

    def make(params):
        return MultiSteps(params, inner, k)

    inner_lr_at = getattr(inner, "lr_at", None)
    make.lr_at = ((lambda step: inner_lr_at(step // k))
                  if inner_lr_at is not None else None)
    return make


class LBFGS(Optimizer):
    """(reference: optimizers_impl.py:99) second-order, for small
    full-batch problems; ``step`` needs a closure."""

    def __init__(self, max_iter: int = 20, learningrate: float = 1.0, **_):
        super().__init__(learningrate)
        self.max_iter = max_iter

    def to_torch(self):
        return self._factory(lambda params: torch.optim.LBFGS(
            params, lr=self.lr, max_iter=self.max_iter))


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
        params = inspect.signature(cls.__init__).parameters
        for name in ("lr", "learningrate"):
            if name in params:
                return cls(**{name: learning_rate}).to_torch()
        raise ValueError(
            f"optimizer '{opt}' takes no learning-rate parameter; the "
            f"explicit learning_rate={learning_rate} would be silently "
            f"ignored; construct {cls.__name__}(...) directly instead")
    if isinstance(opt, torch.optim.Optimizer):
        raise ValueError("pass a factory (params -> torch.optim.Optimizer), "
                         "not an optimizer already bound to parameters")
    if callable(opt):
        return opt
    raise ValueError(f"cannot convert {opt!r} to an optimizer")
