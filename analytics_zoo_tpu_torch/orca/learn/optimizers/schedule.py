"""LR schedules (counterpart of ``analytics_zoo_tpu/orca/learn/optimizers/
schedule.py``, whose schedules build optax schedule functions).

Here each schedule is a plain function of the step: ``lr_at(step,
base_lr) -> float``, with optax's formulas written out in Python:

* ``polynomial_schedule(init, end, power, steps)``: the step is clamped to
  ``[0, steps]`` and the lr is ``(init - end) * (1 - step / steps) ** power
  + end`` (``init`` when ``steps <= 0``); ``linear_schedule`` is the same
  with power 1;
* ``join_schedules(schedules, boundaries)``: the last boundary at or below
  the step picks the segment, which is evaluated at ``step - boundary``;
* ``exponential_decay(init, steps, rate, staircase)``: ``init * rate **
  (step / steps)``, the exponent floored with ``staircase`` (``init`` at
  step 0, or when ``steps <= 0`` or ``rate == 0``);
* ``piecewise_constant_schedule(init, {boundary: scale})``: ``init``
  times the scale of every boundary at or below the step.

The optimizer applies ``lr_at(count)`` with the count of updates made
before this one, as optax's ``scale_by_schedule`` does (the first update
uses ``lr_at(0)``). On the card the engine writes it into the param
groups' lr tensors, eagerly or inside a fused group's CUDA graph.

``Plateau`` trains at its constant lr, as the JAX package's does: the JAX
estimator never calls ``Plateau.on_metric``, so its lr scale never
reaches ``fit``. The port keeps that (ROADMAP queue C).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence


def _polynomial(init: float, end: float, power: float, steps: int,
                count: int) -> float:
    """optax ``polynomial_schedule(init, end, power, steps)(count)``."""
    if steps <= 0:
        return float(init)
    count = min(max(count, 0), steps)
    return (init - end) * (1.0 - count / steps) ** power + end


class Scheduler:
    """Base of the lr schedules: ``lr_at(step, base_lr)`` is the lr of the
    update that follows ``step`` earlier updates."""

    def lr_at(self, step: int, base_lr: float) -> float:
        raise NotImplementedError


class Default(Scheduler):
    """Constant lr."""

    def lr_at(self, step: int, base_lr: float) -> float:
        return float(base_lr)


class Poly(Scheduler):
    """lr = base * (1 - step/max_iteration)^power, 0 past max_iteration."""

    def __init__(self, power: float, max_iteration: int):
        self.power, self.max_iteration = power, max_iteration

    def lr_at(self, step: int, base_lr: float) -> float:
        return _polynomial(base_lr, 0.0, self.power, self.max_iteration,
                           step)


class Warmup(Scheduler):
    """Linear lr increase by ``delta`` per step over ``steps`` steps (1 when
    not given; a SequentialSchedule gives it its segment's length)."""

    def __init__(self, delta: float, steps: Optional[int] = None):
        self.delta, self.steps = delta, steps

    def lr_at(self, step: int, base_lr: float) -> float:
        steps = self.steps if self.steps is not None else 1
        return _polynomial(base_lr, base_lr + self.delta * steps, 1.0, steps,
                           step)


class SequentialSchedule(Scheduler):
    """Chain schedules, each active for its ``max_iteration`` steps. A
    Warmup's end becomes the next segment's base, so Warmup -> Poly ramps
    to the peak and decays from it."""

    def __init__(self, iteration_per_epoch: int = 1):
        self.iteration_per_epoch = iteration_per_epoch
        self._entries: List = []

    def add(self, scheduler: Scheduler, max_iteration: int
            ) -> "SequentialSchedule":
        self._entries.append((scheduler, max_iteration))
        return self

    def _segments(self, base_lr: float):
        """(boundary, schedule, base) per segment, the first at 0."""
        segs, acc, current = [], 0, base_lr
        for sched, n in self._entries:
            if isinstance(sched, Warmup) and sched.steps is None:
                sched = Warmup(sched.delta, n)
            segs.append((acc, sched, current))
            if isinstance(sched, Warmup):
                current = current + sched.delta * (sched.steps or n)
            acc += n
        return segs

    def lr_at(self, step: int, base_lr: float) -> float:
        segs = self._segments(base_lr)
        if not segs:
            return float(base_lr)
        start, sched, base = segs[0]
        for seg in segs[1:]:
            if step >= seg[0]:
                start, sched, base = seg
        return sched.lr_at(step - start, base)


def _exponential(init: float, steps: int, rate: float, staircase: bool,
                 count: int) -> float:
    """optax ``exponential_decay(init, steps, rate, staircase=...)(count)``
    (no transition begin, no end value)."""
    if steps <= 0 or rate == 0 or count <= 0:
        return float(init)
    p = count / steps
    if staircase:
        p = math.floor(p)
    return init * rate ** p


class Exponential(Scheduler):
    """lr = base * decay_rate ^ (step / decay_step), the exponent an integer
    with ``stair_case``."""

    def __init__(self, decay_step: int, decay_rate: float,
                 stair_case: bool = False):
        self.decay_step, self.decay_rate = decay_step, decay_rate
        self.stair_case = stair_case

    def lr_at(self, step: int, base_lr: float) -> float:
        return _exponential(base_lr, self.decay_step, self.decay_rate,
                            self.stair_case, step)


class Step(Scheduler):
    """lr decayed by ``gamma`` every ``step_size`` steps."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size, self.gamma = step_size, gamma

    def lr_at(self, step: int, base_lr: float) -> float:
        return _exponential(base_lr, self.step_size, self.gamma, True, step)


class MultiStep(Scheduler):
    """lr times ``gamma`` at each of ``step_sizes`` (from that step on)."""

    def __init__(self, step_sizes: Sequence[int], gamma: float):
        self.step_sizes, self.gamma = list(step_sizes), gamma

    def lr_at(self, step: int, base_lr: float) -> float:
        v = float(base_lr)
        for boundary in sorted(set(self.step_sizes)):
            if step >= boundary:
                v = self.gamma * v
        return v


class Plateau(Scheduler):
    """Reduce-on-plateau: ``on_metric`` keeps the JAX class's state machine
    and returns its lr scale, but ``lr_at`` is the constant base lr, as the
    JAX class's optax schedule is: no estimator calls ``on_metric``."""

    def __init__(self, monitor: str = "score", factor: float = 0.1,
                 patience: int = 10, mode: str = "min", epsilon: float = 1e-4,
                 cooldown: int = 0, min_lr: float = 0.0):
        if mode not in ("min", "max"):
            raise ValueError(f"Plateau mode must be 'min' or 'max', not "
                             f"{mode!r}")
        self.monitor, self.factor, self.patience = monitor, factor, patience
        self.mode, self.epsilon, self.cooldown = mode, epsilon, cooldown
        self.min_lr = min_lr
        self._best = None
        self._wait = 0
        self._cooling = 0
        self.scale = 1.0

    def lr_at(self, step: int, base_lr: float) -> float:
        return float(base_lr)

    def on_metric(self, value: float, base_lr: float) -> float:
        """Take a new monitored value; return the lr scale."""
        better = (self._best is None or
                  (self.mode == "min" and value < self._best - self.epsilon)
                  or (self.mode == "max"
                      and value > self._best + self.epsilon))
        if self._cooling > 0:
            self._cooling -= 1
            self._wait = 0
        if better:
            self._best = value
            self._wait = 0
        else:
            self._wait += 1
            if self._wait > self.patience:
                self.scale = max(self.scale * self.factor,
                                 self.min_lr / max(base_lr, 1e-12))
                self._cooling = self.cooldown
                self._wait = 0
        return self.scale
