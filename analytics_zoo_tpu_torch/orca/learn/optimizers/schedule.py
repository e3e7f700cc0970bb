"""LR schedules (counterpart of ``analytics_zoo_tpu/orca/learn/optimizers/
schedule.py``, whose schedules build optax schedule functions).

Here each schedule is a plain function of the step: ``lr_at(step,
base_lr) -> float``, with optax's formulas written out in Python:

* ``polynomial_schedule(init, end, power, steps)``: the step is clamped to
  ``[0, steps]`` and the lr is ``(init - end) * (1 - step / steps) ** power
  + end`` (``init`` when ``steps <= 0``); ``linear_schedule`` is the same
  with power 1;
* ``join_schedules(schedules, boundaries)``: the last boundary at or below
  the step picks the segment, which is evaluated at ``step - boundary``.

The optimizer applies ``lr_at(count)`` with the count of updates made
before this one, as optax's ``scale_by_schedule`` does (the first update
uses ``lr_at(0)``).

``Default``, ``Poly``, ``Warmup`` and ``SequentialSchedule`` are ported;
the others keep their names and raise "not ported yet" when constructed.
"""

from __future__ import annotations

from typing import List, Optional


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


class _NotPorted(Scheduler):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"lr schedule {type(self).__name__} is not ported yet (Default, "
            "Poly, Warmup and SequentialSchedule are)")


class Exponential(_NotPorted):
    pass


class Step(_NotPorted):
    pass


class MultiStep(_NotPorted):
    pass


class Plateau(_NotPorted):
    pass
