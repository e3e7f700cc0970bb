"""LR schedules (counterpart of ``analytics_zoo_tpu/orca/learn/optimizers/
schedule.py``). ``Default``, the constant lr, is ported; the others keep
their names and raise "not ported yet" when constructed."""

from __future__ import annotations


class Scheduler:
    """Base of the lr schedules."""


class Default(Scheduler):
    """Constant lr."""


class _NotPorted(Scheduler):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"lr schedule {type(self).__name__} is not ported yet (only "
            "Default is)")


class Poly(_NotPorted):
    pass


class Exponential(_NotPorted):
    pass


class Step(_NotPorted):
    pass


class MultiStep(_NotPorted):
    pass


class Warmup(_NotPorted):
    pass


class Plateau(_NotPorted):
    pass


class SequentialSchedule(_NotPorted):
    pass
