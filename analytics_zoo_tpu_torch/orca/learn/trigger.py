"""Triggers controlling when checkpoints/validation fire (a copy of
``analytics_zoo_tpu/orca/learn/trigger.py``, which imports no JAX).

Mirrors the reference's trigger set (pyzoo/zoo/orca/learn/trigger.py:19-77 and
pyzoo/zoo/util/triggers.py:20-186: EveryEpoch, SeveralIteration, MaxEpoch,
MaxIteration, MaxScore, MinLoss, TriggerAnd, TriggerOr) as plain host-side
predicates over a TrainingState snapshot — no JVM ZooTrigger objects."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class TrainerState:
    epoch: int = 0           # completed epochs
    iteration: int = 0       # completed global steps
    epoch_finished: bool = False
    loss: Optional[float] = None
    score: Optional[float] = None
    records_processed: int = 0


class Trigger:
    def __call__(self, state: TrainerState) -> bool:
        raise NotImplementedError

    def arm(self, state: TrainerState) -> None:
        """Sync any internal marks to the run's starting state (the
        trainer calls this at fit() start). Default: stateless, no-op;
        composites forward to their children."""

    def fuse_cap(self):
        """Max steps the trainer may fuse per dispatch without coarsening
        this trigger's cadence (None = no constraint). Composites return
        the tightest child cap."""
        return None

    @staticmethod
    def convert_trigger(t) -> "Trigger":
        if isinstance(t, Trigger):
            return t
        if isinstance(t, str):
            if t == "every_epoch":
                return EveryEpoch()
            raise ValueError(f"unknown trigger '{t}'")
        raise ValueError(f"cannot convert {t!r} to a Trigger")


class EveryEpoch(Trigger):
    """Fires at each epoch boundary (reference: trigger.py:40)."""

    def __call__(self, state):
        return state.epoch_finished


class SeveralIteration(Trigger):
    """Fires every N iterations (reference: trigger.py:59).

    Implemented as an interval-bucket edge detector rather than a bare
    ``iteration % N == 0`` so it still fires when the trainer checks the
    trigger every k steps (the scan-fused dispatch loop advances iteration
    in groups): any check that crosses one or more N-boundaries fires once.
    """

    def __init__(self, interval: int):
        self.interval = int(interval)
        self._last_bucket = 0

    def arm(self, state):
        """Sync to the run's starting iteration (the trainer calls this at
        fit() start): a fresh trigger on a resumed run must not fire
        mid-interval, and a reused trigger on a fresh run must not stay
        dark until its old mark."""
        self._last_bucket = state.iteration // self.interval

    def fuse_cap(self):
        return self.interval

    def __call__(self, state):
        bucket = state.iteration // self.interval
        if bucket < self._last_bucket:
            # iteration went backwards without re-arming (restore rewound
            # the counter) — resync so the trigger keeps firing
            self._last_bucket = bucket
        if state.iteration > 0 and bucket > self._last_bucket:
            self._last_bucket = bucket
            return True
        return False


class MaxEpoch(Trigger):
    """End-trigger: true once `max` epochs completed (reference:
    util/triggers.py MaxEpoch)."""

    def __init__(self, max: int):
        self.max = int(max)

    def __call__(self, state):
        return state.epoch >= self.max


class MaxIteration(Trigger):
    def __init__(self, max: int):
        self.max = int(max)

    def __call__(self, state):
        return state.iteration >= self.max


class MaxScore(Trigger):
    def __init__(self, max: float):
        self.max = float(max)

    def __call__(self, state):
        return state.score is not None and state.score > self.max


class MinLoss(Trigger):
    def __init__(self, min: float):
        self.min = float(min)

    def __call__(self, state):
        return state.loss is not None and state.loss < self.min


class _Composite(Trigger):
    """Shared arm/fuse_cap forwarding for TriggerAnd/TriggerOr.

    Note on stateful children: SeveralIteration's bucket edge-detector
    consumes its interval edge when ITS __call__ fires, even if the
    composite as a whole evaluates false (e.g. TriggerAnd with a MinLoss
    that is not yet met) — the composite then won't fire again until the
    next interval boundary. This matches the reference's exact-step
    semantics (both conditions must hold at the boundary check)."""

    def __init__(self, first: Trigger, *others: Trigger):
        self.triggers = (first,) + others

    def arm(self, state):
        for t in self.triggers:
            t.arm(state)

    def fuse_cap(self):
        caps = [c for c in (t.fuse_cap() for t in self.triggers)
                if c is not None]
        return min(caps) if caps else None


class TriggerAnd(_Composite):
    def __call__(self, state):
        return all(t(state) for t in self.triggers)


class TriggerOr(_Composite):
    def __call__(self, state):
        return any(t(state) for t in self.triggers)
