"""Online-eval guardrail — the adoption gate in front of hot reload
(counterpart of ``analytics_zoo_tpu/streaming/guardrail.py``).

At fleet scale a bad window (poisoned labels, a cohort drifting into
garbage, a partition replaying shed data) produces a *committed*
checkpoint like any good window does; without a gate the reloader would
swap it into live traffic within one poll. The guardrail scores every
commit on a **sliding holdout window** of recent labeled records before
serving adopts it, and rejects adoption on regression through the
watcher's rejected-step path: the :class:`~analytics_zoo_tpu_torch.ckpt.
watch.CheckpointWatcher` treats a callback raise as "skip this step forever",
so a rejected commit can never reach live traffic — while the trainer
keeps going, and the NEXT commit is judged on its own merits
(reject-then-later-accept is the expected recovery shape).

Verdict semantics (:meth:`GuardrailEvaluator.verdict` — a pure function
of the score trace, unit-testable without a model):

* ``accept``  — score within ``regression`` of the baseline (the best
  score among the last ``baseline_window`` *accepted* commits; rejected
  scores never pollute the baseline, or one bad window would ratchet
  the bar down and auto-accept its successors);
* ``reject``  — score worse than ``baseline * (1 + regression)``
  (scores are losses: lower is better);
* ``insufficient`` — fewer than ``min_holdout`` holdout records exist;
  the commit is adopted (blocking serving on a cold holdout would stall
  bootstrap) but counted, so operators see how often the gate was open.

The holdout itself is fed by :meth:`observe` (typically a tap on the
producer or a dedicated eval stream) and scored by a pluggable
``scorer`` — :func:`module_loss_scorer` builds one from a torch module,
evaluating the *candidate* checkpoint's params without touching the
live model's weights.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..common import knobs as _knobs
from .stats import StreamingStats

__all__ = ["ACCEPT", "REJECT", "INSUFFICIENT", "GuardrailRejected",
           "GuardrailEvaluator", "module_loss_scorer"]

ACCEPT = "accept"
REJECT = "reject"
INSUFFICIENT = "insufficient"


class GuardrailRejected(RuntimeError):
    """Raised by the reloader callback on a ``reject`` verdict — the
    CheckpointWatcher's rejected-step path turns it into a permanent
    skip of that step."""


def _state_dict(state):
    """A candidate checkpoint's parameters as a ``state_dict``: the port's
    states hold one; a state the JAX package wrote (flax trees) converts
    through ``interop``."""
    params = state["params"]
    if all(not isinstance(v, dict) for v in params.values()):
        return params
    from .. import interop
    variables = {"params": params}
    stats = (state.get("extra_vars") or {}).get("batch_stats")
    if stats:
        variables["batch_stats"] = stats
    return interop.flax_to_state_dict(variables)


def module_loss_scorer(module, loss: str = "mse") -> Callable:
    """A scorer evaluating ``module`` (a torch ``nn.Module``) under a
    candidate checkpoint's params on the holdout batch: a plain forward
    without gradients, in evaluation mode, on the device of the module's
    parameters, with the candidate's tensors in place of the module's
    for the call (``torch.func.functional_call``), so the module's own
    weights are never written. Give it a module no other thread runs
    (not the trainer's, not the served one): the call swaps the tensors
    in and out. Nothing is captured, so the zero-recompile gates count
    nothing."""
    if loss != "mse":
        raise ValueError(f"module_loss_scorer supports mse, got {loss!r}")

    def score(state, xs, ys) -> float:
        ref = next(iter(module.parameters()), None)
        device = ref.device if ref is not None else torch.device("cpu")
        params = {k: torch.from_numpy(np.array(v)).to(device)
                  for k, v in _state_dict(state).items()}
        args = tuple(torch.from_numpy(np.array(a)).to(device) for a in xs)
        was_training = module.training
        module.eval()
        try:
            with torch.no_grad():
                pred = torch.func.functional_call(module, params, args)
        finally:
            module.train(was_training)
        return float(np.mean((pred.cpu().numpy() - np.asarray(ys[0])) ** 2))

    return score


class GuardrailEvaluator:
    """Score-every-commit gate with a sliding holdout window.

    ``scorer(state, xs, ys) -> float`` gets the candidate checkpoint's
    state and the stacked holdout columns; lower is better (a loss).
    Thread-safe: the producer tap (:meth:`observe`) and the watcher
    thread (:meth:`evaluate`) run concurrently.
    """

    def __init__(self, scorer: Optional[Callable] = None, *,
                 holdout_records: Optional[int] = None,
                 min_holdout: Optional[int] = None,
                 regression: Optional[float] = None,
                 baseline_window: Optional[int] = None,
                 stats: Optional[StreamingStats] = None):
        self.scorer = scorer
        self.holdout_records = int(
            holdout_records if holdout_records is not None
            else _knobs.get("ZOO_STREAM_GUARD_HOLDOUT"))
        self.min_holdout = int(
            min_holdout if min_holdout is not None
            else _knobs.get("ZOO_STREAM_GUARD_MIN_HOLDOUT"))
        self.regression = float(
            regression if regression is not None
            else _knobs.get("ZOO_STREAM_GUARD_REGRESSION"))
        self.baseline_window = int(
            baseline_window if baseline_window is not None
            else _knobs.get("ZOO_STREAM_GUARD_BASELINE_WINDOW"))
        if self.holdout_records < 1 or self.min_holdout < 1 \
                or self.baseline_window < 1:
            raise ValueError(
                "guardrail sizes (holdout_records, min_holdout, "
                "baseline_window) must all be >= 1")
        self.stats = stats if stats is not None else StreamingStats(
            register=False)
        self._lock = threading.Lock()
        self._holdout: deque = deque(maxlen=self.holdout_records)
        self._accepted: deque = deque(maxlen=self.baseline_window)
        self.last_score: Optional[float] = None
        self.last_verdict: Optional[str] = None

    # --- holdout feed -------------------------------------------------------
    def observe(self, x, y) -> None:
        """Add one labeled holdout example (per-example shapes, like
        ``encode_record``); the deque slides, keeping the newest
        ``holdout_records`` — the gate judges against *recent* truth, not
        the whole history."""
        xs = x if isinstance(x, tuple) else (x,)
        ys = y if isinstance(y, tuple) else (y,)
        with self._lock:
            self._holdout.append((tuple(np.asarray(a) for a in xs),
                                  tuple(np.asarray(a) for a in ys)))

    def observe_record(self, raw: bytes) -> None:
        """Tap an encoded stream record into the holdout (labelless
        records are ignored — there is nothing to score against)."""
        from .records import decode_record
        xs, ys, _ = decode_record(raw)
        if ys is not None:
            # copy out of the zero-copy views: the holdout outlives raw
            self.observe(tuple(np.array(a) for a in xs),
                         tuple(np.array(a) for a in ys))

    @property
    def holdout_size(self) -> int:
        with self._lock:
            return len(self._holdout)

    def _stacked(self) -> Optional[Tuple[tuple, tuple]]:
        with self._lock:
            if not self._holdout:
                return None
            recs = list(self._holdout)
        nx, ny = len(recs[0][0]), len(recs[0][1])
        xs = tuple(np.stack([r[0][i] for r in recs]) for i in range(nx))
        ys = tuple(np.stack([r[1][i] for r in recs]) for i in range(ny))
        return xs, ys

    # --- the decision -------------------------------------------------------
    def baseline(self) -> Optional[float]:
        """Best (lowest) score among recently accepted commits, None
        before the first accept."""
        with self._lock:
            return min(self._accepted) if self._accepted else None

    def verdict(self, score: float,
                holdout_n: Optional[int] = None) -> str:
        """Judge one commit score. Pure given (score trace, holdout
        size) — the unit tests drive this directly with synthetic
        traces. Counts the outcome on :attr:`stats`."""
        n = self.holdout_size if holdout_n is None else int(holdout_n)
        if n < self.min_holdout:
            self.stats.add(guard_insufficient=1)
            self.last_verdict = INSUFFICIENT
            return INSUFFICIENT
        with self._lock:
            base = min(self._accepted) if self._accepted else None
            if base is not None and score > base * (1.0 + self.regression):
                out = REJECT
            else:
                out = ACCEPT
                self._accepted.append(float(score))
        if out is REJECT:
            self.stats.add(guard_rejected=1)
        else:
            self.stats.add(guard_accepted=1)
        self.last_verdict = out
        return out

    def evaluate(self, state, step: int
                 ) -> Tuple[str, Optional[float]]:
        """Score a candidate checkpoint ``state`` on the current holdout
        and judge it: ``(verdict, score)``. Needs a ``scorer``; without
        holdout data the verdict is ``insufficient`` (adopt + count)."""
        if self.scorer is None:
            raise ValueError("GuardrailEvaluator.evaluate needs a scorer "
                             "(see module_loss_scorer)")
        stacked = self._stacked()
        if stacked is None or self.holdout_size < self.min_holdout:
            self.stats.add(guard_insufficient=1)
            self.last_verdict = INSUFFICIENT
            self.last_score = None
            return INSUFFICIENT, None
        score = float(self.scorer(state, *stacked))
        self.last_score = score
        return self.verdict(score), score
