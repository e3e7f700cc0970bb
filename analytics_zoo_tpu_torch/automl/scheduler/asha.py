"""Asynchronous successive halving (ASHA) rung bookkeeping (a copy of
``analytics_zoo_tpu/automl/scheduler/asha.py``).

Pure decision logic, no execution: ``TrialRuntime`` owns threads and
chips, ``AshaBracket`` owns the rung ledger. Rungs are cumulative epoch
budgets ``grace_period * eta**k`` capped at ``max_t`` (e.g. max_t=9,
grace=1, eta=3 -> [1, 3, 9]); a trial reporting a score at rung k is
**promoted** when it sits in the top ``floor(n_k / eta)`` of everything
recorded at that rung so far, else **paused**. Because the rule is
re-evaluated as more trials report (``promotable()``), a trial paused
early can be promoted late — the runtime resumes it from its checkpoint
instead of retraining (the async rule from Li et al., "A System for
Massively Parallel Hyperparameter Tuning", arXiv:1810.05934, without the
synchronized rung barrier of classic successive halving).

All methods are lock-guarded: worker threads report concurrently.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["AshaBracket", "asha_rungs"]


def asha_rungs(max_t: int, eta: int = 3, grace_period: int = 1) -> List[int]:
    """Cumulative epoch budgets per rung; the last rung is always max_t."""
    if max_t < 1:
        raise ValueError(f"max_t must be >= 1, got {max_t}")
    if eta < 2:
        raise ValueError(f"eta must be >= 2, got {eta}")
    grace_period = max(1, min(int(grace_period), max_t))
    rungs, budget = [], grace_period
    while budget < max_t:
        rungs.append(budget)
        budget *= eta
    rungs.append(max_t)
    return rungs


class AshaBracket:
    def __init__(self, max_t: int, eta: int = 3, grace_period: int = 1,
                 metric_mode: str = "min"):
        assert metric_mode in ("min", "max")
        self.max_t = int(max_t)
        self.eta = int(eta)
        self.metric_mode = metric_mode
        self.rungs = asha_rungs(max_t, eta, grace_period)
        self._lock = threading.Lock()
        # per rung: trial_id -> score (as reported)
        self._recorded: List[Dict[Any, float]] = [dict() for _ in self.rungs]
        # trials already promoted OUT of a rung (running or finished there)
        self._promoted: List[set] = [set() for _ in self.rungs]
        self._retired: set = set()       # errored/abandoned: never promote
        self.promotions = 0
        self.pauses = 0

    # --- geometry -----------------------------------------------------------
    @property
    def n_rungs(self) -> int:
        return len(self.rungs)

    def rung_of(self, epochs_done: int) -> int:
        """Index of the highest rung whose budget <= epochs_done (-1: none)."""
        r = -1
        for i, b in enumerate(self.rungs):
            if epochs_done >= b:
                r = i
        return r

    def next_boundary(self, epochs_done: int) -> Optional[int]:
        for b in self.rungs:
            if b > epochs_done:
                return b
        return None

    def _better(self, a: float, b: float) -> bool:
        return a < b if self.metric_mode == "min" else a > b

    def _top_k_ids(self, rung: int) -> List[Any]:
        rec = self._recorded[rung]
        k = math.floor(len(rec) / self.eta)
        if k <= 0:
            return []
        order = sorted(rec.items(), key=lambda kv: kv[1],
                       reverse=self.metric_mode == "max")
        return [tid for tid, _ in order[:k]]

    # --- reporting ----------------------------------------------------------
    def report(self, trial_id: Any, rung: int, score: float) -> str:
        """Record a score at a rung and decide this trial's fate now.

        Returns ``"stop"`` (final rung reached), ``"promote"`` (keep
        training toward the next rung) or ``"pause"`` (checkpoint and
        yield the chip; may be resumed later via ``promotable()``).
        """
        with self._lock:
            self._recorded[rung][trial_id] = float(score)
            if rung == self.n_rungs - 1:
                return "stop"
            if trial_id in self._top_k_ids(rung):
                self._promoted[rung].add(trial_id)
                self.promotions += 1
                return "promote"
            self.pauses += 1
            return "pause"

    def promotable(self, eligible=None) -> Optional[Tuple[Any, int]]:
        """Latest-possible promotion: deepest rung first, the best paused
        trial that has entered the top 1/eta since it was paused. Marks it
        promoted; the caller must actually resume it.

        ``eligible`` (optional set): only consider these trial ids. The
        runtime passes the trials whose pause outcome has been fully
        processed — the ledger records a pause at report() time, before the
        pausing slice has released its chip or persisted its checkpoint, so
        promoting on ledger state alone could double-run a trial."""
        with self._lock:
            for rung in range(self.n_rungs - 2, -1, -1):
                for tid in self._top_k_ids(rung):
                    if tid in self._promoted[rung] or tid in self._retired:
                        continue
                    if eligible is not None and tid not in eligible:
                        continue
                    self._promoted[rung].add(tid)
                    self.promotions += 1
                    return tid, rung
            return None

    def force_promote(self, trial_id: Any, rung: int):
        """Promote outside the 1/eta rule (small-study guard: with fewer
        than ``eta`` trials recorded at a rung nothing ever qualifies).
        Idempotent; the caller resumes the trial."""
        with self._lock:
            if 0 <= rung < self.n_rungs - 1 and \
                    trial_id not in self._promoted[rung]:
                self._promoted[rung].add(trial_id)
                self.promotions += 1

    def retire(self, trial_id: Any):
        """Take a trial out of promotion consideration (errored/abandoned)."""
        with self._lock:
            self._retired.add(trial_id)

    def adopt(self, trial_id: Any, rung_scores: Dict[int, float],
              promoted_through: int = -1):
        """Rebuild ledger state from a study manifest (resume path)."""
        with self._lock:
            for rung, score in rung_scores.items():
                rung = int(rung)
                if 0 <= rung < self.n_rungs:
                    self._recorded[rung][trial_id] = float(score)
            for rung in range(min(promoted_through + 1, self.n_rungs - 1)):
                self._promoted[rung].add(trial_id)

    # --- telemetry ----------------------------------------------------------
    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            out = []
            for i, budget in enumerate(self.rungs):
                rec = self._recorded[i]
                best = None
                if rec:
                    pick = min if self.metric_mode == "min" else max
                    best = pick(rec.values())
                out.append({"rung": i, "budget_epochs": budget,
                            "reported": len(rec),
                            "promoted": len(self._promoted[i]),
                            "best_score": best})
            return out
