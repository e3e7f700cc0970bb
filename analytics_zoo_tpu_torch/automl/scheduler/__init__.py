"""Trial-execution runtime for AutoML (counterpart of
``analytics_zoo_tpu/automl/scheduler``): device leasing, asynchronous
successive halving (ASHA) with checkpoint pause/resume, retry-with-backoff
fault tolerance, SIGTERM study preemption and JSONL telemetry.

Wired in behind ``TPUSearchEngine(scheduler="asha")`` /
``AutoEstimator.fit(scheduler="asha")`` / ``AutoTSTrainer(scheduler=
"asha")``.
"""

from .asha import AshaBracket, asha_rungs
from .events import EventLog
from .lease import DeviceLease, DeviceLeaseManager, LeaseTimeout
from .runtime import (TrialContext, TrialPaused, TrialPreempted,
                      TrialRuntime)

__all__ = ["AshaBracket", "asha_rungs", "EventLog", "DeviceLease",
           "DeviceLeaseManager", "LeaseTimeout", "TrialContext",
           "TrialPaused", "TrialPreempted", "TrialRuntime"]
