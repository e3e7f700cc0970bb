"""Trial scheduling for AutoML: device leases. The ASHA ``TrialRuntime``
(rungs, pause/resume, retries, events) is not ported yet (ROADMAP A5)."""

from .lease import DeviceLease, DeviceLeaseManager, LeaseTimeout

__all__ = ["DeviceLease", "DeviceLeaseManager", "LeaseTimeout"]
