"""Device leasing for AutoML trials (counterpart of
``analytics_zoo_tpu/automl/scheduler/lease.py``).

``DeviceLeaseManager`` holds the local device inventory, hands out at most
one lease per device, and blocks further acquires until a lease is
returned. The JAX lease carries a single-chip ``Mesh``; here a lease's
``device`` is the torch device the trial trains on (one lease per CUDA
device, or the one CPU device). The default inventory is the context's
local devices (``common/context.py``).

Telemetry is the JAX package's: per-device busy seconds and lease counts
(``utilization()``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, Optional

import torch

__all__ = ["DeviceLease", "DeviceLeaseManager", "LeaseTimeout",
           "current_device"]


class LeaseTimeout(RuntimeError):
    """No device became free within the acquire timeout."""


class DeviceLease:
    """One device, exclusively held. Context manager; releases on exit."""

    def __init__(self, manager: "DeviceLeaseManager", device, index: int,
                 owner: Any):
        self._manager = manager
        self.device = device
        self.index = index
        self.owner = owner
        self.acquired_at = time.perf_counter()
        self._released = False

    def release(self):
        self._manager.release(self)

    def __enter__(self) -> "DeviceLease":
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return (f"DeviceLease(index={self.index}, owner={self.owner!r}, "
                f"device={self.device})")


class DeviceLeaseManager:
    """Thread-safe exclusive allocator over the local device inventory."""

    def __init__(self, devices: Optional[List] = None):
        if devices is None:
            from ...common.context import get_context
            devices = get_context().local_devices
        if not devices:
            raise ValueError("DeviceLeaseManager needs at least one device")
        self._devices = list(devices)
        self._cond = threading.Condition()
        self._free = list(range(len(self._devices)))
        self._held: Dict[int, DeviceLease] = {}
        self._busy_s = [0.0] * len(self._devices)
        self._lease_counts = [0] * len(self._devices)
        self._created_at = time.perf_counter()

    def __len__(self):
        return len(self._devices)

    @property
    def devices(self) -> List:
        return list(self._devices)

    def acquire(self, owner: Any = None,
                timeout: Optional[float] = None) -> DeviceLease:
        """Block until a device is free, then lease it exclusively."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._cond:
            while not self._free:
                remaining = (None if deadline is None
                             else deadline - time.perf_counter())
                if remaining is not None and remaining <= 0:
                    raise LeaseTimeout(
                        f"no device free within {timeout:.1f}s "
                        f"({len(self._held)} leases outstanding)")
                self._cond.wait(remaining)
            idx = self._free.pop()
            lease = DeviceLease(self, self._devices[idx], idx, owner)
            self._held[idx] = lease
            self._lease_counts[idx] += 1
            return lease

    def release(self, lease: DeviceLease):
        with self._cond:
            if lease._released:
                return
            held = self._held.get(lease.index)
            if held is not lease:
                raise RuntimeError(
                    f"lease for device {lease.index} is not outstanding "
                    "(double release or foreign lease)")
            lease._released = True
            del self._held[lease.index]
            self._busy_s[lease.index] += (time.perf_counter()
                                          - lease.acquired_at)
            self._free.append(lease.index)
            self._cond.notify()

    def outstanding(self) -> List[DeviceLease]:
        with self._cond:
            return list(self._held.values())

    def utilization(self) -> Dict[str, Any]:
        """Per-device busy time since the manager was created."""
        with self._cond:
            now = time.perf_counter()
            wall = max(now - self._created_at, 1e-9)
            busy = list(self._busy_s)
            for idx, lease in self._held.items():
                busy[idx] += now - lease.acquired_at
            return {
                "wall_s": round(wall, 3),
                "chips": len(self._devices),
                "busy_s": [round(b, 3) for b in busy],
                "leases": list(self._lease_counts),
                "utilization": round(sum(busy) / (wall * len(self._devices)),
                                     4),
            }


def current_device(device):
    """``device`` as the current CUDA device for a trial's thread (nothing
    for a CPU or stand-in device)."""
    if isinstance(device, torch.device) and device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
