"""Pump-vs-direct infeed crossover simulation (counterpart of
``analytics_zoo_tpu/native/infeed_sim.py``).

The device's copy is modelled as a GIL-releasing sleep of ``nbytes /
bandwidth + latency`` (how a DMA behaves from the host thread's side) and
the train step as a GIL-releasing sleep of the compute time (a CUDA
launch returns at once and the host waits on the card the same way). The
pumped path runs the port's real :class:`InfeedPump` (assembly workers,
transfer lane, in-order delivery); the direct path calls the same fake
copy inline.

With a DMA-class link the pumped steady-state step collapses to about
max(compute, transfer) while the direct one stays at compute + transfer;
at a slow link both are transfer-bound and overlap cannot help.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from .infeed import InfeedPump


def _busy_free_sleep(seconds: float):
    # time.sleep releases the GIL: the same overlap as a DMA transfer or a
    # kernel awaited from another thread
    if seconds > 0:
        time.sleep(seconds)


class FakeDevice:
    """Models host->device transfer at ``bandwidth_gbps`` (decimal GB/s)
    with a fixed per-call ``latency_s``, and a compute step of
    ``step_time_s``."""

    def __init__(self, bandwidth_gbps: float, step_time_s: float,
                 latency_s: float = 200e-6):
        self.bandwidth = bandwidth_gbps * 1e9
        self.latency = latency_s
        self.step_time = step_time_s

    def device_put(self, batch) -> object:
        if isinstance(batch, np.ndarray):
            nbytes = batch.nbytes
        else:
            nbytes = sum(a.nbytes for a in batch)
        _busy_free_sleep(self.latency + nbytes / self.bandwidth)
        return batch

    def train_step(self, dev_batch):
        _busy_free_sleep(self.step_time)


def measure(device: FakeDevice, batches: List, steps: int,
            use_pump: bool) -> float:
    """Steady-state seconds/step over ``steps`` batches."""
    def factory():
        for i in range(steps):
            # the port's pump takes zero-arg assembly tasks
            yield lambda b=batches[i % len(batches)]: b

    t0 = time.perf_counter()
    if use_pump:
        # one lane: the FakeDevice models ONE DMA link as a sleep, so
        # concurrent lane sleeps would simulate a doubled link, not
        # overlapped transfers on the same link
        for dev_batch in InfeedPump(factory, device_put=device.device_put,
                                    max_lanes=1):
            device.train_step(dev_batch)
    else:
        for task in factory():
            device.train_step(device.device_put(task()))
    return (time.perf_counter() - t0) / steps


def simulate_crossover(batch_mb: float = 38.5, step_time_ms: float = 100.0,
                       bandwidths_gbps=(0.01, 0.05, 0.25, 1.0, 4.0, 16.0),
                       steps: int = 30) -> Dict[float, Dict[str, float]]:
    """Sweep bandwidths; returns per-bandwidth direct/pumped seconds/step
    plus the ideal overlap bound max(compute, transfer)."""
    n = int(batch_mb * 1e6)
    batches = [np.zeros(n, np.uint8) for _ in range(3)]
    out = {}
    for bw in bandwidths_gbps:
        dev = FakeDevice(bw, step_time_ms / 1e3)
        transfer = n / (bw * 1e9)
        direct = measure(dev, batches, steps, use_pump=False)
        pumped = measure(dev, batches, steps, use_pump=True)
        out[bw] = {
            "transfer_s": transfer,
            "direct_s_per_step": direct,
            "pumped_s_per_step": pumped,
            "ideal_overlap_s": max(step_time_ms / 1e3, transfer),
            "pump_speedup": direct / pumped,
        }
    return out
