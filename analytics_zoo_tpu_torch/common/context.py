"""Cluster context (counterpart of ``analytics_zoo_tpu/common/context.py``).

The JAX package bootstraps ``jax.distributed`` and a device mesh. On one
card the port needs neither: the context holds the list of torch devices
this process computes on, the config, and the process topology (one
process). ``init_orca_context``, ``get_context`` and ``stop_orca_context``
keep their names and their singleton behaviour.

Device rule: the context is on ``cuda`` unless the caller asks for
``device="cpu"``. With no GPU and no explicit CPU request it raises; it
never carries on quietly on the CPU.
"""

from __future__ import annotations

import atexit
import logging
import threading
from typing import List, Optional, Union

import torch

from .config import OrcaConfig

logger = logging.getLogger("analytics_zoo_tpu_torch")

_lock = threading.Lock()
_current: Optional["ClusterContext"] = None


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """``None`` means the card. A CUDA device that is not there raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    return dev


def local_devices(device: Union[None, str, torch.device] = None
                  ) -> List[torch.device]:
    """The devices of ``device``'s type that this process computes on:
    every visible card for ``cuda`` (the one named for ``cuda:i``), the CPU
    for ``cpu``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


class ClusterContext:
    """Holds the config and the torch devices of this (single) process."""

    def __init__(self, config: OrcaConfig, devices: List[torch.device]):
        self.config = config
        self.devices = list(devices)
        self._stopped = False

    @property
    def num_devices(self) -> int:
        return len(self.devices)

    @property
    def num_processes(self) -> int:
        return 1

    @property
    def process_id(self) -> int:
        return 0

    @property
    def local_devices(self):
        return list(self.devices)

    def is_coordinator(self) -> bool:
        return self.process_id == 0

    def stop(self):
        self._stopped = True

    def __repr__(self):
        return (f"ClusterContext(mode={self.config.cluster_mode}, "
                f"devices={[str(d) for d in self.devices]})")


def _setup_logging(level: str):
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s: %(message)s"))
        logger.addHandler(h)
    logger.setLevel(level.upper())


def init_orca_context(cluster_mode: str = "local",
                      device: Union[None, str, torch.device] = None,
                      cores: int | str = "*",
                      memory: str = "2g",
                      num_nodes: int = 1,
                      config: Optional[OrcaConfig] = None,
                      **extra) -> ClusterContext:
    """Bootstrap the context. ``cluster_mode="local"`` is the one mode of
    this slice: one process and the local devices of ``device``'s type
    (every visible card for ``cuda``, one CPU device for ``cpu``).
    ``cores``/``memory``/``num_nodes`` are accepted for source
    compatibility and allocate nothing."""
    global _current
    if cluster_mode != "local":
        raise NotImplementedError(
            f"cluster_mode={cluster_mode!r} is not ported yet (local only)")
    with _lock:
        if _current is not None and not _current._stopped:
            logger.warning("init_orca_context called twice; returning "
                           "existing context (call stop_orca_context first "
                           "to rebuild)")
            return _current
        devices = local_devices(device)
        cfg = (config or OrcaConfig()).replace(cluster_mode=cluster_mode)
        cfg.extra.update(extra)
        _setup_logging(cfg.log_level)
        ctx = ClusterContext(cfg, devices)
        _current = ctx
        atexit.register(stop_orca_context)
        logger.info("initialized %r", ctx)
        return ctx


def current_context() -> Optional[ClusterContext]:
    """The active context, or None (never creates one)."""
    if _current is None or _current._stopped:
        return None
    return _current


def get_context() -> ClusterContext:
    """Return the active context, creating a local one on demand."""
    if _current is None or _current._stopped:
        return init_orca_context("local")
    return _current


def stop_orca_context():
    global _current
    with _lock:
        if _current is not None:
            _current.stop()
            _current = None
