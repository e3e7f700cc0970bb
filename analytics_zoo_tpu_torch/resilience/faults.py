"""Deterministic, seedable fault injection for the whole stack.

At pod scale device loss, wedged collectives and broker drops are the
steady state — recovery code that only runs in production incidents is
untested code. This registry lets tests, the chaos CI gate and
``bench.py --only resilience`` arm *named fault sites* that the hot paths
already carry as zero-cost-when-disabled hooks:

==================  ========================================================
site                where it fires
==================  ========================================================
``h2d.put``         ``native/transfer.py`` — every host→device placement
``engine.dispatch`` ``orca/learn/engine.py`` — every train-step dispatch
``ckpt.blob_io``    ``ckpt/store.py`` — every checkpoint blob write
``serving.decode``  ``serving/engine.py`` — every serving batch decode
``broker.connect``  ``serving/redis_protocol.py`` — every broker (re)connect
==================  ========================================================

Arming is either programmatic (the :func:`inject` context manager, used by
the chaos tests) or via ``ZOO_FAULTS`` for whole-process runs::

    ZOO_FAULTS="engine.dispatch:p=1.0,count=1,skip=3"          # one-shot
    ZOO_FAULTS="h2d.put:p=0.05;broker.connect:count=2,kind=connection"

Per-site spec keys: ``p`` (fire probability, default 1.0), ``count`` (max
fires, default unlimited), ``skip`` (eligible calls to let pass first —
"fault at step k"), ``mode`` (``raise`` | ``delay``: a delay models a hang
for the watchdog instead of a crash), ``delay`` (seconds, delay mode),
``kind`` (``runtime`` | ``connection``: which exception class fires).
Draws come from one ``random.Random`` per site seeded with
``(ZOO_FAULT_SEED, site)``, so a fixed seed replays the exact fire pattern
regardless of which other sites run in the process.

The hook the production code calls is :func:`fire` — a module-global
``None`` check when nothing is armed, so the disabled cost is one load +
compare (gated unmeasurable in ``bench_infeed``, ±2%).
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional

from .stats import STATS

logger = logging.getLogger("analytics_zoo_tpu_torch")

__all__ = ["InjectedFault", "InjectedConnectionFault", "FaultRegistry",
           "fire", "enabled", "activate", "deactivate", "inject",
           "registry_from_env", "KNOWN_SITES"]

#: the sites threaded into the stack (arming others is allowed — custom
#: code can add its own fire() calls — but gets a log warning)
KNOWN_SITES = ("h2d.put", "engine.dispatch", "ckpt.blob_io",
               "serving.decode", "broker.connect")


class InjectedFault(RuntimeError):
    """Raised by an armed fault site (``kind=runtime``, the default)."""


class InjectedConnectionFault(InjectedFault, ConnectionError):
    """``kind=connection`` — lands in the brokers' reconnect/retry
    classification like a real dropped socket."""


class _FaultSpec:
    __slots__ = ("site", "prob", "count", "skip", "mode", "delay_s", "kind",
                 "rng", "fired", "calls")

    def __init__(self, site: str, prob: float, count: Optional[int],
                 skip: int, mode: str, delay_s: float, kind: str, seed: int):
        if mode not in ("raise", "delay"):
            raise ValueError(f"fault mode must be raise|delay, got {mode!r}")
        if kind not in ("runtime", "connection"):
            raise ValueError(f"fault kind must be runtime|connection, "
                             f"got {kind!r}")
        self.site = site
        self.prob = float(prob)
        self.count = count
        self.skip = int(skip)
        self.mode = mode
        self.delay_s = float(delay_s)
        self.kind = kind
        # per-site stream: the fire pattern under a fixed seed depends only
        # on this site's own call sequence, never on interleaving with
        # other sites
        self.rng = random.Random(f"{seed}:{site}")
        self.fired = 0
        self.calls = 0


class FaultRegistry:
    """Armed fault specs + deterministic draw state. One registry is
    *active* process-wide at a time (:func:`activate`); the production
    hooks consult it through :func:`fire`."""

    def __init__(self, seed: Optional[int] = None):
        self.seed = (int(os.environ.get("ZOO_FAULT_SEED", "0"))
                     if seed is None else int(seed))
        self._lock = threading.Lock()
        self._specs: Dict[str, _FaultSpec] = {}

    def arm(self, site: str, prob: float = 1.0,
            count: Optional[int] = None, skip: int = 0,
            mode: str = "raise", delay_s: float = 0.5,
            kind: str = "runtime") -> "FaultRegistry":
        if site not in KNOWN_SITES:
            logger.warning("arming fault site %r not threaded into the "
                           "stack (known: %s)", site, ", ".join(KNOWN_SITES))
        with self._lock:
            self._specs[site] = _FaultSpec(site, prob, count, skip, mode,
                                           delay_s, kind, self.seed)
        return self

    def disarm(self, site: Optional[str] = None):
        with self._lock:
            if site is None:
                self._specs.clear()
            else:
                self._specs.pop(site, None)

    def fire(self, site: str):
        with self._lock:
            spec = self._specs.get(site)
            if spec is None:
                return
            spec.calls += 1
            if spec.count is not None and spec.fired >= spec.count:
                return
            if spec.calls <= spec.skip:
                return
            if spec.prob < 1.0 and spec.rng.random() >= spec.prob:
                return
            spec.fired += 1
            mode, delay_s, kind = spec.mode, spec.delay_s, spec.kind
            n = spec.fired
        STATS.add(f"fault.{site}")
        if mode == "delay":
            logger.warning("fault injection: site %s stalling %.2fs "
                           "(fire %d)", site, delay_s, n)
            time.sleep(delay_s)
            return
        exc = (InjectedConnectionFault if kind == "connection"
               else InjectedFault)
        logger.warning("fault injection: site %s raising %s (fire %d)",
                       site, exc.__name__, n)
        raise exc(f"injected fault at {site} (fire {n})")

    def snapshot(self) -> Dict[str, Dict]:
        with self._lock:
            return {s.site: {"fired": s.fired, "calls": s.calls,
                             "prob": s.prob, "mode": s.mode}
                    for s in self._specs.values()}


# --- the hook the production code calls -------------------------------------

_active: Optional[FaultRegistry] = None


def fire(site: str) -> None:
    """Zero-cost-when-disabled fault hook: one global load + compare."""
    reg = _active
    if reg is not None:
        reg.fire(site)


def enabled() -> bool:
    return _active is not None


def activate(registry: FaultRegistry) -> FaultRegistry:
    global _active
    _active = registry
    return registry


def deactivate():
    global _active
    _active = None


@contextmanager
def inject(site: Optional[str] = None, *, seed: Optional[int] = None,
           registry: Optional[FaultRegistry] = None, **spec):
    """Arm faults for a scope::

        with faults.inject("engine.dispatch", count=1, skip=3):
            supervisor.fit(...)

    With ``site=None`` an empty (or caller-built) registry activates —
    arm sites on the yielded registry. The previously active registry is
    restored on exit, so scopes nest."""
    global _active
    reg = registry if registry is not None else FaultRegistry(seed=seed)
    if site is not None:
        reg.arm(site, **spec)
    prev, _active = _active, reg
    try:
        yield reg
    finally:
        _active = prev


# --- env arming -------------------------------------------------------------

def registry_from_env(spec: Optional[str] = None,
                      seed: Optional[int] = None
                      ) -> Optional[FaultRegistry]:
    """Parse a ``ZOO_FAULTS`` spec string into a registry (None when
    empty). Format: ``site:k=v,k=v;site2:...``; bare ``site`` arms an
    always-fire raise."""
    spec = os.environ.get("ZOO_FAULTS", "") if spec is None else spec
    spec = spec.strip()
    if not spec:
        return None
    reg = FaultRegistry(seed=seed)
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        site, _, kvs = part.partition(":")
        kw: Dict = {}
        for kv in filter(None, (s.strip() for s in kvs.split(","))):
            k, _, v = kv.partition("=")
            if k == "p":
                kw["prob"] = float(v)
            elif k == "count":
                kw["count"] = int(v)
            elif k == "skip":
                kw["skip"] = int(v)
            elif k == "mode":
                kw["mode"] = v
            elif k == "delay":
                kw["delay_s"] = float(v)
            elif k == "kind":
                kw["kind"] = v
            else:
                raise ValueError(f"unknown ZOO_FAULTS key {k!r} in {part!r}")
        reg.arm(site.strip(), **kw)
    return reg


# whole-process chaos runs (the CI gate, operator drills) arm at import:
# the hooks are live from the first device_put on
_env_registry = registry_from_env()
if _env_registry is not None:
    activate(_env_registry)
