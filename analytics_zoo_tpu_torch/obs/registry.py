"""Unified metrics registry — the one table every plane's counters land in.

Before this plane the stack had six disconnected stats surfaces (the
infeed/engine ``PipelineStats``, ``ckpt/stats.py``, ``resilience/stats.py``,
the compile-plane counters, the serving JSON ``/metrics`` body and
TrialRuntime's event counts) with no shared schema or exposition format.
They all still exist — their dict-returning APIs are unchanged — but every
one of them now registers into the process-wide :data:`REGISTRY`, so one
Prometheus text exposition (``obs/export.py``) and one ``zoo-metrics`` CLI
cover them all.

Two registration styles:

* **native instruments** — :class:`Counter` / :class:`Gauge` /
  :class:`Histogram` families with label sets. The serving counters
  (HTTP 429 rejections, shed requests, breaker trips) and the resilience
  event table moved onto these: their old dict APIs are now *views over
  the registry* (the dict is built by reading the registered children).
* **collector adapters** — a plane that already owns a well-tested
  concurrent counter object (``PipelineStats``, ``CkptStats``,
  ``CompileStats``) registers the *instance* (:meth:`MetricsRegistry.
  register_object`, weakly referenced so dead estimators drop out of the
  exposition) or a zero-arg snapshot callable (:meth:`MetricsRegistry.
  register_collector`). Its numeric snapshot entries are exposed as
  gauges under the registered prefix.

Hot-path cost: incrementing a child takes only that child's dedicated
micro-lock (uncontended unless two threads hit the very same label set) —
never the registry lock, which guards family/child *creation* only. Call
sites cache the child (``self._c = family.labels(...)``) so the hot path
is one locked ``+=``.

Metric naming rules (``docs/observability.md``): ``zoo_<plane>_<what>``,
lowercase ``[a-z0-9_]``, unit suffix when the value has one (``_seconds``,
``_bytes``, ``_total`` for event counts). Names are validated at
registration; the exposition layer additionally sanitizes collector keys.
"""

from __future__ import annotations

import re
import threading
import weakref
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "InstancedEvents",
           "MetricsRegistry", "REGISTRY", "get_registry"]

_NAME_RE = re.compile(r"^[a-z_][a-z0-9_]*$")
_DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                    float("inf"))


def _check_name(name: str):
    if not _NAME_RE.match(name):
        raise ValueError(
            f"metric name {name!r} violates the naming rules "
            f"(lowercase [a-z0-9_], see docs/observability.md)")


def sanitize(key: str) -> str:
    """Best-effort mapping of a snapshot-dict key onto the metric charset
    (collector adapters expose foreign keys like ``h2d_MBps``)."""
    out = re.sub(r"[^a-zA-Z0-9_]", "_", str(key)).lower()
    return out if _NAME_RE.match(out) else "_" + out


class _Value:
    """One (family, label-set) series: a float behind a micro-lock."""

    __slots__ = ("_lock", "_v")

    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0.0

    def inc(self, amount: float = 1.0):
        with self._lock:
            self._v += amount

    def set(self, value: float):
        with self._lock:
            self._v = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._v

    def zero(self):
        with self._lock:
            self._v = 0.0


class _HistValue:
    """One histogram series: cumulative bucket counts + sum + count."""

    __slots__ = ("_lock", "buckets", "counts", "sum", "count")

    def __init__(self, buckets: Tuple[float, ...]):
        self._lock = threading.Lock()
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float):
        with self._lock:
            self.sum += value
            self.count += 1
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self.counts[i] += 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"buckets": list(self.counts), "sum": self.sum,
                    "count": self.count}

    def zero(self):
        with self._lock:
            self.counts = [0] * len(self.buckets)
            self.sum = 0.0
            self.count = 0


class _Family:
    """A named metric family: children keyed by label-value tuples."""

    kind = "untyped"

    def __init__(self, name: str, doc: str, labelnames: Tuple[str, ...]):
        _check_name(name)
        for ln in labelnames:
            _check_name(ln)
        self.name = name
        self.doc = doc
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], Any] = {}

    def _make_child(self):
        return _Value()

    def labels(self, **labelvalues):
        """Get-or-create the child for this label set (cache the result at
        the call site — this takes the family lock on first use)."""
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got "
                f"{tuple(labelvalues)}")
        key = tuple(str(labelvalues[ln]) for ln in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._make_child())
        return child

    def _default(self):
        if self.labelnames:
            raise ValueError(f"{self.name} has labels {self.labelnames}; "
                             f"use .labels(...)")
        return self.labels()

    def samples(self) -> List[Tuple[Dict[str, str], Any]]:
        with self._lock:
            items = list(self._children.items())
        return [(dict(zip(self.labelnames, key)), child)
                for key, child in items]

    def remove(self, **labelvalues):
        """Drop one label set from the exposition. Callers that label
        series per instance (``inst=...``) MUST remove them on teardown —
        otherwise every rebuilt instance leaks a dead series into every
        scrape (the classic Prometheus cardinality leak). A child object
        already cached by the caller keeps working after removal; only the
        exposition forgets it."""
        key = tuple(str(labelvalues[ln]) for ln in self.labelnames)
        with self._lock:
            self._children.pop(key, None)

    def clear(self):
        """Drop every child (test-reset support; exposition of a cleared
        counter restarting at 0 reads as a process restart)."""
        with self._lock:
            self._children.clear()


class Counter(_Family):
    kind = "counter"

    def inc(self, amount: float = 1.0):
        self._default().inc(amount)

    @property
    def value(self) -> float:
        return self._default().value


class Gauge(_Family):
    kind = "gauge"

    def set(self, value: float):
        self._default().set(value)

    def inc(self, amount: float = 1.0):
        self._default().inc(amount)

    @property
    def value(self) -> float:
        return self._default().value


class InstancedEvents:
    """Per-instance event counters over one shared ``(inst, event)``
    family: a short random ``inst`` label distinguishes instances on the
    process-wide exposition while each instance's cached children give it
    a from-zero dict view. :meth:`close` MUST run on instance teardown —
    otherwise every rebuilt instance leaks its dead-uuid series into
    every subsequent scrape (the classic Prometheus cardinality leak).
    The cached children keep working after close(); only the exposition
    forgets them. Shared by the serving engine and the HTTP frontend."""

    def __init__(self, family: "Counter", events: Iterable[str],
                 inst: Optional[str] = None):
        import uuid
        self.family = family
        self.inst = inst if inst is not None else uuid.uuid4().hex[:8]
        self.children = {e: family.labels(inst=self.inst, event=e)
                         for e in events}

    def __getitem__(self, event: str):
        return self.children[event]

    def close(self):
        for e in self.children:
            self.family.remove(inst=self.inst, event=e)


def _norm_buckets(buckets) -> Tuple[float, ...]:
    b = tuple(sorted(float(x) for x in buckets))
    if not b or b[-1] != float("inf"):
        b = b + (float("inf"),)
    return b


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name, doc, labelnames, buckets=_DEFAULT_BUCKETS):
        super().__init__(name, doc, labelnames)
        self.buckets = _norm_buckets(buckets)

    def _make_child(self):
        return _HistValue(self.buckets)

    def observe(self, value: float):
        self._default().observe(value)


class MetricsRegistry:
    """Process-wide metric table: typed families + collector adapters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}
        # prefix -> zero-arg callable returning a (possibly nested) dict
        self._collectors: Dict[str, Callable[[], Optional[Dict]]] = {}

    # --- native instruments -------------------------------------------------
    def _family(self, cls, name, doc, labelnames, **kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or \
                        fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name} already registered as "
                        f"{fam.kind}{fam.labelnames}")
                if "buckets" in kw and \
                        fam.buckets != _norm_buckets(kw["buckets"]):
                    # silently handing back the old boundaries would put
                    # the second caller's observations in the wrong buckets
                    raise ValueError(
                        f"histogram {name} already registered with "
                        f"buckets {fam.buckets}")
                return fam
            fam = cls(name, doc, tuple(labelnames), **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, doc: str = "",
                labelnames: Iterable[str] = ()) -> Counter:
        return self._family(Counter, name, doc, labelnames)

    def gauge(self, name: str, doc: str = "",
              labelnames: Iterable[str] = ()) -> Gauge:
        return self._family(Gauge, name, doc, labelnames)

    def histogram(self, name: str, doc: str = "",
                  labelnames: Iterable[str] = (),
                  buckets: Iterable[float] = _DEFAULT_BUCKETS) -> Histogram:
        return self._family(Histogram, name, doc, labelnames,
                            buckets=tuple(buckets))

    # --- collector adapters -------------------------------------------------
    def register_collector(self, prefix: str,
                           fn: Callable[[], Optional[Dict]]):
        """Register a zero-arg snapshot callable; its numeric entries are
        exposed as gauges named ``<prefix>_<key>``. Re-registering a prefix
        replaces the callable (idempotent for module-level registrations)."""
        _check_name(prefix)
        with self._lock:
            self._collectors[prefix] = fn

    def register_object(self, prefix: str, obj: Any,
                        method: str = "snapshot",
                        inst: Optional[str] = None):
        """Register a stats *instance* weakly: its ``snapshot()`` dict is
        exposed under ``prefix`` with an ``inst`` label distinguishing
        instances; a garbage-collected instance silently leaves the
        exposition. Registration is idempotent per live object."""
        _check_name(prefix)
        inst = inst if inst is not None else f"{id(obj):x}"
        key = f"{prefix}:{inst}"

        # reap at finalization, not at the next scrape: a process that
        # never scrapes (a long AutoML study building one PipelineStats
        # per trial, no /metrics.prom endpoint) must not grow _collectors
        # by one dead entry per instance forever
        def _reap(_ref, _self=weakref.ref(self)):
            reg = _self()
            if reg is not None:
                with reg._lock:
                    reg._collectors.pop(key, None)

        ref = weakref.ref(obj, _reap)

        def collect() -> Optional[Dict]:
            o = ref()
            if o is None:     # finalizer not yet run (GC in progress)
                return None
            return getattr(o, method)()

        collect._prefix = prefix        # exposition groups by real prefix
        collect._inst = inst
        with self._lock:
            self._collectors[key] = collect

    def unregister_collector(self, prefix: str):
        with self._lock:
            self._collectors.pop(prefix, None)

    # --- iteration ----------------------------------------------------------
    def families(self) -> List[_Family]:
        with self._lock:
            return list(self._families.values())

    def collector_samples(self) -> List[Tuple[str, Dict[str, str], float]]:
        """Flattened (name, labels, value) samples from every registered
        collector. Nested dicts join keys with ``_``; non-numeric values
        (bools, strings, None, lists) are skipped — the typed families are
        where real schema lives."""
        with self._lock:
            collectors = list(self._collectors.items())
        out: List[Tuple[str, Dict[str, str], float]] = []
        for key, fn in collectors:
            try:
                snap = fn()
            except Exception:       # noqa: BLE001 — one bad collector must
                continue            # not take down the whole exposition
            if not isinstance(snap, dict):
                continue
            prefix = getattr(fn, "_prefix", key)
            labels = ({"inst": fn._inst} if hasattr(fn, "_inst") else {})
            self._flatten(prefix, labels, snap, out)
        return out

    @staticmethod
    def _flatten(prefix: str, labels: Dict[str, str], snap: Dict,
                 out: List, depth: int = 0):
        for k, v in snap.items():
            name = f"{prefix}_{sanitize(k)}"
            if isinstance(v, bool) or v is None:
                continue
            if isinstance(v, (int, float)):
                out.append((name, labels, float(v)))
            elif isinstance(v, dict) and depth < 2:
                MetricsRegistry._flatten(name, labels, v, out, depth + 1)

    def snapshot(self) -> Dict[str, Any]:
        """Everything as one plain dict (the ``zoo-metrics dump --json``
        body): family samples keyed by name + sorted label items."""
        out: Dict[str, Any] = {}
        for fam in self.families():
            for labels, child in fam.samples():
                key = fam.name
                if labels:
                    key += "{" + ",".join(
                        f"{k}={v}" for k, v in sorted(labels.items())) + "}"
                out[key] = (child.snapshot() if isinstance(child, _HistValue)
                            else child.value)
        for name, labels, value in self.collector_samples():
            key = name
            if labels:
                key += "{" + ",".join(
                    f"{k}={v}" for k, v in sorted(labels.items())) + "}"
            out[key] = value
        return out

    def reset(self):
        """Zero every family's children IN PLACE — test isolation only.
        Families, children, and collectors all stay registered: planes
        bind family objects at import/construction time (resilience
        STATS, the serving engine, the compile collector) and cache
        child objects, so dropping either would silently orphan those
        planes from the exposition for the rest of the process. Counters
        restarting at 0 read as a process restart, which scrapers
        already handle."""
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            for _labels, child in fam.samples():
                child.zero()


#: the process-wide registry every plane reports into
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY
