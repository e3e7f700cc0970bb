"""Structured spans with explicit cross-thread context propagation.

One trace id follows a request through every plane it touches:
``fit → epoch → engine.dispatch`` on the training loop thread,
``infeed.assemble / infeed.h2d`` on the pump's worker threads,
``ckpt.write`` on the checkpoint writer thread, ``supervisor.restart``
across an estimator teardown/rebuild, and in serving
``serving.request → serving.decode → serving.batch → serving.dispatch →
serving.respond`` across the aiohttp handler, the broker payload and the
batcher thread. The span taxonomy lives in ``docs/observability.md``.

Propagation is a contextvar plus an explicit **thread-handoff token**
(:func:`token` / :func:`span_under` / :func:`adopt`): the infeed lanes,
the ckpt writer, the supervisor's segment threads and the serving workers
all cross thread boundaries where a contextvar alone would lose the trace.
The serving path additionally rides the token *through the broker payload
meta*, Dapper-style, so the device-dispatch span in the batcher thread
chains to the HTTP request span that enqueued it.

Cost discipline (same as ``resilience/faults.py``): the production hook is
:func:`span`, whose disarmed path is one module-global flag check returning
a shared no-op context manager — measured in ``bench.py --only obs`` and
CI-gated below 1% of the NCF smoke step. Arm with ``ZOO_TRACE=1`` (import
time), :func:`arm`, or the :func:`tracing` context manager. Finished spans
land in a bounded ring (``ZOO_TRACE_RING`` spans, default 4096, oldest
evicted) exported by ``obs/export.py`` as Chrome/Perfetto ``trace_event``
JSON (``ZOO_TRACE_PERFETTO=<path>`` writes it at process exit).
"""

from __future__ import annotations

import contextvars
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

from ..common import knobs

__all__ = ["Span", "span", "span_under", "record_span", "token", "adopt",
           "current_trace_id", "arm", "disarm", "enabled", "tracing",
           "spans", "drain", "clear", "configure"]


class Span:
    """One finished span (ring-buffer record)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0", "t1",
                 "thread", "thread_name", "attrs")

    def __init__(self, name, trace_id, span_id, parent_id, t0, t1,
                 thread, thread_name, attrs):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0
        self.t1 = t1
        self.thread = thread
        self.thread_name = thread_name
        self.attrs = attrs

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "trace": self.trace_id,
                "span": self.span_id, "parent": self.parent_id,
                "t0": self.t0, "t1": self.t1, "thread": self.thread,
                "thread_name": self.thread_name, "attrs": dict(self.attrs)}


class _Ring:
    """Bounded span buffer: oldest spans are evicted, never the process."""

    def __init__(self, capacity: int):
        self._lock = threading.Lock()
        self._q: deque = deque(maxlen=max(16, int(capacity)))
        self.recorded = 0       # monotonic, survives eviction

    def append(self, s: Span):
        with self._lock:
            self._q.append(s)
            self.recorded += 1

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._q)

    def drain(self) -> List[Span]:
        with self._lock:
            out = list(self._q)
            self._q.clear()
            return out

    def clear(self):
        with self._lock:
            self._q.clear()
            self.recorded = 0

    def resize(self, capacity: int):
        with self._lock:
            self._q = deque(self._q, maxlen=max(16, int(capacity)))

    @property
    def capacity(self) -> int:
        return self._q.maxlen


RING = _Ring(knobs.get("ZOO_TRACE_RING"))

#: (trace_id, span_id) of the innermost live span on this thread/task
_ctx: contextvars.ContextVar[Optional[Tuple[str, str]]] = \
    contextvars.ContextVar("zoo_trace_ctx", default=None)

_armed = False


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


# --- arming ------------------------------------------------------------------

def arm():
    global _armed
    _armed = True


def disarm():
    global _armed
    _armed = False


def enabled() -> bool:
    return _armed


@contextmanager
def tracing(capacity: Optional[int] = None):
    """Arm tracing for a scope (tests, the obs bench's armed leg). Both
    the armed flag AND the ring capacity are restored on exit — a scoped
    capacity=64 must not truncate a ZOO_TRACE_PERFETTO process's atexit
    export for the rest of its life."""
    global _armed
    prev_cap = None
    if capacity is not None:
        prev_cap = RING.capacity
        RING.resize(capacity)
    prev, _armed = _armed, True
    try:
        yield RING
    finally:
        _armed = prev
        if prev_cap is not None:
            RING.resize(prev_cap)


def configure(capacity: Optional[int] = None):
    if capacity is not None:
        RING.resize(capacity)


# --- the production hooks ----------------------------------------------------

class _Noop:
    """Shared do-nothing span: the disarmed return value of every hook."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def set(self, **attrs):
        return self


_NOOP = _Noop()


class _LiveSpan:
    """Armed context manager: stamps ids, times the body, records on exit."""

    __slots__ = ("name", "attrs", "_parent", "trace_id", "span_id",
                 "_t0", "_reset")

    def __init__(self, name: str, parent: Optional[Tuple[str, str]],
                 attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self._parent = parent
        self.trace_id = parent[0] if parent else _new_id()
        self.span_id = _new_id()
        self._t0 = 0.0
        self._reset = None

    def __enter__(self):
        self._reset = _ctx.set((self.trace_id, self.span_id))
        # perf_counter, not time.time(): spans are intervals and the
        # Perfetto export renders t0 relative to the run's first span —
        # an NTP step mid-run must not produce negative durations or
        # scramble the step timeline. perf_counter is process-wide
        # comparable across threads, so cross-thread handoffs line up.
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        if self._reset is not None:
            _ctx.reset(self._reset)
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        t = threading.current_thread()
        RING.append(Span(self.name, self.trace_id, self.span_id,
                         self._parent[1] if self._parent else None,
                         self._t0, t1, t.ident or 0, t.name, self.attrs))
        return False

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self


def span(name: str, **attrs):
    """Open a span under the current context (or start a new trace at a
    root site). Disarmed: one flag check, shared no-op back."""
    if not _armed:
        return _NOOP
    return _LiveSpan(name, _ctx.get(), attrs)


def span_under(tok: Optional[str], name: str, **attrs):
    """Open a span parented at an explicit handoff ``tok`` (from
    :func:`token`, captured on the originating thread) — the cross-thread
    form of :func:`span`. A ``None`` token falls back to the local
    context (so a disarmed-at-capture pump still nests sanely)."""
    if not _armed:
        return _NOOP
    return _LiveSpan(name, _parse(tok) or _ctx.get(), attrs)


def record_span(name: str, t0: float, t1: float,
                parent: Optional[str] = None, **attrs):
    """Record an already-timed section retroactively (used where the
    parent token is only known after the work ran, e.g. the serving
    decode stage discovering the request's token inside the payload).
    ``t0``/``t1`` must come from ``time.perf_counter()`` — the span
    timebase all live spans use."""
    if not _armed:
        return
    p = _parse(parent) or _ctx.get()
    t = threading.current_thread()
    RING.append(Span(name, p[0] if p else _new_id(), _new_id(),
                     p[1] if p else None, t0, t1, t.ident or 0, t.name,
                     attrs))


# --- handoff tokens ----------------------------------------------------------

def token() -> Optional[str]:
    """The current span context as a portable string token (``trace:span``)
    for thread/process/payload handoff; None when disarmed or outside any
    span."""
    if not _armed:
        return None
    cur = _ctx.get()
    return f"{cur[0]}:{cur[1]}" if cur else None


def _parse(tok: Optional[str]) -> Optional[Tuple[str, str]]:
    if not tok or not isinstance(tok, str) or ":" not in tok:
        return None
    trace_id, _, span_id = tok.partition(":")
    return (trace_id, span_id) if trace_id and span_id else None


@contextmanager
def adopt(tok: Optional[str]):
    """Make ``tok`` the ambient context for a scope on another thread —
    spans opened inside nest under the originating span."""
    parsed = _parse(tok)
    if parsed is None:
        yield
        return
    reset = _ctx.set(parsed)
    try:
        yield
    finally:
        _ctx.reset(reset)


def current_trace_id() -> Optional[str]:
    cur = _ctx.get()
    return cur[0] if cur else None


# --- ring access -------------------------------------------------------------

def spans() -> List[Span]:
    return RING.spans()


def drain() -> List[Span]:
    return RING.drain()


def clear():
    RING.clear()


# whole-process runs arm at import, like ZOO_FAULTS: spans flow from the
# first dispatch on, and ZOO_TRACE_PERFETTO (handled in obs/export.py)
# writes the timeline at exit
if knobs.get("ZOO_TRACE"):
    arm()
