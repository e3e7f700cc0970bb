"""CUDA-graph capture and replay of fused step groups: the card's
counterpart of the JAX engine's ``lax.scan`` over k steps
(``analytics_zoo_tpu/orca/learn/engine.py`` ``_train_multi_step``,
``_eval_multi_step``), and of TCMF's ``lax.scan`` over epochs
(``zouwu/model/tcmf.py``: one graph of an epoch, replayed).

A :class:`StepGraph` holds one captured graph of k train (or eval) steps
over static input buffers. :meth:`StepGraph.replay` copies a superbatch
into those buffers on the current stream and replays the graph there, so
one fused group costs one launch from the host instead of the 80-150
eager launches of each step. The engine (``orca/learn/engine.py``) decides
what the graph holds and when it may be captured; this module only
captures, replays and counts.

* **One capture at a time.** :func:`capture` holds a process-wide lock
  and captures in ``thread_local`` mode on the engine's own side stream,
  so the infeed pump's transfer lanes, the checkpoint writer and the
  steps of concurrent trials keep issuing CUDA work on their streams
  meanwhile.
* **Generators.** A generator that a captured step draws from is
  registered with the graph before the capture; a replay then draws with
  the generator's seed and offset at replay time, at the offsets the
  eager step would use.
* **Kernel counts.** The hand-written kernels' wrappers count their
  launches in Python (``ops/attention.py``), where they launch. A capture
  launches nothing, so it takes back what the wrappers counted during it
  and keeps it as :attr:`StepGraph.launches`, the launches of each kernel
  that one replay holds. A replay runs no Python and adds to no count: a
  caller that must know what ran inside replays reads the device's own
  record of the kernels (``torch.profiler``).
* **Lifetime.** A graph lives with its engine until the engine drops it.
  Code that runs many short trainings on one card (an AutoML trial) wraps
  each in :func:`released_on_exit`, which drops the graphs captured on
  its thread inside the block when the block ends, so a long study does
  not accumulate graph memory pools.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Sequence

import torch

_CAPTURE_LOCK = threading.Lock()
_SCOPES = threading.local()

# captures and replays by kind since the process started: the engine's
# fused "train" and "eval" groups, and TCMF's epochs ("tcmf",
# ``zouwu/model/tcmf.py``)
CAPTURES: Dict[str, int] = {"train": 0, "eval": 0, "tcmf": 0}
REPLAYS: Dict[str, int] = {"train": 0, "eval": 0, "tcmf": 0}


def generators_supported() -> bool:
    """Whether this torch registers a ``torch.Generator`` with a graph
    (``CUDAGraph.register_generator_state``)."""
    return hasattr(torch.cuda.CUDAGraph, "register_generator_state")


def _counted_kernels():
    from ...ops import attention
    return (attention.flash_fwd, attention.flash_bwd_dq,
            attention.flash_bwd_dkv)


class StepGraph:
    """One captured group: ``static_in`` (device buffers the replay reads),
    ``static_out`` (what the capture returned, overwritten by each
    replay) and, by wrapper, the kernel launches the capture recorded
    (those one replay makes)."""

    def __init__(self, graph, kind: str, static_in: List[torch.Tensor],
                 static_out, launches: Dict[Callable, int], gens):
        self.graph = graph
        self.kind = kind
        self.static_in = static_in
        self.static_out = static_out
        self.launches = launches
        self.gens = gens

    def replay(self, inputs: Sequence[torch.Tensor]):
        """Copy ``inputs`` into the static buffers and replay, on the
        current stream; returns ``static_out`` (clone what must outlive the
        next replay)."""
        for dst, src in zip(self.static_in, inputs):
            dst.copy_(src, non_blocking=True)
        self.graph.replay()
        REPLAYS[self.kind] += 1
        return self.static_out


@contextlib.contextmanager
def released_on_exit():
    """Drop, when the block ends, the graphs every engine captured on this
    thread inside it (through the ``release`` the engine handed to
    :func:`capture`)."""
    stack = _SCOPES.__dict__.setdefault("stack", [])
    owners: Dict[int, Callable[[], None]] = {}
    stack.append(owners)
    try:
        yield
    finally:
        stack.pop()
        for release in owners.values():
            release()


def capture(kind: str, body: Callable, static_in: List[torch.Tensor],
            stream: torch.cuda.Stream, gens: Sequence = (),
            release: Callable[[], None] = None) -> StepGraph:
    """Capture ``body(*static_in)`` on ``stream`` into a new graph. The
    caller has run the same work eagerly on ``stream`` first (the warm-up:
    lazy state, kernel builds and library handles exist before the
    capture), and the current stream waits for ``stream`` afterwards.
    ``release`` drops the owner's graphs (see :func:`released_on_exit`).
    An error in the capture propagates."""
    graph = torch.cuda.CUDAGraph()
    for gen in gens:
        graph.register_generator_state(gen)
    kernels = _counted_kernels()
    with _CAPTURE_LOCK:
        before = [fn.launches for fn in kernels]
        with torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = body(*static_in)
            finally:
                graph.capture_end()
        launches = {fn: fn.launches - n for fn, n in zip(kernels, before)}
        for fn, n in zip(kernels, before):
            fn.launches = n             # the capture itself launched none
    torch.cuda.current_stream(stream.device).wait_stream(stream)
    CAPTURES[kind] += 1
    if release is not None:
        for owners in getattr(_SCOPES, "stack", ()):
            owners[id(getattr(release, "__self__", release))] = release
    return StepGraph(graph, kind, static_in, out,
                     {fn: n for fn, n in launches.items() if n}, gens)
