"""Host-to-device transfer plane (counterpart of
``analytics_zoo_tpu/native/transfer.py``) for one CUDA device.

* **Narrow wire dtypes** (:func:`narrow_wire`): f64/i64/u64/c128 host
  arrays are narrowed to f32/i32/u32/c64 before they leave the host, the
  form the JAX package's device arrays take with x64 off. The result is
  bit-identical to the JAX package's ``narrow_wire`` (x64 off) and halves
  the bytes on the wire; narrow dtypes pass through untouched.
* **Pinned staging ring** (:class:`StagingPool`): batches are gathered
  straight into a ring of reused page-locked host tensors, so the copy to
  the card is a DMA from pinned memory (no pageable bounce, no malloc per
  batch).
* **Copies on a side stream** (:func:`put_tree`): each leaf goes over with
  ``non_blocking=True`` on a transfer stream, and one CUDA event marks the
  batch's copies. The compute stream waits on that event before it reads
  the batch (``utils.Batch.to``), and each tensor is marked as used by the
  compute stream so the caching allocator does not hand its memory out
  while a step still reads it.

The trap: a pinned buffer must not be refilled while its last copy is
still in flight, or the card receives a torn batch; no test on the CPU can
show it. Each ring slot keeps the event of its last copy, and
:meth:`StagingPool.acquire` waits on that event before it hands the slot
out again.

A fused group's superbatch (up to 256 MiB) would pin several GB in a ring
sized in slots, so its ring is sized in bytes (:func:`fused_ring`: at
most ``FUSED_STAGING_BYTES`` of superbatches, and never fewer than
``FUSED_MIN_RING`` slots). The pump feeds a fused epoch with one assembly
worker and one transfer lane, whose in-flight window (one superbatch
assembling, one waiting for the lane, one copying) that minimum covers.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import knobs as _knobs
from ..resilience import faults as _faults
from ..resilience import watchdog as _watchdog

__all__ = ["narrow_wire", "narrows_to", "wire_nbytes", "put_tree",
           "StagingPool", "StagingSlot", "default_h2d_lanes",
           "MAX_H2D_LANES", "FUSED_STAGING_BYTES", "fused_ring",
           "staging_enabled"]

# ceiling for adaptive lane growth, as in the JAX package
MAX_H2D_LANES = 8

# pinned bytes the superbatch ring of a fused epoch may hold, and its
# least slot count (the one-worker, one-lane pump's window plus one)
FUSED_STAGING_BYTES = 1 << 30
FUSED_MIN_RING = 4


def fused_ring(group_nbytes: int) -> int:
    """Slots per leaf for superbatches of ``group_nbytes`` (all leaves):
    as many as fit ``FUSED_STAGING_BYTES``, at least ``FUSED_MIN_RING``."""
    return max(FUSED_MIN_RING,
               FUSED_STAGING_BYTES // max(int(group_nbytes), 1))

_NARROW = {np.dtype(np.float64): np.float32,
           np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32,
           np.dtype(np.complex128): np.complex64}


def default_h2d_lanes() -> int:
    """Parallel H2D transfer-lane count (``ZOO_H2D_LANES``, default 2)."""
    return max(1, min(int(_knobs.get("ZOO_H2D_LANES")), MAX_H2D_LANES))


def narrows_to(dtype) -> Optional[np.dtype]:
    """The dtype :func:`narrow_wire` casts ``dtype`` to, or None when it
    already rides narrow."""
    target = _NARROW.get(np.dtype(dtype) if dtype is not None else None)
    return None if target is None else np.dtype(target)


def narrow_wire(a: np.ndarray) -> np.ndarray:
    """``a`` narrowed to its wire dtype (a new array), or ``a`` itself when
    its dtype already rides narrow."""
    target = _NARROW.get(getattr(a, "dtype", None))
    return a if target is None else a.astype(target)


def wire_nbytes(leaves) -> int:
    """Bytes a leaf list puts on the wire (after narrowing)."""
    total = 0
    for a in leaves:
        n = int(getattr(a, "nbytes", 0))
        dt = getattr(a, "dtype", None)
        if dt is not None and not isinstance(dt, torch.dtype) and \
                np.dtype(dt) in _NARROW:
            n //= 2
        total += n
    return total


class StagingSlot:
    """One pinned host buffer of the ring: ``tensor`` (page-locked) and
    ``array`` (a numpy view of the same bytes, for the gather), plus the
    event of the last copy that read it."""

    __slots__ = ("tensor", "array", "event")

    def __init__(self, shape, dtype):
        self.tensor = torch.empty(tuple(shape),
                                  dtype=_torch_dtype(np.dtype(dtype)),
                                  pin_memory=True)
        self.array = self.tensor.numpy()
        self.event: Optional[torch.cuda.Event] = None

    @property
    def nbytes(self) -> int:
        return self.array.nbytes


def staging_enabled(device=None) -> bool:
    """Whether batches are gathered into the reused staging ring:
    ``ZOO_HOST_STAGING=1``/``0`` decides when set; else on for a ``cuda``
    device, off for the CPU (``device`` None: the card when there is one).
    The JAX package keys the default on its default backend not being the
    CPU's; the port keys it on the device the batches go to. The ring is
    pinned memory, so a CPU device never stages, whatever this says."""
    env = os.environ.get("ZOO_HOST_STAGING", "").strip()
    if env in ("0", "1"):
        return env == "1"
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dt)).dtype


class StagingPool:
    """Ring of reusable pinned host buffers, keyed by (tag, shape, dtype).

    ``acquire`` returns the key's next slot, allocating until the ring is
    full; before it hands out a slot that was used, it waits for the event
    of that slot's last copy to the card. The ring is sized above the
    pump's in-flight window (assembly workers, transfer lanes, delivery
    depth), so in steady state that event has long completed.
    """

    def __init__(self, ring: int = 12):
        self.ring = max(2, int(ring))
        self._lock = threading.Lock()
        self._rings = {}        # key -> ([slots], cursor)

    def acquire(self, shape, dtype, tag=None,
                ring: Optional[int] = None) -> StagingSlot:
        """``tag`` partitions the rings (one per batch leaf), so two leaves
        of one signature do not draw one ring down twice as fast. ``ring``
        caps this key's ring below the pool's (a superbatch's
        :func:`fused_ring`)."""
        key = (tag, tuple(shape), np.dtype(dtype).str)
        size = self.ring if ring is None else max(2, min(self.ring, ring))
        with self._lock:
            slots, cur = self._rings.get(key, ([], 0))
            if len(slots) < size:
                slot = StagingSlot(shape, dtype)
                slots.append(slot)
                self._rings[key] = (slots, 0)
                return slot
            slot = slots[cur]
            self._rings[key] = (slots, (cur + 1) % len(slots))
        if slot.event is not None:
            slot.event.synchronize()
        return slot

    @property
    def allocated_bytes(self) -> int:
        with self._lock:
            return sum(s.tensor.nbytes for slots, _ in self._rings.values()
                       for s in slots)


def put_tree(leaves: Sequence, device: torch.device,
             stream: Optional[torch.cuda.Stream] = None
             ) -> Tuple[List[torch.Tensor], Optional[torch.cuda.Event]]:
    """Copy one batch's leaves to ``device``. A leaf is a numpy array or a
    :class:`StagingSlot`. On a CUDA device the copies are ``non_blocking``
    on ``stream`` (a side stream), and the returned event follows them;
    each slot keeps that event until its next reuse. On the CPU the arrays
    become tensors over the same bytes (numpy arrays only: nothing is
    reused there) and the event is None.

    The ``h2d.put`` fault site fires inside a section of the active
    dispatch watchdog, so a delay-mode fault (a hung copy) trips it as
    the real thing would."""
    wd = _watchdog.active()
    token = wd.enter("h2d.put") if wd is not None else None
    try:
        _faults.fire("h2d.put")
        return _put_tree(leaves, device, stream)
    finally:
        if token is not None:
            wd.exit(token)


def _put_tree(leaves, device, stream):
    if device.type != "cuda":
        return [torch.from_numpy(np.ascontiguousarray(a)) for a in leaves
                ], None
    stream = stream if stream is not None else torch.cuda.current_stream(
        device)
    out = []
    with torch.cuda.stream(stream):
        for a in leaves:
            if isinstance(a, StagingSlot):
                src = a.tensor
            else:
                src = torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
            out.append(src.to(device, non_blocking=True))
        ev = torch.cuda.Event()
        ev.record(stream)
    for a in leaves:
        if isinstance(a, StagingSlot):
            a.event = ev
    return out, ev
