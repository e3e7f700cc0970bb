"""Descriptor envelope riding the existing broker wire.

A payload on a shm-enabled stream is either a **descriptor frame**
(magic + small JSON header naming :class:`~.arena.ObjectRef` slabs) or
an **inline frame** (the same magic with the ``I`` flag, followed by
today's payload byte for byte — the fallback when the arena is full, the
blob is oversized, or shm is unavailable). Legacy payloads without the
magic pass through untouched, so a shm-enabled consumer drains a mixed
stream and ``ZOO_SHM=0`` keeps the wire bit-identical to before this
plane existed.

The header carries the record's routing key (``k``) when the wrapped
payload had one, so the partitioned broker's key-sharding survives the
descriptor wire without touching the slab.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from ..common import knobs
from .arena import (ArenaFull, BlobArena, ObjectRef, StaleObjectRef,
                    arena_for, shm_available)

__all__ = ["MAGIC", "is_envelope", "wrap_inline", "wrap_ref", "unwrap",
           "min_shm_bytes",
           "envelope_key", "peek_refs", "publish_blob", "resolve_blob",
           "shm_enabled_for_spec", "arena_for_spec", "sweep_spec"]

MAGIC = b"ZSHM1"
_FLAG_INLINE = b"I"
_FLAG_REF = b"R"

_LOCAL_HOSTS = ("127.0.0.1", "localhost", "::1", "")


def is_envelope(buf) -> bool:
    return bytes(memoryview(buf)[:5]) == MAGIC


def _frame(flag: bytes, header: Dict, payload: bytes = b"") -> bytes:
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    return b"".join([MAGIC, flag, len(head).to_bytes(4, "big"), head,
                     payload])


def wrap_inline(payload, key: Optional[str] = None) -> bytes:
    """Inline frame: the original payload embedded byte for byte."""
    header = {} if key is None else {"k": str(key)}
    return _frame(_FLAG_INLINE, header, bytes(payload))


def wrap_ref(refs: List[ObjectRef], meta: Optional[Dict] = None,
             key: Optional[str] = None, kind: str = "blob") -> bytes:
    header: Dict = {"kind": kind, "refs": [r.to_dict() for r in refs]}
    if meta:
        header["meta"] = meta
    if key is not None:
        header["k"] = str(key)
    return _frame(_FLAG_REF, header)


def unwrap(buf) -> Tuple[str, Dict, memoryview]:
    """Envelope -> ``(flag, header, payload_view)`` where flag is
    ``"I"``/``"R"`` and payload_view is the embedded inline payload
    (empty for descriptor frames). Raises ValueError on a non-envelope."""
    view = memoryview(buf)
    if bytes(view[:5]) != MAGIC:
        raise ValueError("not a shm envelope")
    flag = bytes(view[5:6]).decode("ascii")
    hlen = int.from_bytes(bytes(view[6:10]), "big")
    header = json.loads(bytes(view[10:10 + hlen]))
    return flag, header, view[10 + hlen:]


def envelope_key(buf) -> Optional[str]:
    """Routing key stamped on an envelope, header-only (the partition
    router's hot path)."""
    _, header, _ = unwrap(buf)
    k = header.get("k")
    return None if k is None else str(k)


def peek_refs(buf) -> List[ObjectRef]:
    """Descriptors named by an envelope WITHOUT checking them out — the
    consume-without-decode paths (dedup replay, shed) use this to mark
    the blob done."""
    if not is_envelope(buf):
        return []
    flag, header, _ = unwrap(buf)
    if flag != "R":
        return []
    return [ObjectRef.from_dict(d) for d in header.get("refs", [])]


def min_shm_bytes() -> int:
    """Descriptor-path size floor (``ZOO_SHM_MIN_BYTES``): below it the
    fixed per-object cost — a whole slab burned, the index flock, two
    lease-file rewrites per side — exceeds the copy it saves, so small
    payloads stay on the inline wire even with the plane on."""
    return int(knobs.get("ZOO_SHM_MIN_BYTES"))


# --- whole-blob convenience (streaming records, opaque payloads) ------------
def publish_blob(arena: Optional[BlobArena], payload: bytes,
                 key: Optional[str] = None) -> bytes:
    """Producer side: payload -> descriptor frame (one copy, into the
    slab), falling back to an inline frame when the arena cannot take it
    and to the bare payload when there is no arena at all or the payload
    is under the :func:`min_shm_bytes` floor."""
    if arena is None or len(payload) < min_shm_bytes():
        return payload
    try:
        ref = arena.put(payload)
    except (ArenaFull, OSError, ValueError):
        from .arena import _counters
        _counters()["inline"].inc(len(payload))
        return wrap_inline(payload, key=key)
    frame = wrap_ref([ref], key=key)
    # handoff complete: the frame is self-contained, so drop the producer
    # pin — the blob stays alive (unconsumed) until a consumer done()s it,
    # and a producer crash after enqueue leaks nothing past gc grace
    arena.release(ref)
    return frame


def resolve_blob(buf, arena: Optional[BlobArena]
                 ) -> Tuple[memoryview, Optional[ObjectRef]]:
    """Consumer side: broker payload -> ``(bytes_view, ref)``.

    Legacy payloads and inline frames return their bytes (ref None);
    descriptor frames check out the slab (pinning it in this process's
    lease) and return the read-only mapping — the caller owes
    ``arena.done(ref)`` after it acked the entry, or ``release`` to
    abandon. Raises :class:`StaleObjectRef` on a freed generation and
    ValueError on a descriptor frame with no arena to resolve against."""
    if not is_envelope(buf):
        return memoryview(buf), None
    flag, header, payload = unwrap(buf)
    if flag == "I":
        return payload, None
    if arena is None:
        raise ValueError("descriptor frame on a stream with no shm arena "
                         "(consumer has ZOO_SHM off or shm unavailable)")
    refs = [ObjectRef.from_dict(d) for d in header.get("refs", [])]
    if len(refs) != 1:
        raise ValueError(f"blob frame must carry one ref, got {len(refs)}")
    arr = arena.checkout(refs[0])
    return memoryview(arr).cast("B"), refs[0]


# --- broker-spec plumbing ---------------------------------------------------
def _spec_base(spec: str) -> str:
    return spec.partition("?")[0]


def shm_enabled_for_spec(spec: Optional[str]) -> bool:
    """Descriptor wire active for this broker spec? Requires ``ZOO_SHM=1``
    plus a transport whose producer and consumer share a host: memory and
    file always qualify locally; redis only when it points at localhost
    (the operator's colocation assertion — a cross-host consumer cannot
    map this host's segments)."""
    if not spec or not knobs.get("ZOO_SHM") or not shm_available():
        return False
    base = _spec_base(spec)
    if base.startswith(("memory://", "file://")):
        return True
    if base.startswith("redis://"):
        hostport = base[len("redis://"):].partition("/")[0]
        return hostport.rpartition(":")[0] in _LOCAL_HOSTS \
            or hostport in _LOCAL_HOSTS
    return False


def arena_for_spec(spec: Optional[str]) -> Optional[BlobArena]:
    """The (process-cached) arena every process sharing this broker spec
    base agrees on, or None when the descriptor wire is off for it."""
    if not shm_enabled_for_spec(spec):
        return None
    return arena_for(_spec_base(spec))


def sweep_spec(spec: Optional[str],
               dead_pids: Optional[List[int]] = None) -> Dict:
    """Supervisor hook: sweep the spec's arena after reaping workers (a
    SIGKILLed consumer's lease pins die with its pid, not with its
    Python). No-op when the spec has no descriptor wire."""
    arena = arena_for_spec(spec)
    if arena is None:
        return {"leases_swept": 0, "freed": 0}
    return arena.sweep(dead_pids)
