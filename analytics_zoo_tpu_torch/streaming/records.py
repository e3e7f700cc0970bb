"""Training-record wire format for the streaming plane (counterpart of
``analytics_zoo_tpu/streaming/records.py``, byte for byte the same wire).

One stream entry = one training example: a tuple of feature arrays, an
optional tuple of label arrays, and an **event time** (seconds since the
epoch, stamped by the producer). The encoding is a small JSON header plus
the raw C-contiguous array bytes — no pyarrow/pickle on the hot ingest
path, and decode never copies (each leaf is a frombuffer view reshaped).

Record **ids** are the streaming cursor's unit of progress: the cursor
stores the id of the last *trained* record, and replayed entries with an
id at or below it are deduplicated (the JAX package's ``streaming/source.py``). That only works
if ids are lexicographically monotonic in stream order — :func:`seq_id`
renders a producer sequence number into such an id; producers with their
own id scheme must preserve the same property (documented in
``docs/guides/streaming.md``, "cursor contract").

Records may additionally carry a **key** (``encode_record(key=...)``) —
the sharding handle of the fleet-scale plane: a producer stamps each
record with its routing identity (model name, user cohort, series id)
and :func:`partition_for` maps it deterministically onto one of N
partitions. The hash is CRC32, NOT Python ``hash()``: every producer
and consumer process must agree on the mapping across interpreter
restarts and hosts (PYTHONHASHSEED randomizes ``hash()`` per process).
:func:`record_key` reads the key header-only — the partition router on
the enqueue hot path never touches the array payload.
"""

from __future__ import annotations

import json
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["encode_record", "decode_record", "decode_ref", "seq_id",
           "record_key", "partition_for"]

_MAGIC = b"ZSR1"
_SHM_MAGIC = b"ZSHM1"


def seq_id(seq: int) -> str:
    """A record id for producer sequence number ``seq`` that sorts
    lexicographically in numeric order (20 digits covers int64)."""
    if seq < 0:
        raise ValueError(f"record sequence must be >= 0, got {seq}")
    return f"{int(seq):020d}"


def _contig(a) -> np.ndarray:
    # NOT ascontiguousarray: that promotes 0-d scalars to 1-d, and a
    # scalar label must round-trip as a scalar (stacked batches rely on
    # per-record shapes being exact)
    a = np.asarray(a)
    return a if a.flags.c_contiguous else np.ascontiguousarray(a)


def _as_tuple(v) -> Tuple[np.ndarray, ...]:
    if v is None:
        return ()
    if isinstance(v, (list, tuple)):
        return tuple(_contig(a) for a in v)
    return (_contig(v),)


def encode_record(x, y=None, event_time: Optional[float] = None,
                  key: Optional[str] = None) -> bytes:
    """Encode one training example. ``x``/``y`` are arrays or tuples of
    arrays (per-example shape, no batch dim); ``event_time`` defaults to
    0.0 — producers should stamp their own clock so freshness lag is
    measured from the event, not from ingestion. ``key`` is the optional
    routing identity (:func:`partition_for` shards on it); keyless
    records fall back to id-hash routing at the partitioned broker."""
    xs, ys = _as_tuple(x), _as_tuple(y)
    header = {
        "t": float(event_time) if event_time is not None else 0.0,
        "x": [{"shape": list(a.shape), "dtype": a.dtype.str} for a in xs],
        "y": ([{"shape": list(a.shape), "dtype": a.dtype.str} for a in ys]
              if y is not None else None),
    }
    if key is not None:
        header["k"] = str(key)
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    parts = [_MAGIC, len(head).to_bytes(4, "big"), head]
    for a in xs + ys:
        parts.append(a.tobytes())
    return b"".join(parts)


def decode_record(raw
                  ) -> Tuple[Tuple[np.ndarray, ...],
                             Optional[Tuple[np.ndarray, ...]], float]:
    """Decode :func:`encode_record` bytes -> (x_tuple, y_tuple|None,
    event_time). Leaves are zero-copy views into ``raw``, which may be
    any buffer — bytes, a memoryview of a received frame, or a mapped
    shared-memory slab — sliced via frombuffer, never via ``bytes()``
    materialization (only the few-hundred-byte JSON header is copied to
    parse)."""
    if not isinstance(raw, (bytes, bytearray)):
        raw = memoryview(raw).cast("B")
    if bytes(raw[:4]) != _MAGIC:
        raise ValueError("not a streaming record (bad magic)")
    hlen = int.from_bytes(raw[4:8], "big")
    header = json.loads(bytes(raw[8:8 + hlen]).decode("utf-8"))
    off = 8 + hlen

    def take(specs: Sequence[dict]) -> Tuple[np.ndarray, ...]:
        nonlocal off
        out = []
        for spec in specs:
            dt = np.dtype(spec["dtype"])
            shape = tuple(spec["shape"])
            n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            out.append(np.frombuffer(raw, dt, count=max(
                n // dt.itemsize, 0), offset=off).reshape(shape))
            off += n
        return tuple(out)

    xs = take(header["x"])
    ys = take(header["y"]) if header["y"] is not None else None
    return xs, ys, float(header["t"])


def decode_ref(raw, arena=None):
    """Decode a broker payload that may be a shm descriptor envelope:
    returns ``(x_tuple, y_tuple|None, event_time, ref)``. A descriptor
    frame maps the slab read-only (zero copy — the leaves are frombuffer
    views straight into shared memory, C-contiguous, ready for
    ``sharded_put``) and the caller owes ``arena.done(ref)`` after the
    entry is acked; inline frames and legacy payloads decode exactly as
    :func:`decode_record` with ``ref None``."""
    from ..shm import resolve_blob
    buf, ref = resolve_blob(raw, arena)
    x, y, et = decode_record(buf)
    return x, y, et, ref


def record_key(raw) -> Optional[str]:
    """The routing key of an encoded record, or None when the producer
    stamped none. Header-only: the partition router calls this once per
    enqueue and must not pay an array decode — nor a payload copy:
    ``raw`` may be any buffer and only the header bytes are touched.
    Descriptor envelopes (shm plane) carry the key in the envelope
    header, so sharding survives the descriptor wire."""
    if not isinstance(raw, (bytes, bytearray)):
        raw = memoryview(raw).cast("B")
    if bytes(raw[:5]) == _SHM_MAGIC:
        from ..shm import envelope_key
        return envelope_key(raw)
    if bytes(raw[:4]) != _MAGIC:
        raise ValueError("not a streaming record (bad magic)")
    hlen = int.from_bytes(raw[4:8], "big")
    k = json.loads(bytes(raw[8:8 + hlen]).decode("utf-8")).get("k")
    return None if k is None else str(k)


def partition_for(key: str, n_partitions: int) -> int:
    """Deterministic key -> partition index in ``[0, n_partitions)``.

    CRC32 of the UTF-8 key, mod N — stable across processes, hosts and
    interpreter restarts (unlike ``hash()``, which PYTHONHASHSEED salts
    per process), so every producer routes a key to the same partition
    and every consumer's cursor stays meaningful across restarts."""
    n = int(n_partitions)
    if n <= 0:
        raise ValueError(f"n_partitions must be >= 1, got {n_partitions}")
    return zlib.crc32(str(key).encode("utf-8")) % n
