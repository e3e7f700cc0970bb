"""Wire codecs for serving payloads — ndarray <-> base64(arrow), matching the
reference client's encoding (pyzoo/zoo/serving/client.py:267-282 b64 + arrow
streaming format; JVM twin serving/arrow/ArrowSerializer.scala:170). Sparse
tensors ride the same wire as {shape, data, indices} triples, the reference
ingress schema (serving/http/domains.scala:100 ``SparseTensor[T](shape,
data, indices)``) — recommendation traffic routinely sends sparse features.
"""

from __future__ import annotations

import base64
import io
import json
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np


@dataclass
class SparseTensor:
    """COO sparse tensor (reference: http/domains.scala:100).

    ``indices`` is (nnz, ndim) int; ``data`` is (nnz,) values. The TPU
    compute path is dense (XLA static shapes), so serving densifies at
    batch-assembly time via ``to_dense`` — for the reference's
    recommendation models these are small per-record feature vectors, and
    the dense batch then rides the normal bucketed executable."""
    shape: Tuple[int, ...]
    data: np.ndarray
    indices: np.ndarray

    def __post_init__(self):
        self.shape = tuple(int(s) for s in self.shape)
        self.data = np.asarray(self.data)
        self.indices = np.asarray(self.indices, dtype=np.int64)
        if self.indices.size == 0:     # all-zero tensor: [] at any rank
            self.indices = self.indices.reshape(0, len(self.shape))
        if self.indices.ndim == 1:     # 1-D tensor: allow flat index lists
            self.indices = self.indices[:, None]
        if self.indices.shape != (len(self.data), len(self.shape)):
            raise ValueError(
                f"indices shape {self.indices.shape} does not match "
                f"{len(self.data)} values over a rank-{len(self.shape)} "
                "tensor")
        # reject out-of-range at ingress: negative indices would silently
        # wrap in to_dense, and overflow would explode at batch time —
        # inside a co-batched group, failing OTHER clients' requests
        if len(self.data):
            upper = np.asarray(self.shape, dtype=np.int64)
            if (self.indices < 0).any() or (self.indices >= upper).any():
                raise ValueError(
                    f"indices out of range for shape {self.shape}")

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.data.dtype)
        if len(self.data):
            # np.add.at: duplicate coordinates SUM (un-coalesced COO
            # convention) instead of silently keeping the last value
            np.add.at(out, tuple(self.indices.T), self.data)
        return out


def densify(data):
    """Replace any SparseTensor in a decoded payload with its dense form."""
    if isinstance(data, SparseTensor):
        return data.to_dense()
    if isinstance(data, list):
        return [densify(d) for d in data]
    if isinstance(data, dict):
        return {k: densify(v) for k, v in data.items()}
    return data


def encode_ndarray(arr: np.ndarray) -> str:
    import pyarrow as pa
    arr = np.ascontiguousarray(arr)
    tensor = pa.Tensor.from_numpy(arr)
    sink = pa.BufferOutputStream()
    pa.ipc.write_tensor(tensor, sink)
    return base64.b64encode(sink.getvalue().to_pybytes()).decode("ascii")


def decode_ndarray(s: str) -> np.ndarray:
    import pyarrow as pa
    buf = base64.b64decode(s)
    tensor = pa.ipc.read_tensor(pa.BufferReader(buf))
    return tensor.to_numpy()


def _encode_one(data) -> Dict:
    if isinstance(data, SparseTensor):
        return {"kind": "sparse", "shape": list(data.shape),
                "data": encode_ndarray(data.data),
                "indices": encode_ndarray(data.indices)}
    return {"kind": "tensor", "data": encode_ndarray(np.asarray(data))}


def _decode_one(body):
    if isinstance(body, str):              # bare tensor (legacy form)
        return decode_ndarray(body)
    if body["kind"] == "sparse":
        return SparseTensor(shape=tuple(body["shape"]),
                            data=decode_ndarray(body["data"]),
                            indices=decode_ndarray(body["indices"]))
    return decode_ndarray(body["data"])


def encode_payload(data: Any, meta: Dict | None = None) -> bytes:
    """data: ndarray | SparseTensor | list/tuple | dict[str, ...] of them."""
    if isinstance(data, np.ndarray):
        body = {"kind": "tensor", "data": encode_ndarray(data)}
    elif isinstance(data, SparseTensor):
        body = _encode_one(data)
    elif isinstance(data, (list, tuple)):
        body = {"kind": "tensors", "data": [_encode_one(a) for a in data]}
    elif isinstance(data, dict):
        body = {"kind": "named",
                "data": {k: _encode_one(v) for k, v in data.items()}}
    else:
        raise ValueError(f"cannot encode {type(data)}")
    if meta:
        body["meta"] = meta
    return json.dumps(body).encode("utf-8")


def decode_payload(raw: bytes) -> Tuple[Any, Dict]:
    body = json.loads(raw.decode("utf-8") if isinstance(
        raw, (bytes, bytearray)) else bytes(raw).decode("utf-8"))
    kind = body["kind"]
    if kind in ("tensor", "sparse"):
        data = _decode_one(body)
    elif kind == "tensors":
        data = [_decode_one(s) for s in body["data"]]
    else:
        data = {k: _decode_one(v) for k, v in body["data"].items()}
    return data, body.get("meta", {})


# --- shm descriptor wire ----------------------------------------------------
# The JSON + base64(arrow) wire above costs ~2.7 copies of every tensor on
# each side (contiguous copy, arrow buffer, b64 text). On a shm-enabled
# stream the producer instead writes RAW tensor bytes into arena slabs once
# and ships descriptors (dtype/shape ride the ObjectRef); the consumer maps
# them read-only — zero payload copies on decode. Sparse tensors and any
# arena failure fall back to an inline frame wrapping the exact legacy
# encoding, so mixed traffic drains through one decode entry point.

def encode_payload_ref(data: Any, meta: Dict | None = None, *,
                       arena) -> Tuple[bytes, List]:
    """Encode for a shm-enabled stream: ``(wire_bytes, refs)``.

    Dense payloads (ndarray | list/tuple | dict[str, ndarray]) go to
    slabs — one descriptor per tensor, layout + user meta in the envelope
    header. The producer pin is released before returning (the frame is
    self-contained); consumers owe ``arena.done(ref)`` per ref after the
    result is published. Sparse payloads and arena overflow return an
    inline frame of :func:`encode_payload` with ``refs == []``; with no
    arena at all this IS :func:`encode_payload`."""
    from ..shm import ArenaFull, min_shm_bytes, wrap_inline, wrap_ref
    if arena is None:
        return encode_payload(data, meta), []
    names: List[str] | None = None
    if isinstance(data, np.ndarray):
        kind, arrays = "tensor", [data]
    elif isinstance(data, (list, tuple)) and data and all(
            not isinstance(a, SparseTensor) for a in data):
        kind, arrays = "tensors", [np.asarray(a) for a in data]
    elif isinstance(data, dict) and data and all(
            not isinstance(v, SparseTensor) for v in data.values()):
        kind = "named"
        names = [str(k) for k in data.keys()]
        arrays = [np.asarray(data[k]) for k in data.keys()]
    else:
        return wrap_inline(encode_payload(data, meta)), []
    if sum(int(np.asarray(a).nbytes) for a in arrays) < min_shm_bytes():
        # under the size floor the descriptor overhead (slab burn, index
        # lock, lease writes) costs more than the copy it saves — stay on
        # the legacy wire, byte for byte
        return encode_payload(data, meta), []
    refs = []
    try:
        for a in arrays:
            a = np.ascontiguousarray(a)
            refs.append(arena.put(a, dtype=a.dtype.str, shape=a.shape))
    except (ArenaFull, OSError, ValueError):
        for r in refs:          # free the partial put — inline carries all
            arena.done(r)
        return wrap_inline(encode_payload(data, meta)), []
    env_meta: Dict = {}
    if names is not None:
        env_meta["names"] = names
    if meta:
        env_meta["meta"] = meta
    frame = wrap_ref(refs, meta=env_meta or None, kind=kind)
    for r in refs:              # handoff complete: drop the producer pins
        arena.release(r)
    return frame, refs


def decode_ref(raw, *, arena=None) -> Tuple[Any, Dict, List]:
    """Decode a serving payload that may be a shm envelope: returns
    ``(data, meta, refs)``. Descriptor frames map each tensor's slab
    read-only (zero copy, C-contiguous, pinned in this process's lease)
    and the caller owes ``arena.done(ref)`` per ref strictly AFTER the
    answer for the item is published — a PEL reclaim must be able to
    re-resolve the same generation. Inline frames and legacy payloads
    decode exactly as :func:`decode_payload` with ``refs == []``."""
    from ..shm import ObjectRef, is_envelope, unwrap
    if not is_envelope(raw):
        return (*decode_payload(raw), [])
    flag, header, payload = unwrap(raw)
    if flag == "I":
        return (*decode_payload(payload), [])
    if arena is None:
        raise ValueError("descriptor frame on a stream with no shm arena "
                         "(consumer has ZOO_SHM off or shm unavailable)")
    refs = [ObjectRef.from_dict(d) for d in header.get("refs", [])]
    arrays = []
    try:
        for r in refs:
            arrays.append(arena.checkout(r))
    except Exception:
        for r, _ in zip(refs, arrays):   # unwind partial pins
            arena.release(r)
        raise
    env_meta = header.get("meta") or {}
    kind = header.get("kind", "tensors")
    if kind == "tensor":
        data: Any = arrays[0]
    elif kind == "named":
        data = dict(zip(env_meta.get("names", []), arrays))
    else:
        data = list(arrays)
    return data, env_meta.get("meta", {}), refs
