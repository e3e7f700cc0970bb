"""TFRecord dataset reader/writer with zero TensorFlow dependency
(counterpart of ``analytics_zoo_tpu/orca/data/tfrecord.py``, a host-only
copy).

The reference consumes TFRecord corpora through tf.data
(pyzoo/zoo/tfpark/tf_dataset.py:480-705 TFRecordDataset forms; the ResNet
example reads ImageNet TFRecords). A training host has no reason to drag
the TF runtime in for that: TFRecord is length-prefixed framing (uint64 length,
masked crc32c, payload, crc) and tf.train.Example is three protobuf list
types — both parse fine with the wire-format tools already used by the
tensorboard writer (utils/protostream.py, utils/tensorboard.py crc32c).

Example proto schema (public tensorflow/core/example/example.proto):
    Example.features (field 1) -> Features
    Features.feature (field 1) -> map entries {key=1: string, value=2: Feature}
    Feature: oneof bytes_list=1 / float_list=2 / int64_list=3
    *List.value = field 1 (packed for numeric types)
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

from ...utils.protostream import (decode_fields, pb_packed_floats,
                                  pb_packed_int64s, read_varint, varint)
from ...utils.tensorboard import _masked_crc, _pb_bytes


# --------------------------------------------------------------------------
# record framing
# --------------------------------------------------------------------------

def read_records(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """Yield raw record payloads from one TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            if verify_crc:
                (crc,) = struct.unpack("<I", header[8:12])
                if _masked_crc(header[:8]) != crc:
                    raise IOError(f"corrupt length crc in {path}")
            data = f.read(length)
            tail = f.read(4)
            if len(data) < length or len(tail) < 4:
                raise IOError(f"truncated record in {path}")
            if verify_crc:
                (crc,) = struct.unpack("<I", tail)
                if _masked_crc(data) != crc:
                    raise IOError(f"corrupt data crc in {path}")
            yield data


def write_records(path: str, payloads: Iterator[bytes]) -> int:
    """Write raw payloads with TFRecord framing; returns record count."""
    n = 0
    with open(path, "wb") as f:
        for data in payloads:
            header = struct.pack("<Q", len(data))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(data)
            f.write(struct.pack("<I", _masked_crc(data)))
            n += 1
    return n


# --------------------------------------------------------------------------
# tf.train.Example encode / decode
# --------------------------------------------------------------------------

def encode_example(features: Dict[str, Any]) -> bytes:
    """dict -> serialized tf.train.Example. Values: bytes/str -> bytes_list,
    float arrays -> float_list, int arrays -> int64_list."""
    entries = []
    for key, val in features.items():
        if isinstance(val, (bytes, str)):
            items = [val.encode() if isinstance(val, str) else val]
            feature = _pb_bytes(1, b"".join(_pb_bytes(1, b) for b in items))
        elif isinstance(val, (list, tuple, np.ndarray)) and len(val) and \
                isinstance(np.asarray(val).flat[0], (bytes, str)):
            items = [v.encode() if isinstance(v, str) else v
                     for v in np.asarray(val).ravel().tolist()]
            feature = _pb_bytes(1, b"".join(_pb_bytes(1, b) for b in items))
        else:
            arr = np.asarray(val)
            if arr.dtype.kind in "iub":
                feature = _pb_bytes(
                    3, pb_packed_int64s(1, arr.ravel().tolist()))
            else:
                feature = _pb_bytes(
                    2, pb_packed_floats(1, arr.ravel().tolist()))
        entry = _pb_bytes(1, key.encode()) + _pb_bytes(2, feature)
        entries.append(_pb_bytes(1, entry))
    return _pb_bytes(1, b"".join(entries))


def decode_example(raw: bytes) -> Dict[str, np.ndarray]:
    """serialized tf.train.Example -> {name: ndarray | list[bytes]}."""
    out: Dict[str, Any] = {}
    for fnum, wire, val in decode_fields(raw):
        if fnum != 1 or wire != 2:      # Example.features
            continue
        for f2, w2, entry in decode_fields(val):
            if f2 != 1 or w2 != 2:      # Features.feature map entry
                continue
            key, feature = None, None
            for f3, w3, v3 in decode_fields(entry):
                if f3 == 1:
                    key = v3.decode()
                elif f3 == 2:
                    feature = v3
            if key is None or feature is None:
                continue
            out[key] = _decode_feature(feature)
    return out


def _decode_feature(feature: bytes):
    for fnum, wire, val in decode_fields(feature):
        if fnum == 1:                   # BytesList
            items = [v for f, w, v in decode_fields(val) if f == 1]
            return items
        if fnum == 2:                   # FloatList
            floats: List[float] = []
            for f, w, v in decode_fields(val):
                if f != 1:
                    continue
                if w == 2:              # packed
                    floats.extend(struct.unpack(f"<{len(v) // 4}f", v))
                elif w == 5:            # unpacked: raw 4 bytes per value
                    floats.append(struct.unpack("<f", v)[0])
            return np.asarray(floats, np.float32)
        if fnum == 3:                   # Int64List
            ints: List[int] = []
            for f, w, v in decode_fields(val):
                if f != 1:
                    continue
                if w == 2:              # packed varints
                    i = 0
                    while i < len(v):
                        x, i = read_varint(v, i)
                        ints.append(x - (1 << 64) if x >= (1 << 63) else x)
                elif w == 0:
                    ints.append(v - (1 << 64) if v >= (1 << 63) else v)
            return np.asarray(ints, np.int64)
    return np.asarray([], np.float32)


# --------------------------------------------------------------------------
# dataset-level API
# --------------------------------------------------------------------------

def _expand(paths: Union[str, Sequence[str]]) -> List[str]:
    if isinstance(paths, str):
        if os.path.isdir(paths):
            return sorted(
                os.path.join(paths, f) for f in os.listdir(paths)
                if f.endswith((".tfrecord", ".tfrecords")))
        return [paths]
    return list(paths)


def write_tfrecords(path: str, examples: Iterator[Dict[str, Any]]) -> int:
    """Write dict-features as tf.train.Examples into one TFRecord file."""
    return write_records(path, (encode_example(e) for e in examples))


def read_examples(paths: Union[str, Sequence[str]],
                  verify_crc: bool = False) -> Iterator[Dict[str, Any]]:
    """Stream decoded Examples from TFRecord files / a directory."""
    for p in _expand(paths):
        for raw in read_records(p, verify_crc=verify_crc):
            yield decode_example(raw)


def read_tfrecords_as_xshards(paths: Union[str, Sequence[str]],
                              feature_cols: Optional[Sequence[str]] = None,
                              label_cols: Optional[Sequence[str]] = None,
                              shard_size: int = 8192):
    """TFRecord corpus -> HostXShards of column arrays (the reference's
    TFRecordDataset -> XShards hand-off). Fixed-width features stack into
    (n, d) arrays; scalars flatten to (n,)."""
    from .shard import HostXShards

    def finalize(rows: List[Dict[str, Any]]) -> Dict[str, Any]:
        cols: Dict[str, List] = {}
        for r in rows:
            for k, v in r.items():
                cols.setdefault(k, []).append(v)
        out: Dict[str, Any] = {}
        for k, vals in cols.items():
            if isinstance(vals[0], list):       # bytes features
                out[k] = [b[0] if len(b) == 1 else b for b in vals]
            else:
                arr = np.stack(vals)
                out[k] = arr[:, 0] if arr.ndim == 2 and arr.shape[1] == 1 \
                    else arr
        if feature_cols:
            # tuple-valued x/y: the shard convention chunk_shards and
            # BatchIterator consume (orca/learn/utils.py:from_dict)
            data = {"x": tuple(out[c] for c in feature_cols)}
            if label_cols:
                data["y"] = tuple(out[c] for c in label_cols)
            return data
        return out

    shards, buf = [], []
    for ex in read_examples(paths):
        buf.append(ex)
        if len(buf) >= shard_size:
            shards.append(finalize(buf))
            buf = []
    if buf:
        shards.append(finalize(buf))
    return HostXShards(shards)
