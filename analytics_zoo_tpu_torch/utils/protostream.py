"""Minimal protobuf wire-format helpers shared by the TensorBoard event
writer (utils/tensorboard.py) and the ONNX loader (pipeline/api/onnx) — this
stack carries no protobuf/onnx runtime dependency."""

from __future__ import annotations

import struct
from typing import Iterator, Tuple, Union


def varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def pb_tag(field: int, wire: int) -> bytes:
    return varint((field << 3) | wire)


def pb_packed_floats(field: int, vals) -> bytes:
    """Length-delimited packed float32 list (FloatList.value and friends)."""
    body = struct.pack(f"<{len(vals)}f", *[float(v) for v in vals])
    return pb_tag(field, 2) + varint(len(body)) + body


def pb_packed_int64s(field: int, vals) -> bytes:
    """Length-delimited packed varint list (Int64List.value, BlobShape.dim)."""
    body = b"".join(varint(int(v) & 0xFFFFFFFFFFFFFFFF) for v in vals)
    return pb_tag(field, 2) + varint(len(body)) + body


def read_varint(data: bytes, i: int) -> Tuple[int, int]:
    v = 0
    shift = 0
    while True:
        b = data[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7


def decode_fields(data: bytes) -> Iterator[Tuple[int, int, Union[int, bytes]]]:
    """Yield (field_number, wire_type, value). Length-delimited and fixed
    fields yield raw bytes; varints yield ints."""
    i = 0
    while i < len(data):
        key, i = read_varint(data, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = read_varint(data, i)
            yield field, wire, v
        elif wire == 1:
            yield field, wire, data[i:i + 8]
            i += 8
        elif wire == 2:
            ln, i = read_varint(data, i)
            yield field, wire, data[i:i + ln]
            i += ln
        elif wire == 5:
            yield field, wire, data[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")


def zigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def signed64(v: int) -> int:
    """Interpret a varint as two's-complement int64 (protobuf int64)."""
    return v - (1 << 64) if v >= (1 << 63) else v
