"""Self-contained TensorBoard event writer/reader (parity: the reference
ships its own TB implementation JVM-side — zoo/.../tensorboard/Summary.scala:182,
FileWriter.scala:89, EventWriter.scala:75, FileReader.scala:121 — backing
setTensorBoard/getTrainSummary).

No TF dependency: events files are hand-encoded protobuf records in the
TFRecord framing (length + masked crc32c). Scalars only — that is all the
reference's get_train_summary/get_validation_summary expose."""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

# --- crc32c (Castagnoli), table-driven --------------------------------------

_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# --- minimal protobuf encoding (wire helpers shared with the ONNX loader
# and the TFRecord/Caffe codecs — one encoder set, utils/protostream.py) ---

from .protostream import decode_fields as \
    _decode_fields  # noqa: E402
from .protostream import pb_tag as _tag  # noqa: E402
from .protostream import varint as _varint  # noqa


def _pb_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _pb_int64(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _pb_string(field: int, v: str) -> bytes:
    return _pb_bytes(field, v.encode("utf-8"))


def encode_scalar_event(tag: str, value: float, step: int,
                        wall_time: Optional[float] = None) -> bytes:
    summary_value = _pb_string(1, tag) + _pb_float(2, float(value))
    summary = _pb_bytes(1, summary_value)
    event = (_pb_double(1, wall_time or time.time()) +
             _pb_int64(2, int(step)) + _pb_bytes(5, summary))
    return event


def encode_file_version() -> bytes:
    return (_pb_double(1, time.time()) +
            _pb_string(3, "brain.Event:2"))


def _frame(record: bytes) -> bytes:
    header = struct.pack("<Q", len(record))
    return (header + struct.pack("<I", _masked_crc(header)) + record +
            struct.pack("<I", _masked_crc(record)))


class FileWriter:
    """Append scalar events to an events file under log_dir (reference
    FileWriter.scala:89)."""

    def __init__(self, log_dir: str, flush_secs: float = 2.0):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._lock = threading.Lock()
        self._f.write(_frame(encode_file_version()))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        with self._lock:
            self._f.write(_frame(encode_scalar_event(tag, value, step)))

    def flush(self):
        with self._lock:
            self._f.flush()

    def close(self):
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()


# --- reader -------------------------------------------------------------------

def read_scalars(log_dir_or_file: str) -> Dict[str, List[Tuple[int, float]]]:
    """Parse events files -> {tag: [(step, value), ...]} (reference
    FileReader.scala:121 readScalar)."""
    paths = []
    if os.path.isdir(log_dir_or_file):
        for name in sorted(os.listdir(log_dir_or_file)):
            if "tfevents" in name:
                paths.append(os.path.join(log_dir_or_file, name))
    else:
        paths = [log_dir_or_file]
    out: Dict[str, List[Tuple[int, float]]] = {}
    for path in paths:
        with open(path, "rb") as f:
            data = f.read()
        i = 0
        while i + 12 <= len(data):
            (length,) = struct.unpack("<Q", data[i:i + 8])
            record = data[i + 12:i + 12 + length]
            i += 12 + length + 4
            step = 0
            summary = None
            for field, wire, val in _decode_fields(record):
                if field == 2 and wire == 0:
                    step = val
                elif field == 5 and wire == 2:
                    summary = val
            if summary is None:
                continue
            for field, wire, val in _decode_fields(summary):
                if field == 1 and wire == 2:
                    tag, simple = None, None
                    for f2, w2, v2 in _decode_fields(val):
                        if f2 == 1 and w2 == 2:
                            tag = v2.decode("utf-8")
                        elif f2 == 2 and w2 == 5:
                            (simple,) = struct.unpack("<f", v2)
                    if tag is not None and simple is not None:
                        out.setdefault(tag, []).append((step, simple))
    return out
