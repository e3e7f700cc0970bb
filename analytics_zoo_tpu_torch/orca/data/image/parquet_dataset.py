"""ParquetDataset: image and array datasets as parquet (counterpart of
``analytics_zoo_tpu/orca/data/image/parquet_dataset.py``; parity:
pyzoo/zoo/orca/data/image/parquet_dataset.py:33 write/read_as_xshards/
read_as_tf/read_as_torch, write_from_directory:169, write_mnist:220).

A dataset is a directory of ``part-NNNNN.parquet`` blocks, written and read
with pandas and pyarrow (imported inside the functions that use them), and
``_orca_schema.pkl``, the pickled ``{column: SchemaField}``. ndarray and
image fields are stored as raw bytes beside a ``<name>__shape`` column.

The schema pickle is a wire format shared with the JAX package: it names
the JAX package's class, ``analytics_zoo_tpu.orca.data.image.
parquet_dataset.SchemaField``. The port writes the same bytes as the JAX
package for the same schema (:class:`_SchemaPickler`), and reads either
package's file without importing the JAX package (:class:`_SchemaUnpickler`
resolves only that class, to the port's :class:`SchemaField`).
"""

from __future__ import annotations

import io
import os
import pickle
import struct
from typing import Dict, Iterable, List

import numpy as np

from ..shard import HostXShards

_SCHEMA_FILE = "_orca_schema.pkl"
# the class path the JAX package's pickle names
_WIRE_MODULE = "analytics_zoo_tpu.orca.data.image.parquet_dataset"


class SchemaField:
    """reference parquet_dataset.py SchemaField(feature_type, dtype, shape)."""

    def __init__(self, feature_type: str = "scalar", dtype: str = "float32",
                 shape: tuple = ()):
        self.feature_type = feature_type      # "scalar" | "ndarray" | "image"
        self.dtype = dtype
        self.shape = tuple(shape)


class _SchemaPickler(pickle._Pickler):
    """The standard pickler, but :class:`SchemaField` is written under the
    JAX package's module name, with the opcodes ``save_global`` writes for
    it there (protocol 4 and up), so the file's bytes equal the JAX
    package's."""

    def save_global(self, obj, name=None):
        if obj is not SchemaField:
            return super().save_global(obj, name)
        self.save(_WIRE_MODULE)
        self.save(SchemaField.__qualname__)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _SchemaUnpickler(pickle.Unpickler):
    """Resolves ``SchemaField`` of either package's module to the port's
    class, and refuses every other global."""

    def find_class(self, module, name):
        if name == "SchemaField" and module in (_WIRE_MODULE, __name__):
            return SchemaField
        raise pickle.UnpicklingError(
            f"{module}.{name} is not a class of a parquet dataset schema")


def _dump_schema(schema: Dict[str, SchemaField]) -> bytes:
    buf = io.BytesIO()
    _SchemaPickler(buf, pickle.DEFAULT_PROTOCOL).dump(schema)
    return buf.getvalue()


def _load_schema_bytes(data: bytes) -> Dict[str, SchemaField]:
    return _SchemaUnpickler(io.BytesIO(data)).load()


class ParquetDataset:
    @staticmethod
    def write(path: str, generator: Iterable[dict],
              schema: Dict[str, SchemaField], block_size: int = 1000,
              write_mode: str = "overwrite", **kwargs):
        """Stream dict records into parquet blocks. ndarray/image fields are
        stored as raw bytes + shape columns (parquet has no tensor type)."""
        import pandas as pd

        if os.path.exists(path):
            if write_mode == "overwrite":
                import shutil
                shutil.rmtree(path)
            elif write_mode == "errorifexists":
                raise FileExistsError(path)
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, _SCHEMA_FILE), "wb") as f:
            f.write(_dump_schema(schema))

        def flush(rows: List[dict], block_id: int):
            if not rows:
                return
            cols: Dict[str, list] = {}
            for name, field in schema.items():
                if field.feature_type in ("ndarray", "image"):
                    cols[name] = [np.asarray(r[name]).tobytes()
                                  for r in rows]
                    cols[name + "__shape"] = [
                        list(np.asarray(r[name]).shape) for r in rows]
                else:
                    cols[name] = [r[name] for r in rows]
            pd.DataFrame(cols).to_parquet(
                os.path.join(path, f"part-{block_id:05d}.parquet"))

        rows, block_id = [], 0
        for record in generator:
            rows.append(record)
            if len(rows) >= block_size:
                flush(rows, block_id)
                rows, block_id = [], block_id + 1
        flush(rows, block_id)

    @staticmethod
    def _load_schema(path: str) -> Dict[str, SchemaField]:
        with open(os.path.join(path, _SCHEMA_FILE), "rb") as f:
            return _load_schema_bytes(f.read())

    @staticmethod
    def read_as_xshards(path: str) -> HostXShards:
        """One shard per parquet block: {'col': np.ndarray stacked}."""
        import pandas as pd

        schema = ParquetDataset._load_schema(path)
        parts = sorted(p for p in os.listdir(path) if p.endswith(".parquet"))

        def load_part(fname):
            df = pd.read_parquet(os.path.join(path, fname))
            out = {}
            for name, field in schema.items():
                if field.feature_type in ("ndarray", "image"):
                    arrays = [
                        np.frombuffer(b, dtype=field.dtype).reshape(shape)
                        for b, shape in zip(df[name], df[name + "__shape"])]
                    try:
                        out[name] = np.stack(arrays)
                    except ValueError:      # ragged images
                        out[name] = np.asarray(arrays, dtype=object)
                else:
                    out[name] = df[name].to_numpy()
            return out

        return HostXShards([load_part(p) for p in parts])

    @staticmethod
    def _merged(path: str):
        shards = ParquetDataset.read_as_xshards(path).collect()
        keys = list(shards[0].keys())
        return keys, {k: np.concatenate([s[k] for s in shards])
                      for k in keys}

    @staticmethod
    def read_as_torch(path: str):
        """torch Dataset view (reference read_as_torch): item i is the dict
        of row i's fields."""
        import torch

        keys, merged = ParquetDataset._merged(path)

        class _DS(torch.utils.data.Dataset):
            def __len__(self):
                return len(merged[keys[0]])

            def __getitem__(self, i):
                return {k: merged[k][i] for k in keys}

        return _DS()

    @staticmethod
    def read_as_tf(path: str):
        """tf.data.Dataset view (reference read_as_tf); requires tf."""
        import tensorflow as tf

        _, merged = ParquetDataset._merged(path)
        return tf.data.Dataset.from_tensor_slices(merged)


def write_from_directory(directory: str, label_map: Dict[str, int],
                         output_path: str, shuffle: bool = True, **kwargs):
    """Image folder (class subdirs) -> parquet (reference
    write_from_directory:169)."""
    records = []
    for cat, label in sorted(label_map.items()):
        cat_dir = os.path.join(directory, cat)
        if not os.path.isdir(cat_dir):
            continue
        for fname in sorted(os.listdir(cat_dir)):
            with open(os.path.join(cat_dir, fname), "rb") as f:
                records.append({"image": np.frombuffer(f.read(), np.uint8),
                                "label": label,
                                "image_id": f"{cat}/{fname}"})
    if shuffle:
        np.random.RandomState(0).shuffle(records)
    schema = {"image": SchemaField("ndarray", "uint8", ()),
              "label": SchemaField("scalar", "int64"),
              "image_id": SchemaField("scalar", "str")}
    ParquetDataset.write(output_path, iter(records), schema, **kwargs)


def _read32(stream) -> int:
    return struct.unpack(">I", stream.read(4))[0]


def _open_idx(filepath: str):
    import gzip
    return (gzip.open if filepath.endswith(".gz") else open)(filepath, "rb")


def _extract_mnist_images(image_filepath: str) -> np.ndarray:
    with _open_idx(image_filepath) as f:
        magic = _read32(f)
        if magic != 2051:
            raise ValueError(f"bad MNIST image magic {magic}")
        n, rows, cols = _read32(f), _read32(f), _read32(f)
        buf = f.read(n * rows * cols)
        return np.frombuffer(buf, np.uint8).reshape(n, rows, cols, 1)


def _extract_mnist_labels(labels_filepath: str) -> np.ndarray:
    with _open_idx(labels_filepath) as f:
        magic = _read32(f)
        if magic != 2049:
            raise ValueError(f"bad MNIST label magic {magic}")
        n = _read32(f)
        return np.frombuffer(f.read(n), np.uint8).astype(np.int64)


def write_ndarrays(images: np.ndarray, labels: np.ndarray, output_path: str,
                   **kwargs):
    schema = {"image": SchemaField("ndarray", str(images.dtype),
                                   images.shape[1:]),
              "label": SchemaField("scalar", "int64")}

    def gen():
        for img, lab in zip(images, labels):
            yield {"image": img, "label": int(lab)}

    ParquetDataset.write(output_path, gen(), schema, **kwargs)


def write_mnist(image_file: str, label_file: str, output_path: str, **kwargs):
    """reference write_mnist:220 — idx files -> parquet."""
    images = _extract_mnist_images(image_file)
    labels = _extract_mnist_labels(label_file)
    write_ndarrays(images, labels, output_path, **kwargs)


def write_voc(voc_root_path: str, splits_names, output_path: str, **kwargs):
    """reference write_voc:226 — VOC detection records -> parquet. Stores
    encoded image bytes + bbox array + class ids."""
    import xml.etree.ElementTree as ET

    records = []
    for (year, split) in splits_names:
        base = os.path.join(voc_root_path, f"VOC{year}")
        with open(os.path.join(base, "ImageSets", "Main",
                               f"{split}.txt")) as f:
            ids = [line.strip() for line in f if line.strip()]
        for img_id in ids:
            ann = ET.parse(os.path.join(base, "Annotations",
                                        f"{img_id}.xml")).getroot()
            boxes = []
            for obj in ann.iter("object"):
                bb = obj.find("bndbox")
                boxes.append([float(bb.find(k).text)
                              for k in ("xmin", "ymin", "xmax", "ymax")])
            with open(os.path.join(base, "JPEGImages",
                                   f"{img_id}.jpg"), "rb") as f:
                img = np.frombuffer(f.read(), np.uint8)
            records.append({"image": img,
                            "label": np.asarray(boxes, np.float32),
                            "image_id": img_id})
    schema = {"image": SchemaField("ndarray", "uint8", ()),
              "label": SchemaField("ndarray", "float32", ()),
              "image_id": SchemaField("scalar", "str")}
    ParquetDataset.write(output_path, iter(records), schema, **kwargs)
