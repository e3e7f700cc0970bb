"""ImageSet — image collections on the port's XShards (counterpart of
``analytics_zoo_tpu/feature/image/imageset.py``).

Mirrors the reference's ImageSet (pyzoo/zoo/feature/image/imageset.py:21:
read/transform/get_image/get_label; Scala zoo/.../feature/image/ImageSet.scala:370
with LocalImageSet/DistributedImageSet): an ImageSet wraps a ``HostXShards``
of sample dicts {'image': HWC uint8 RGB, 'label': optional, 'uri': path}
and feeds the estimator through ``to_dataset()``.

Files are decoded by ``codecs.decode_image`` on the host thread pool: PNG
and BMP on the host, JPEG on the card through nvJPEG, copied back, so
samples stay HWC uint8 numpy arrays as in the JAX package. ``read`` takes
``device`` as every entry point of the port does: ``cuda`` unless the
caller asks for the CPU, and it raises without a GPU; with
``device="cpu"`` a JPEG raises (the port has no host JPEG decoder).
"""

from __future__ import annotations

import glob as _glob
import os
from typing import List, Optional

import numpy as np

from ...common.context import resolve_device
from ...orca.data.shard import HostXShards, _pmap
from .codecs import read_image
from .preprocessing import Preprocessing

_IMG_EXT = (".jpg", ".jpeg", ".png", ".bmp")


def _list_images(path: str) -> List[str]:
    if os.path.isdir(path):
        out = sorted(p for p in _glob.glob(os.path.join(path, "**", "*"),
                                           recursive=True)
                     if p.lower().endswith(_IMG_EXT))
    else:
        out = sorted(_glob.glob(path))
    if not out:
        raise FileNotFoundError(f"no images under {path}")
    return out


class ImageSet:
    def __init__(self, shards: HostXShards):
        self.shards = shards

    @classmethod
    def read(cls, path: str, with_label: bool = False,
             one_based_label: bool = True,
             num_partitions: Optional[int] = None,
             device=None) -> "ImageSet":
        """Read images from a directory (label = parent dir name when
        with_label, as the reference's ImageSet.read label mode)."""
        dev = resolve_device(device)
        paths = _list_images(path)

        label_map = {}
        if with_label:
            classes = sorted({os.path.basename(os.path.dirname(p))
                              for p in paths})
            base = 1 if one_based_label else 0
            label_map = {c: i + base for i, c in enumerate(classes)}

        def load(p):
            sample = {"image": read_image(p, dev), "uri": p}
            if with_label:
                sample["label"] = np.int32(
                    label_map[os.path.basename(os.path.dirname(p))])
            return sample

        samples = _pmap(load, paths)
        n = num_partitions or max(1, min(len(samples), os.cpu_count() or 4))
        chunks = np.array_split(np.arange(len(samples)), n)
        shards = HostXShards([[samples[i] for i in idx] for idx in chunks
                              if len(idx)])
        obj = cls(shards)
        obj.label_map = label_map
        return obj

    @classmethod
    def from_arrays(cls, images: np.ndarray, labels=None,
                    num_partitions: int = 1) -> "ImageSet":
        samples = []
        for i in range(len(images)):
            s = {"image": images[i]}
            if labels is not None:
                s["label"] = labels[i]
            samples.append(s)
        chunks = np.array_split(np.arange(len(samples)), num_partitions)
        return cls(HostXShards([[samples[i] for i in idx] for idx in chunks]))

    def transform(self, transformer: Preprocessing) -> "ImageSet":
        return ImageSet(self.shards.transform_shard(
            lambda part: [transformer.apply(s) for s in part]))

    def get_image(self) -> List[np.ndarray]:
        return [s["image"] for part in self.shards.collect() for s in part]

    def get_label(self) -> List:
        return [s.get("label") for part in self.shards.collect() for s in part]

    def to_dataset(self, with_label: bool = True) -> HostXShards:
        """Stack each partition into the estimator's {'x','y'} arrays."""
        def stack(part):
            xs = np.stack([s["image"] for s in part]).astype(np.float32)
            out = {"x": (xs,)}
            if with_label and "label" in part[0]:
                out["y"] = (np.asarray([s["label"] for s in part]),)
            return out
        return self.shards.transform_shard(stack)
