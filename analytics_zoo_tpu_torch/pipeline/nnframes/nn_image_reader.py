"""NNImageReader (counterpart of ``analytics_zoo_tpu/pipeline/nnframes/
nn_image_reader.py``; parity: pyzoo/zoo/pipeline/nnframes/
nn_image_reader.py:25 — read image files into a DataFrame with an
image-struct column).

Each record has the JAX package's fields: ``origin`` (the path),
``height``, ``width``, ``nChannels`` (3), ``mode`` (16) and ``data``, an
``(h, w, 3)`` uint8 RGB array. Files decode through ``feature/image/
codecs.py`` (PNG and BMP on the host, JPEG on the card through nvJPEG;
``device`` is ``cuda`` unless the caller asks for the CPU, and raises
without a GPU, as every entry point of the port does; a JPEG's EXIF
orientation is left as stored, as PIL's ``Image.open`` leaves it). A file that is not a PNG, JPEG or BMP is
skipped, as JAX skips what PIL cannot open. A resize is PIL's default
``resize``, bicubic (a = -0.5) with antialiasing, computed by
``torch.nn.functional.interpolate(mode="bicubic", antialias=True)`` on the
uint8 CPU tensor (within one level of PIL's).

The JAX reader falls back to a record of raw bytes when PIL is missing;
the port has no such fallback. pandas is imported when ``readImages`` is
called: the module itself needs it only for the DataFrame it returns.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...common.context import resolve_device
from ...feature.image.codecs import read_image


def _decode(path: str, device) -> Optional[dict]:
    try:
        arr = read_image(path, device, exif_orientation=False)
    except ValueError:              # not a PNG, JPEG or BMP the port reads
        return None
    return {"origin": path, "height": arr.shape[0], "width": arr.shape[1],
            "nChannels": arr.shape[2], "mode": 16, "data": arr}


def resize_bicubic(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """PIL's ``Image.fromarray(img).resize((width, height))`` of an (h, w,
    3) uint8 array: bicubic with antialiasing, on the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    out = F.interpolate(t, size=(height, width), mode="bicubic",
                        antialias=True, align_corners=False)
    return out[0].permute(1, 2, 0).contiguous().numpy()


class NNImageReader:
    @staticmethod
    def readImages(path: str, min_partitions: int = 1,
                   resize_height: int = -1, resize_width: int = -1,
                   image_codec: int = -1, device=None):
        import pandas as pd
        dev = resolve_device(device)
        if os.path.isdir(path):
            files = sorted(
                p for p in glob.glob(os.path.join(path, "**", "*"),
                                     recursive=True) if os.path.isfile(p))
        else:
            files = sorted(glob.glob(path))
        rows = []
        for p in files:
            rec = _decode(p, dev)
            if rec is None:
                continue
            if resize_height > 0 and resize_width > 0:
                rec["data"] = resize_bicubic(rec["data"], resize_height,
                                             resize_width)
                rec["height"], rec["width"] = resize_height, resize_width
            rows.append({"image": rec})
        return pd.DataFrame(rows)

    read_images = readImages
