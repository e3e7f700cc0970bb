"""3D image transforms (counterpart of ``analytics_zoo_tpu/feature/image3d/
transformation.py``, numpy only in both packages, so a copy; parity:
pyzoo/zoo/feature/image3d/transformation.py —
Crop3D:37, RandomCrop3D:49, CenterCrop3D:62, Rotate3D:75,
AffineTransform3D:88; Scala feature/image3d/).

Host-side numpy/scipy-free implementations over (D, H, W[, C]) volumes,
chainable like the 2D preprocessing stack (feature/image/preprocessing.py)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


class ImagePreprocessing3D:
    def __call__(self, sample):
        return self.transform(sample)

    def transform(self, volume: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def chain(self, other: "ImagePreprocessing3D") -> "ImagePreprocessing3D":
        first = self

        class _Chained(ImagePreprocessing3D):
            def transform(self, v):
                return other.transform(first.transform(v))

        return _Chained()

    # reference uses -> operator via ChainedPreprocessing; chain() mirrors it


class Crop3D(ImagePreprocessing3D):
    """Crop patch at `start` (z, y, x) of size `patch_size`."""

    def __init__(self, start: Sequence[int], patch_size: Sequence[int]):
        self.start = tuple(int(s) for s in start)
        self.patch_size = tuple(int(p) for p in patch_size)

    def transform(self, v: np.ndarray) -> np.ndarray:
        z, y, x = self.start
        d, h, w = self.patch_size
        return v[z:z + d, y:y + h, x:x + w]


class RandomCrop3D(ImagePreprocessing3D):
    def __init__(self, crop_depth: int, crop_height: int, crop_width: int,
                 seed: Optional[int] = None):
        self.size = (int(crop_depth), int(crop_height), int(crop_width))
        self._rng = np.random.RandomState(seed)

    def transform(self, v: np.ndarray) -> np.ndarray:
        d, h, w = self.size
        z = self._rng.randint(0, v.shape[0] - d + 1)
        y = self._rng.randint(0, v.shape[1] - h + 1)
        x = self._rng.randint(0, v.shape[2] - w + 1)
        return v[z:z + d, y:y + h, x:x + w]


class CenterCrop3D(ImagePreprocessing3D):
    def __init__(self, crop_depth: int, crop_height: int, crop_width: int):
        self.size = (int(crop_depth), int(crop_height), int(crop_width))

    def transform(self, v: np.ndarray) -> np.ndarray:
        d, h, w = self.size
        z = (v.shape[0] - d) // 2
        y = (v.shape[1] - h) // 2
        x = (v.shape[2] - w) // 2
        return v[z:z + d, y:y + h, x:x + w]


def _affine_sample(v: np.ndarray, mat: np.ndarray,
                   translation: np.ndarray) -> np.ndarray:
    """Inverse-map trilinear resampling around the volume centre."""
    shape = v.shape[:3]
    center = (np.asarray(shape, np.float64) - 1) / 2.0
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    coords = np.stack([zz, yy, xx], axis=-1).astype(np.float64) - center
    inv = np.linalg.inv(mat)
    src = coords @ inv.T + center - translation
    lo = np.floor(src).astype(np.int64)
    frac = src - lo
    out = np.zeros(shape, np.float64)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                idx = lo + np.asarray([dz, dy, dx])
                wgt = np.prod(np.where([dz, dy, dx], frac, 1 - frac),
                              axis=-1)
                valid = np.all((idx >= 0) & (idx < np.asarray(shape)),
                               axis=-1)
                iz, iy, ix = (np.clip(idx[..., i], 0, shape[i] - 1)
                              for i in range(3))
                out += np.where(valid, wgt * v[iz, iy, ix], 0.0)
    return out.astype(v.dtype if np.issubdtype(v.dtype, np.floating)
                      else np.float32)


class Rotate3D(ImagePreprocessing3D):
    """Rotate by yaw/pitch/roll (radians), trilinear resample (reference
    Rotate3D(rotationAngles))."""

    def __init__(self, rotation_angles: Sequence[float]):
        a, b, c = (float(x) for x in rotation_angles)
        rz = np.asarray([[np.cos(a), -np.sin(a), 0],
                         [np.sin(a), np.cos(a), 0], [0, 0, 1]])
        ry = np.asarray([[np.cos(b), 0, np.sin(b)], [0, 1, 0],
                         [-np.sin(b), 0, np.cos(b)]])
        rx = np.asarray([[1, 0, 0], [0, np.cos(c), -np.sin(c)],
                         [0, np.sin(c), np.cos(c)]])
        self.mat = rz @ ry @ rx

    def transform(self, v: np.ndarray) -> np.ndarray:
        return _affine_sample(v, self.mat, np.zeros(3))


class AffineTransform3D(ImagePreprocessing3D):
    def __init__(self, affine_mat: np.ndarray,
                 translation: Optional[np.ndarray] = None,
                 clamp_mode: str = "clamp", pad_val: float = 0.0):
        self.mat = np.asarray(affine_mat, np.float64).reshape(3, 3)
        self.translation = (np.zeros(3) if translation is None
                            else np.asarray(translation, np.float64))

    def transform(self, v: np.ndarray) -> np.ndarray:
        return _affine_sample(v, self.mat, self.translation)
