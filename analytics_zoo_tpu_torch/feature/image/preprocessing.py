"""Image preprocessing transforms over numpy, the host stage of the infeed
pipeline (counterpart of ``analytics_zoo_tpu/feature/image/
preprocessing.py``, which calls cv2; the card's machine has no cv2).

Mirrors the reference's OpenCV-on-JVM transform set
(pyzoo/zoo/feature/image/imagePreprocessing.py: ImageResize, ImageCenterCrop,
ImageRandomCrop, ImageChannelNormalize, ImageHFlip, ImageMatToTensor,
ImageSetToSample; Scala twins under zoo/.../feature/image/). Transforms run
on the host CPU over uint8/float32 numpy arrays (HWC).

The classes, their fields and their ``random.Random`` draws are the JAX
package's, so a random transform draws the same values per seed. The cv2
calls are numpy code that follows cv2's own arithmetic:

* :func:`resize_linear` is ``cv2.resize(..., INTER_LINEAR)``: half-pixel
  centres, source columns clamped at the edges and source rows clipped.
  On uint8 it is cv2's fixed point, from float32 positions: 11-bit
  weights (``round((1 - f) * 2048)``), a horizontal pass in integers, then
  the vertical pass ``((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16)
  + 2) >> 2`` of cv2's vectorised row filter. An exact 2x downscale, which
  cv2 hands to ``INTER_AREA``, is the same 2x2 mean in this arithmetic. On
  float32 and float64 it computes in float64 and rounds once: cv2's own
  float path rounds positions to float32, but a cv2 built with Intel IPP
  (as the JAX package's reference is) resizes floats through IPP, which
  does not, and differs from that path by up to 4e-4 on the 0-255 scale.
* :func:`rgb_to_hsv` / :func:`hsv_to_rgb` are cv2's 8-bit ``RGB2HSV`` /
  ``HSV2RGB`` with H in [0, 180): the forward conversion in 12-bit fixed
  point over cv2's rounded division tables; the inverse in float32 as
  cv2 computes it (S and V scaled by 1/255, the products fused as an FMA
  rounds them), truncated in the vectorised body of a row and rounded in
  its scalar tail: the port follows both, with cv2's AVX2 block of 32
  pixels.

On uint8 both give the bytes of the sandbox's cv2 (OpenCV 5.0, with IPP
and AVX2 dispatch), which ``tests/test_torch_image.py`` holds.
"""

from __future__ import annotations

import random
from typing import Optional, Sequence

import numpy as np

from .codecs import decode_image

# --- cv2's arithmetic --------------------------------------------------------
_COEF_SCALE = 2048          # cv2 INTER_RESIZE_COEF_SCALE (11 bits)


def _taps(dst: int, src: int, dtype=np.float32):
    """Source index and weight of each destination pixel along one axis
    (cv2's ``(d + 0.5) * scale - 0.5``, the position rounded to
    ``dtype``)."""
    f = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(dtype)
    i = np.floor(f).astype(np.int64)
    return i, (f - i.astype(dtype)).astype(dtype)


def _x_taps(dst: int, src: int, dtype=np.float32):
    """Columns (and IPP's rows): a tap left of 0 or at/right of the last
    column is clamped to that column with weight 0 (cv2's
    ``xofs``/``alpha``)."""
    sx, fx = _taps(dst, src, dtype)
    edge = (sx < 0) | (sx >= src - 1)
    fx[edge] = 0.0
    sx = np.clip(sx, 0, src - 1)
    return sx, np.minimum(sx + 1, src - 1), dtype(1.0) - fx, fx


def _y_taps(dst: int, src: int):
    """Rows of cv2's fixed-point path: the weights are kept, the rows
    clipped (cv2's row buffer)."""
    sy, fy = _taps(dst, src)
    return (np.clip(sy, 0, src - 1), np.clip(sy + 1, 0, src - 1),
            np.float32(1.0) - fy, fy)


def resize_linear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR)``
    of an (h, w) or (h, w, c) uint8, float32 or float64 array."""
    if img.dtype not in (np.uint8, np.float32, np.float64):
        raise TypeError(f"resize_linear takes uint8, float32 or float64, "
                        f"not {img.dtype}")
    h, w = img.shape[:2]
    extra = (None,) * (img.ndim - 2)
    row = (None, slice(None)) + extra       # weights along the columns
    col = (slice(None), None) + extra       # weights along the rows
    if img.dtype == np.uint8:
        sx0, sx1, a0, a1 = _x_taps(width, w)
        sy0, sy1, b0, b1 = _y_taps(height, h)
        ia0, ia1, ib0, ib1 = (np.rint(v * np.float32(_COEF_SCALE)).astype(
            np.int64) for v in (a0, a1, b0, b1))
        src = img.astype(np.int64)
        rows = (src[:, sx0] * ia0[row] + src[:, sx1] * ia1[row]) >> 4
        out = (((ib0[col] * rows[sy0]) >> 16)
               + ((ib1[col] * rows[sy1]) >> 16) + 2) >> 2
        return np.clip(out, 0, 255).astype(np.uint8)
    # float: positions and weights in float64 and both axes clamped at the
    # edges, as cv2's IPP path takes them (within 2e-5 of it on 0-255)
    sx0, sx1, a0, a1 = _x_taps(width, w, np.float64)
    sy0, sy1, b0, b1 = _x_taps(height, h, np.float64)
    src = img.astype(np.float64)
    rows = src[:, sx0] * a0[row] + src[:, sx1] * a1[row]
    return (rows[sy0] * b0[col] + rows[sy1] * b1[col]).astype(img.dtype)


_HSV_SHIFT = 12
_I = np.arange(256, dtype=np.float64)
# cv2's division tables: saturate_cast<int> rounds to nearest
_SDIV = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / _I[1:])]
                       ).astype(np.int64)
_HDIV = np.concatenate([[0], np.rint((180 << _HSV_SHIFT) / (6.0 * _I[1:]))]
                       ).astype(np.int64)
# (b, g, r) entries of cv2's HSV2RGB sector table
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)`` of a uint8 RGB image: H in
    [0, 180), S and V in [0, 255]."""
    src = img.astype(np.int64)
    r, g, b = src[..., 0], src[..., 1], src[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def _fma32(a: np.ndarray, b: np.ndarray, c) -> np.ndarray:
    """a * b + c rounded once to float32 (the product of two float32 is
    exact in float64)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c
            ).astype(np.float32)


# cv2's HSV2RGB runs its vectorised body over blocks of 4 registers of
# float32 lanes (8 lanes: the AVX2 dispatch) at the start of each row, and
# its scalar code over the rest of the row
HSV2RGB_BLOCK = 32


def _hsv_to_bgr_vector(h, s, v):
    """cv2's vectorised HSV2RGB_b: S and V scaled by 1/255, the products
    fused, the result scaled by 255 and truncated."""
    f32 = np.float32
    h = h * f32(6.0 / 180.0)
    s = s * f32(1.0 / 255.0)
    v = v * f32(1.0 / 255.0)
    pre = np.trunc(h)
    h = (h - pre).astype(f32)
    sector = (pre - np.trunc(pre * f32(1.0 / 6.0)) * f32(6.0)).astype(
        np.int64)
    one = f32(1.0)
    tab = np.stack([v, v * (one - s), v * _fma32(-s, h, 1.0),
                    v * _fma32(-s, one - h, 1.0)], axis=-1).astype(f32)
    bgr = np.take_along_axis(tab, _SECTORS[sector], axis=-1) * f32(255.0)
    return np.trunc(bgr)


def _hsv_to_bgr_scalar(h, s, v):
    """cv2's scalar HSV2RGB_b: the vectorised body's arithmetic, but V as
    it is where S is 0 and rounding to nearest."""
    f32 = np.float32
    h = np.fmod(h * f32(6.0 / 180.0), f32(6.0))
    sector = np.floor(h).astype(np.int64)
    h = (h - sector).astype(f32)
    grey = s == 0
    s = s * f32(1.0 / 255.0)
    vs = v * f32(1.0 / 255.0)
    one = f32(1.0)
    tab = np.stack([vs, vs * (one - s), vs * _fma32(-s, h, 1.0),
                    vs * _fma32(-s, one - h, 1.0)], axis=-1).astype(f32)
    bgr = np.take_along_axis(tab, _SECTORS[sector], axis=-1) * f32(255.0)
    return np.rint(np.where(grey[..., None], v[..., None], bgr))


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)`` of a uint8 (h, w, 3) HSV
    image (H in [0, 180)): the first ``HSV2RGB_BLOCK``-multiple of each
    row's pixels as cv2's vectorised body computes them, the rest as its
    scalar code does."""
    h, s, v = (hsv[..., i].astype(np.float32) for i in range(3))
    split = hsv.shape[1] // HSV2RGB_BLOCK * HSV2RGB_BLOCK
    bgr = np.concatenate(
        [_hsv_to_bgr_vector(h[:, :split], s[:, :split], v[:, :split]),
         _hsv_to_bgr_scalar(h[:, split:], s[:, split:], v[:, split:])],
        axis=1)
    return np.clip(bgr, 0, 255).astype(np.uint8)[..., ::-1]


# --- transforms --------------------------------------------------------------
class Preprocessing:
    """Chainable transform: sample dict -> sample dict. Compose with ``->``
    semantics of the reference's ChainedPreprocessing via ``chain`` or ``|``."""

    def apply(self, sample: dict) -> dict:
        raise NotImplementedError

    def __call__(self, samples):
        if isinstance(samples, dict):
            return self.apply(samples)
        return [self.apply(s) for s in samples]

    def __or__(self, other: "Preprocessing") -> "ChainedPreprocessing":
        return ChainedPreprocessing([self, other])


class ChainedPreprocessing(Preprocessing):
    """(reference: pyzoo/zoo/feature/common.py ChainedPreprocessing)"""

    def __init__(self, transforms: Sequence[Preprocessing]):
        self.transforms = list(transforms)

    def apply(self, sample):
        for t in self.transforms:
            sample = t.apply(sample)
        return sample

    def __or__(self, other):
        return ChainedPreprocessing(self.transforms + [other])


class ImageTransform(Preprocessing):
    key = "image"

    def transform_image(self, img: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def apply(self, sample):
        out = dict(sample)
        out[self.key] = self.transform_image(sample[self.key])
        return out


class ImageResize(ImageTransform):
    """(reference: imagePreprocessing.py ImageResize)"""

    def __init__(self, resize_h: int, resize_w: int):
        self.h, self.w = resize_h, resize_w

    def transform_image(self, img):
        return resize_linear(img, self.w, self.h)


class ImageAspectScale(ImageTransform):
    """Resize preserving aspect so the short side == ``scale``
    (reference: ImageAspectScale)."""

    def __init__(self, scale: int, max_size: int = 1000):
        self.scale, self.max_size = scale, max_size

    def transform_image(self, img):
        h, w = img.shape[:2]
        ratio = self.scale / min(h, w)
        if round(ratio * max(h, w)) > self.max_size:
            ratio = self.max_size / max(h, w)
        return resize_linear(img, int(w * ratio), int(h * ratio))


class ImageCenterCrop(ImageTransform):
    """(reference: ImageCenterCrop)"""

    def __init__(self, crop_height: int, crop_width: int):
        self.ch, self.cw = crop_height, crop_width

    def transform_image(self, img):
        h, w = img.shape[:2]
        top = max((h - self.ch) // 2, 0)
        left = max((w - self.cw) // 2, 0)
        return img[top:top + self.ch, left:left + self.cw]


class ImageRandomCrop(ImageTransform):
    """(reference: ImageRandomCrop)"""

    def __init__(self, crop_height: int, crop_width: int,
                 rng: Optional[random.Random] = None):
        self.ch, self.cw = crop_height, crop_width
        self.rng = rng or random.Random()

    def transform_image(self, img):
        h, w = img.shape[:2]
        top = self.rng.randint(0, max(h - self.ch, 0))
        left = self.rng.randint(0, max(w - self.cw, 0))
        return img[top:top + self.ch, left:left + self.cw]


class ImageHFlip(ImageTransform):
    """(reference: ImageHFlip; random when p<1)"""

    def __init__(self, p: float = 0.5, rng: Optional[random.Random] = None):
        self.p = p
        self.rng = rng or random.Random()

    def transform_image(self, img):
        if self.rng.random() < self.p:
            return np.ascontiguousarray(img[:, ::-1])
        return img


class ImageChannelNormalize(ImageTransform):
    """Subtract per-channel mean, divide std (reference:
    ImageChannelNormalize(mean_r, mean_g, mean_b, std_r, std_g, std_b))."""

    def __init__(self, mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0):
        self.mean = np.array([mean_r, mean_g, mean_b], np.float32)
        self.std = np.array([std_r, std_g, std_b], np.float32)

    def transform_image(self, img):
        return (img.astype(np.float32) - self.mean) / self.std


class ImagePixelNormalizer(ImageTransform):
    """(reference: ImagePixelNormalizer — per-pixel mean image)"""

    def __init__(self, means: np.ndarray):
        self.means = np.asarray(means, np.float32)

    def transform_image(self, img):
        return img.astype(np.float32) - self.means


class ImageBytesToMat(ImageTransform):
    """Decode encoded image bytes (JPEG/PNG/BMP) to an HWC uint8 RGB array
    (reference: ImageBytesToMat) through ``codecs.decode_image``: a JPEG
    decodes on the card (``device`` None means ``cuda``; ``"cpu"`` raises
    for a JPEG). ``key_in`` selects the bytes field."""

    def __init__(self, key_in: str = "bytes", key_out: str = "image",
                 device=None):
        self.key_in, self.key_out = key_in, key_out
        self.device = device

    def apply(self, sample):
        out = dict(sample)
        out[self.key_out] = decode_image(sample[self.key_in], self.device)
        return out


class ImageBrightness(ImageTransform):
    """Add a random brightness delta in [delta_low, delta_high]
    (reference: ImageBrightness)."""

    def __init__(self, delta_low: float = -32.0, delta_high: float = 32.0,
                 rng: Optional[random.Random] = None):
        self.lo, self.hi = delta_low, delta_high
        self.rng = rng or random.Random()

    def transform_image(self, img):
        delta = self.rng.uniform(self.lo, self.hi)
        return np.clip(img.astype(np.float32) + delta, 0, 255)


class ImageSaturation(ImageTransform):
    """Scale saturation by a random factor (reference: ImageSaturation)."""

    def __init__(self, delta_low: float = 0.5, delta_high: float = 1.5,
                 rng: Optional[random.Random] = None):
        self.lo, self.hi = delta_low, delta_high
        self.rng = rng or random.Random()

    def transform_image(self, img):
        factor = self.rng.uniform(self.lo, self.hi)
        hsv = rgb_to_hsv(img.astype(np.uint8)).astype(np.float32)
        hsv[..., 1] = np.clip(hsv[..., 1] * factor, 0, 255)
        return hsv_to_rgb(hsv.astype(np.uint8))


class ImageHue(ImageTransform):
    """Shift hue by a random delta in degrees (reference: ImageHue)."""

    def __init__(self, delta_low: float = -18.0, delta_high: float = 18.0,
                 rng: Optional[random.Random] = None):
        self.lo, self.hi = delta_low, delta_high
        self.rng = rng or random.Random()

    def transform_image(self, img):
        delta = self.rng.uniform(self.lo, self.hi)
        hsv = rgb_to_hsv(img.astype(np.uint8)).astype(np.float32)
        hsv[..., 0] = (hsv[..., 0] + delta / 2.0) % 180.0  # H in [0,180)
        return hsv_to_rgb(hsv.astype(np.uint8))


class ImageColorJitter(Preprocessing):
    """Random brightness/saturation/hue in random order (reference:
    ImageColorJitter composes the three with shuffle)."""

    def __init__(self, brightness_prob: float = 0.5,
                 saturation_prob: float = 0.5, hue_prob: float = 0.5,
                 rng: Optional[random.Random] = None):
        rng = rng or random.Random()
        self.rng = rng
        self.stages = [
            ImageRandomPreprocessing(ImageBrightness(rng=rng),
                                     brightness_prob, rng=rng),
            ImageRandomPreprocessing(ImageSaturation(rng=rng),
                                     saturation_prob, rng=rng),
            ImageRandomPreprocessing(ImageHue(rng=rng), hue_prob, rng=rng),
        ]

    def apply(self, sample):
        order = list(self.stages)
        self.rng.shuffle(order)
        for t in order:
            sample = t.apply(sample)
        # dtype must not depend on which stage randomly ran last
        # (brightness emits float32, saturation/hue emit uint8)
        out = dict(sample)
        out["image"] = np.clip(np.round(
            sample["image"].astype(np.float32)), 0, 255).astype(np.uint8)
        return out


class ImageChannelOrder(ImageTransform):
    """RGB <-> BGR (reference: ImageChannelOrder)."""

    def transform_image(self, img):
        return np.ascontiguousarray(img[..., ::-1])


class PerImageNormalize(ImageTransform):
    """Zero-mean/unit-variance per image (reference: PerImageNormalize,
    tf.image.per_image_standardization semantics: std floored at
    1/sqrt(num_pixels))."""

    def transform_image(self, img):
        img = img.astype(np.float32)
        std = max(float(img.std()), 1.0 / float(np.sqrt(img.size)))
        return (img - img.mean()) / std


class ImageRandomAspectScale(ImageTransform):
    """Aspect-preserving resize to a randomly chosen short side
    (reference: ImageRandomAspectScale(min_sizes))."""

    def __init__(self, scales: Sequence[int], max_size: int = 1000,
                 rng: Optional[random.Random] = None):
        self.scales = list(scales)
        self.max_size = max_size
        self.rng = rng or random.Random()

    def transform_image(self, img):
        return ImageAspectScale(self.rng.choice(self.scales),
                                self.max_size).transform_image(img)


class ImageFixedCrop(ImageTransform):
    """Crop a fixed region; normalized coords when ``normalized``
    (reference: ImageFixedCrop(x1, y1, x2, y2, normalized))."""

    def __init__(self, x1: float, y1: float, x2: float, y2: float,
                 normalized: bool = True):
        self.box = (x1, y1, x2, y2)
        self.normalized = normalized

    def transform_image(self, img):
        h, w = img.shape[:2]
        x1, y1, x2, y2 = self.box
        if self.normalized:
            x1, x2 = x1 * w, x2 * w
            y1, y2 = y1 * h, y2 * h
        x1, y1 = max(int(round(x1)), 0), max(int(round(y1)), 0)
        x2, y2 = min(int(round(x2)), w), min(int(round(y2)), h)
        return img[y1:y2, x1:x2]


class ImageExpand(ImageTransform):
    """Pad the image into a larger random canvas (SSD-style zoom-out;
    reference: ImageExpand(means_r/g/b, max_expand_ratio))."""

    def __init__(self, means=(123, 117, 104), max_expand_ratio: float = 4.0,
                 rng: Optional[random.Random] = None):
        self.means = np.asarray(means, np.float32)
        self.max_ratio = max_expand_ratio
        self.rng = rng or random.Random()

    def transform_image(self, img):
        h, w = img.shape[:2]
        ratio = self.rng.uniform(1.0, self.max_ratio)
        nh, nw = int(h * ratio), int(w * ratio)
        top = self.rng.randint(0, nh - h)
        left = self.rng.randint(0, nw - w)
        canvas = np.empty((nh, nw, img.shape[2]), img.dtype)
        canvas[...] = self.means.astype(img.dtype)
        canvas[top:top + h, left:left + w] = img
        return canvas


class ImageFiller(ImageTransform):
    """Fill a region with a constant value (reference: ImageFiller —
    cutout-style occlusion)."""

    def __init__(self, x1: float, y1: float, x2: float, y2: float,
                 value: int = 255, normalized: bool = True):
        self.box = (x1, y1, x2, y2)
        self.value = value
        self.normalized = normalized

    def transform_image(self, img):
        h, w = img.shape[:2]
        x1, y1, x2, y2 = self.box
        if self.normalized:
            x1, x2 = x1 * w, x2 * w
            y1, y2 = y1 * h, y2 * h
        # clamp + round like ImageFixedCrop: negative/out-of-range coords
        # must fill the clipped region, not resolve to an empty slice
        x1, y1 = max(int(round(x1)), 0), max(int(round(y1)), 0)
        x2, y2 = min(int(round(x2)), w), min(int(round(y2)), h)
        out = img.copy()
        out[y1:y2, x1:x2] = self.value
        return out


class ImageMirror(ImageTransform):
    """Unconditional horizontal mirror (reference: ImageMirror)."""

    def transform_image(self, img):
        return np.ascontiguousarray(img[:, ::-1])


class ImageRandomPreprocessing(Preprocessing):
    """Apply inner transform with probability p (reference:
    ImageRandomPreprocessing)."""

    def __init__(self, preprocessing: Preprocessing, prob: float,
                 rng: Optional[random.Random] = None):
        self.inner = preprocessing
        self.prob = prob
        self.rng = rng or random.Random()

    def apply(self, sample):
        if self.rng.random() < self.prob:
            return self.inner.apply(sample)
        return sample


class ImageMatToTensor(ImageTransform):
    """Layout/dtype finalization. The default is NHWC float32 (the
    reference's MatToTensor emits CHW for BigDL; pass format='NCHW' for
    that)."""

    def __init__(self, to_chw: bool = False, format: str = "NHWC"):
        self.to_chw = to_chw or format.upper() == "NCHW"

    def transform_image(self, img):
        img = img.astype(np.float32)
        if self.to_chw:
            img = np.transpose(img, (2, 0, 1))
        return img


class ImageSetToSample(Preprocessing):
    """Pick feature/label keys into the estimator's {'x','y'} contract
    (reference: ImageSetToSample(input_keys, target_keys))."""

    def __init__(self, input_keys=("image",), target_keys=None):
        self.input_keys = tuple(input_keys)
        self.target_keys = tuple(target_keys) if target_keys else None

    def apply(self, sample):
        out = {"x": tuple(sample[k] for k in self.input_keys)}
        if self.target_keys:
            out["y"] = tuple(sample[k] for k in self.target_keys)
        return out


def imagenet_train_transforms(image_size: int = 224,
                              seed: Optional[int] = None
                              ) -> ChainedPreprocessing:
    """The reference ResNet-50 train pipeline (resnet-50-imagenet.py:44-230:
    random-resized-crop + flip + normalize), as host transforms."""
    rng = random.Random(seed)
    return ChainedPreprocessing([
        ImageAspectScale(256),
        ImageRandomCrop(image_size, image_size, rng=rng),
        ImageHFlip(0.5, rng=rng),
        ImageChannelNormalize(123.68, 116.779, 103.939,
                              58.393, 57.12, 57.375),
    ])


def imagenet_val_transforms(image_size: int = 224) -> ChainedPreprocessing:
    return ChainedPreprocessing([
        ImageAspectScale(256),
        ImageCenterCrop(image_size, image_size),
        ImageChannelNormalize(123.68, 116.779, 103.939,
                              58.393, 57.12, 57.375),
    ])
