"""Writes the image fixtures under tests/data/images/ from seeded numpy
pictures (smooth gradients with discs, bars and edges, so the files stay
small), with cv2 and PIL:

* ``classes/<class>/``: the files ``ImageSet.read(..., with_label=True)``
  reads, two classes ("discs", "bars"):
  - 8 JPEGs, 200-480 px a side, odd sizes among them: 4:2:0, 4:2:2 and
    4:4:4 chroma, greyscale, progressive, restart intervals, and one file
    written by PIL with EXIF orientation 6;
  - PNGs of every colour type (grey, RGB, palette, grey + alpha, RGBA), at
    8 and 16 bits, a 1-bit grey one, one Adam7-interlaced and one with
    each filter type, the last two written by the encoder below (cv2 and
    PIL write neither);
  - 24-bit, 32-bit and 8-bit palette BMPs (and a 1-bit one).
* ``expected/<file>.png``: ``cv2.imread(file)`` of each of them, written
  back by cv2 as an 8-bit RGB PNG (the port's exact PNG decoder reads it
  on the card, which has no cv2);
* ``expected/<jpeg>.q30.png``: for each JPEG, cv2's decode of the same
  picture encoded at quality 30: the control that the card's nvJPEG
  limits must miss (``chip_smoke.py``, ``image_codecs``);
* ``manifest.json``: each file's format, what it covers and its sha256.

Run it from the root of the repository (it needs cv2 and PIL, which the
card's machine lacks):

    python scripts/make_image_fixtures.py [--check]

``--check`` writes into a temporary directory and compares every byte with
the committed files.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import struct
import sys
import tempfile
import zlib

import cv2
import numpy as np
from PIL import Image

ROOT = os.path.join("tests", "data", "images")
SEED = 16


def picture(h, w, kind, seed):
    """A smooth RGB uint8 picture: two crossing gradients, then three discs
    ("discs") or bars ("bars") of flat colour with hard edges."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    c0, c1 = rng.uniform(30, 225, 3), rng.uniform(30, 225, 3)
    t = (xx / max(w - 1, 1))[..., None]
    s = (yy / max(h - 1, 1))[..., None]
    img = c0 * (1 - t) + c1 * t + 40.0 * np.sin(3.0 * s)
    for _ in range(3):
        colour = rng.uniform(0, 255, 3)
        if kind == "discs":
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            r = rng.uniform(0.1, 0.3) * min(h, w)
            mask = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        else:
            x0 = rng.uniform(0, w * 0.8)
            mask = (xx > x0) & (xx < x0 + rng.uniform(0.05, 0.2) * w)
        img[mask] = colour
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _filter_rows(lines: np.ndarray, bpp: int, ftypes) -> bytes:
    """PNG filters: row y gets ftypes[y % len(ftypes)]."""
    out = bytearray()
    prev = np.zeros(lines.shape[1], np.int64)
    for y, row in enumerate(lines.astype(np.int64)):
        ft = ftypes[y % len(ftypes)]
        a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        b = prev
        if ft == 0:
            pred = np.zeros_like(row)
        elif ft == 1:
            pred = a
        elif ft == 2:
            pred = b
        elif ft == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
        out.append(ft)
        out += ((row - pred) & 255).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


def encode_png(img: np.ndarray, ftypes=(0, 1, 2, 3, 4), interlace=False
               ) -> bytes:
    """An 8-bit RGB PNG with the given row filters, optionally Adam7."""
    h, w, _ = img.shape
    passes = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
              (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1)) if interlace \
        else ((0, 0, 1, 1),)
    raw = b""
    for y0, x0, dy, dx in passes:
        sub = img[y0::dy, x0::dx]
        if sub.size:
            raw += _filter_rows(sub.reshape(sub.shape[0], -1), 3, ftypes)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, int(interlace))
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, 9)) + _chunk(b"IEND", b""))


def _cv2_jpeg(img, **params):
    flags = [cv2.IMWRITE_JPEG_QUALITY, params.pop("quality", 90)]
    for key, value in params.items():
        flags += [getattr(cv2, key), value]
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(img[..., ::-1]),
                           flags)
    assert ok
    return buf.tobytes()


def _cv2_png(img, **params):
    flags = [cv2.IMWRITE_PNG_COMPRESSION, 9]
    for key, value in params.items():
        flags += [getattr(cv2, key), value]
    bgr = img[..., [2, 1, 0] + ([3] if img.shape[-1] == 4 else [])] \
        if img.ndim == 3 else img
    ok, buf = cv2.imencode(".png", np.ascontiguousarray(bgr), flags)
    assert ok
    return buf.tobytes()


def _cv2_bmp(img):
    bgr = img[..., [2, 1, 0] + ([3] if img.shape[-1] == 4 else [])] \
        if img.ndim == 3 else img
    ok, buf = cv2.imencode(".bmp", np.ascontiguousarray(bgr))
    assert ok
    return buf.tobytes()


def _pil(img, fmt, mode=None, **kw):
    im = Image.fromarray(img)
    if mode == "P":
        im = im.quantize(colors=64, method=Image.Quantize.MEDIANCUT)
    elif mode:
        im = im.convert(mode)
    out = io.BytesIO()
    im.save(out, format=fmt, **kw)
    return out.getvalue()


def _exif_orientation_6() -> bytes:
    exif = Image.Exif()
    exif[0x0112] = 6
    return exif.tobytes()


def fixtures():
    """{relative path: (bytes, covers, picture or None)} in a fixed order;
    the picture is the JPEG's source, for its quality-30 control."""
    out = {}
    j = 0

    def add(cls, name, data, covers, pic=None):
        out[f"classes/{cls}/{name}"] = (data, covers, pic)

    def pic(h, w, cls):
        nonlocal j
        j += 1
        return picture(h, w, cls, SEED * 100 + j)

    p = pic(320, 480, "discs")
    add("discs", "j420.jpg", _cv2_jpeg(
        p, IMWRITE_JPEG_SAMPLING_FACTOR=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
        "JPEG baseline 4:2:0", p)
    p = pic(251, 333, "bars")
    add("bars", "j422_odd.jpg", _cv2_jpeg(
        p, IMWRITE_JPEG_SAMPLING_FACTOR=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422),
        "JPEG baseline 4:2:2, odd sizes", p)
    p = pic(211, 257, "discs")
    add("discs", "j444_odd.jpg", _cv2_jpeg(
        p, IMWRITE_JPEG_SAMPLING_FACTOR=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
        "JPEG baseline 4:4:4, odd sizes", p)
    p = pic(300, 200, "bars")
    grey = cv2.cvtColor(p, cv2.COLOR_RGB2GRAY)
    ok, buf = cv2.imencode(".jpg", grey, [cv2.IMWRITE_JPEG_QUALITY, 90])
    add("bars", "grey.jpg", buf.tobytes(), "JPEG greyscale (1 component)",
        np.repeat(grey[..., None], 3, -1))
    p = pic(299, 401, "discs")
    add("discs", "progressive.jpg", _cv2_jpeg(
        p, IMWRITE_JPEG_PROGRESSIVE=1), "JPEG progressive 4:2:0", p)
    p = pic(240, 320, "bars")
    add("bars", "restart.jpg", _cv2_jpeg(
        p, IMWRITE_JPEG_RST_INTERVAL=4), "JPEG restart interval 4", p)
    p = pic(200, 240, "discs")
    # stored sideways with orientation 6 (rotate 90 clockwise to view):
    # the viewed picture is p
    add("discs", "exif6.jpg", _pil(np.ascontiguousarray(np.rot90(p, 1)),
                                   "JPEG", quality=90,
                                   exif=_exif_orientation_6()),
        "JPEG by PIL with EXIF orientation 6", p)
    p = pic(479, 203, "bars")
    add("bars", "j420_odd.jpg", _cv2_jpeg(p), "JPEG 4:2:0, odd sizes", p)

    s = pic(72, 96, "discs")
    add("discs", "rgb8.png", _cv2_png(s), "PNG RGB 8-bit (cv2)")
    add("bars", "rgb16.png", _cv2_png(s.astype(np.uint16) * 256 + 200),
        "PNG RGB 16-bit (cv2)")
    add("discs", "rgba8.png", _cv2_png(np.dstack(
        [s, np.full(s.shape[:2], 128, np.uint8)])), "PNG RGBA 8-bit (cv2)")
    add("bars", "rgba16.png", _cv2_png(np.dstack(
        [s, np.full(s.shape[:2], 77, np.uint8)]).astype(np.uint16) * 257),
        "PNG RGBA 16-bit (cv2)")
    g = cv2.cvtColor(s, cv2.COLOR_RGB2GRAY)
    add("discs", "grey8.png", _cv2_png(g), "PNG grey 8-bit (cv2)")
    add("bars", "grey16.png", _cv2_png(g.astype(np.uint16) * 251),
        "PNG grey 16-bit (cv2)")
    add("discs", "grey1.png", _pil(g, "PNG", mode="1"),
        "PNG grey 1-bit (PIL)")
    add("bars", "grey_alpha.png", _pil(np.dstack([g, g // 2]), "PNG"),
        "PNG grey + alpha 8-bit (PIL)")
    add("discs", "palette.png", _pil(s, "PNG", mode="P"),
        "PNG palette 8-bit (PIL)")
    s2 = pic(53, 67, "bars")
    add("bars", "adam7.png", encode_png(s2, interlace=True),
        "PNG Adam7, rows cycling the five filters")
    for ft, name in enumerate(("none", "sub", "up", "average", "paeth")):
        add("discs" if ft % 2 else "bars", f"filter_{name}.png",
            encode_png(s2, ftypes=(ft,)), f"PNG every row filter {ft}")

    b = pic(61, 83, "discs")
    add("discs", "bgr24.bmp", _cv2_bmp(b), "BMP 24-bit (cv2)")
    add("bars", "bgra32.bmp", _cv2_bmp(np.dstack(
        [b, np.full(b.shape[:2], 200, np.uint8)])), "BMP 32-bit (cv2)")
    add("discs", "grey8.bmp", _cv2_bmp(cv2.cvtColor(b, cv2.COLOR_RGB2GRAY)),
        "BMP 8-bit grey palette (cv2)")
    add("bars", "palette8.bmp", _pil(b, "BMP", mode="P"),
        "BMP 8-bit colour palette (PIL)")
    add("discs", "mono1.bmp", _pil(b, "BMP", mode="1"),
        "BMP 1-bit palette (PIL)")
    return out


def write(root: str) -> None:
    manifest = {}
    for rel, (data, covers, pic) in fixtures().items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
        entry = {"covers": covers, "sha256": hashlib.sha256(data).hexdigest()}
        expect = cv2.imread(path, cv2.IMREAD_COLOR)
        name = os.path.basename(rel)
        os.makedirs(os.path.join(root, "expected"), exist_ok=True)
        ok, buf = cv2.imencode(".png", expect,
                               [cv2.IMWRITE_PNG_COMPRESSION, 9])
        assert ok
        with open(os.path.join(root, "expected", name + ".png"), "wb") as f:
            f.write(buf.tobytes())
        entry["expected"] = f"expected/{name}.png"
        if pic is not None:
            control = cv2.imdecode(np.frombuffer(_cv2_jpeg(
                pic, quality=30), np.uint8), cv2.IMREAD_COLOR)
            ok, buf = cv2.imencode(".png", control,
                                   [cv2.IMWRITE_PNG_COMPRESSION, 9])
            with open(os.path.join(root, "expected", name + ".q30.png"),
                      "wb") as f:
                f.write(buf.tobytes())
            entry["control_q30"] = f"expected/{name}.q30.png"
        manifest[rel] = entry
    with open(os.path.join(root, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="write into a temporary directory and compare "
                         "with the committed files")
    args = ap.parse_args(argv)
    if not args.check:
        write(ROOT)
        total = sum(os.path.getsize(os.path.join(ROOT, p))
                    for p in _files(ROOT))
        print(f"wrote {len(_files(ROOT))} files, {total} bytes, to {ROOT}")
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        write(tmp)
        new, old = _files(tmp), _files(ROOT)
        differ = [p for p in new if p not in old or open(
            os.path.join(tmp, p), "rb").read() != open(
            os.path.join(ROOT, p), "rb").read()]
        differ += [p for p in old if p not in new]
    print(json.dumps({"files": len(new), "differ": differ}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
