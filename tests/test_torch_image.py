"""The port's image inputs (analytics_zoo_tpu_torch/feature/image,
feature/image3d, pipeline/nnframes/nn_image_reader.py) against cv2, PIL
and the JAX package, on the CPU.

* PNG and BMP decode bit for bit as ``cv2.imread(IMREAD_COLOR)`` +
  ``BGR2RGB``: every fixture under tests/data/images (each colour type, 1,
  8 and 16 bits, Adam7, each filter; 24/32-bit and palette BMPs) and
  seeded pictures written by cv2 with each of its PNG filter settings.
* A JPEG with ``device="cpu"`` raises (it decodes on the card only, in
  ``chip_smoke.py``); the marker parser names CMYK, YCCK and
  arithmetic-coded files; the EXIF orientation is applied as cv2 applies
  it, for all eight values.
* Each of the 26 names ``feature.image`` exports, against JAX's on the
  same sample and ``random.Random(seed)``: bit for bit where JAX calls no
  cv2; where it does, uint8 output within 1 level with the exact share
  stated (``EXACT_SHARE``), float32 within 1e-4 on the 0-255 scale.
* ``ImageSet.read`` on JAX's own PNG layout (tests/test_image.py): same
  images, labels, order and ``to_dataset`` arrays; the image3d transforms
  bit for bit; ``NNImageReader`` with and without a resize against JAX's
  (PIL's bicubic within 1 level).
"""

import glob
import io
import json
import os
import random

import cv2
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.feature import image as jimage
from analytics_zoo_tpu.feature import image3d as jimage3d
from analytics_zoo_tpu_torch.feature import image as timage
from analytics_zoo_tpu_torch.feature import image3d as timage3d
from analytics_zoo_tpu_torch.feature.image import codecs
from analytics_zoo_tpu_torch.feature.image import preprocessing as tpre

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "images")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
LOSSLESS = sorted(k for k in MANIFEST if not k.endswith(".jpg"))
JPEGS = sorted(k for k in MANIFEST if k.endswith(".jpg"))

TOL_FLOAT = 1e-4            # float32 outputs of cv2-backed transforms
# share of uint8 values equal to JAX's (cv2's), by transform, as read on
# these inputs: both are cv2's arithmetic, HSV2RGB's vectorised body and
# scalar tail included (tpre.HSV2RGB_BLOCK)
EXACT_SHARE = {"resize": 1.0, "hsv": 1.0}


def _cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def _read(rel):
    with open(os.path.join(FIXTURES, rel), "rb") as f:
        return f.read()


# --- codecs ------------------------------------------------------------------
@pytest.mark.parametrize("rel", LOSSLESS)
def test_fixture_decodes_like_cv2(rel):
    got = codecs.decode_image(_read(rel), "cpu")
    np.testing.assert_array_equal(got, _cv2_rgb(os.path.join(FIXTURES, rel)))
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    # the stored array the card holds its decode to is cv2's too
    np.testing.assert_array_equal(
        codecs.decode_png(_read(MANIFEST[rel]["expected"])), got)


def test_fixture_manifest_matches_files():
    import hashlib
    listed = set(MANIFEST)
    on_disk = {os.path.relpath(p, FIXTURES) for p in glob.glob(
        os.path.join(FIXTURES, "classes", "*", "*"))}
    assert listed == on_disk
    for rel, entry in MANIFEST.items():
        assert hashlib.sha256(_read(rel)).hexdigest() == entry["sha256"]
    total = sum(os.path.getsize(p) for p in glob.glob(
        os.path.join(FIXTURES, "**", "*"), recursive=True)
        if os.path.isfile(p))
    assert total < 2 * 2 ** 20


def _picture(h, w, seed, channels=3, dtype=np.uint8):
    rng = np.random.RandomState(seed)
    if dtype == np.uint16:
        return rng.randint(0, 65536, (h, w, channels)).astype(np.uint16)
    smooth = np.linspace(0, 255, h * w * channels).reshape(h, w, channels)
    noise = rng.randint(0, 64, (h, w, channels))
    return ((smooth + noise) % 256).astype(np.uint8)


@pytest.mark.parametrize("flt", ["NONE", "SUB", "UP", "AVG", "PAETH",
                                 "FAST_FILTERS", "ALL_FILTERS"])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_cv2_png_filters_decode_exactly(flt, channels):
    img = _picture(23, 37, seed=channels, channels=channels)
    ok, buf = cv2.imencode(".png", img, [
        cv2.IMWRITE_PNG_FILTER, getattr(cv2, f"IMWRITE_PNG_FILTER_{flt}")
        if flt in ("NONE", "SUB", "UP", "AVG", "PAETH")
        else getattr(cv2, f"IMWRITE_PNG_{flt}")])
    assert ok
    want = cv2.cvtColor(cv2.imdecode(buf, cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(codecs.decode_png(buf.tobytes()), want)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_cv2_png_16bit_and_bmp_decode_exactly(channels):
    img16 = _picture(19, 29, seed=7, channels=channels, dtype=np.uint16)
    ok, buf = cv2.imencode(".png", img16)
    want = cv2.cvtColor(cv2.imdecode(buf, cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(codecs.decode_png(buf.tobytes()), want)
    img8 = _picture(19, 29, seed=8, channels=channels)
    ok, buf = cv2.imencode(".bmp", img8)
    want = cv2.cvtColor(cv2.imdecode(buf, cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(codecs.decode_image(buf.tobytes()), want)


def test_jpeg_needs_the_card():
    data = _read(JPEGS[0])
    with pytest.raises(NotImplementedError, match="card"):
        codecs.decode_image(data, "cpu")
    with pytest.raises(NotImplementedError, match="card"):
        tpre.ImageBytesToMat(device="cpu").apply({"bytes": data})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            codecs.decode_image(data)


def _jpeg_with(img, **kw):
    from PIL import Image
    out = io.BytesIO()
    Image.fromarray(img).save(out, format="JPEG", **kw)
    return out.getvalue()


def test_jpeg_markers_name_what_is_refused():
    from PIL import Image
    img = _picture(16, 24, seed=3)
    info = codecs.jpeg_info(_jpeg_with(img))
    assert (info.width, info.height, info.components, info.frame,
            info.orientation) == (24, 16, 3, "baseline", 1)
    assert codecs.jpeg_info(_jpeg_with(img, progressive=True)).frame == \
        "progressive"
    out = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(out, format="JPEG")
    with pytest.raises(ValueError, match="CMYK"):
        codecs.jpeg_info(out.getvalue())
    data = bytearray(_jpeg_with(img))
    sof = data.index(b"\xff\xc0")
    data[sof + 1] = 0xC9                    # arithmetic-coded sequential
    with pytest.raises(ValueError, match="arithmetic"):
        codecs.decode_image(bytes(data), "cpu")
    # an Adobe segment with transform 2 on a 4-component frame is YCCK
    data = bytearray(out.getvalue())
    adobe = data.index(b"Adobe")
    data[adobe + 11] = 2
    with pytest.raises(ValueError, match="YCCK"):
        codecs.jpeg_info(bytes(data))
    with pytest.raises(ValueError, match="not a PNG, JPEG or BMP"):
        codecs.decode_image(b"GIF89a....", "cpu")


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_as_cv2(orientation, tmp_path):
    from PIL import Image
    img = _picture(20, 32, seed=orientation)
    exif = Image.Exif()
    exif[0x0112] = orientation
    path = str(tmp_path / "o.jpg")
    with open(path, "wb") as f:
        f.write(_jpeg_with(img, exif=exif.tobytes(), quality=95))
    stored = cv2.imread(path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    info = codecs.jpeg_info(_read(path))
    assert info.orientation == orientation
    np.testing.assert_array_equal(
        codecs.apply_orientation(stored, info.orientation),
        cv2.imread(path, cv2.IMREAD_COLOR))


# --- preprocessing: the 26 names against JAX ---------------------------------
def _sample(h=37, w=53, seed=0):
    rng = np.random.RandomState(seed)
    return {"image": rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
            "label": np.int32(1)}


def _both(name, *args, seeded=False, **kwargs):
    """The JAX and the port's transform, each with its own
    random.Random(seed) when ``seeded``."""
    out = []
    for mod in (jimage, timage):
        kw = dict(kwargs)
        if seeded:
            kw["rng"] = random.Random(5)
        out.append(getattr(mod, name)(*args, **kw))
    return out


def _share_exact(got, want):
    return float((np.asarray(got) == np.asarray(want)).mean())


def _hold(got, want, kind):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if want.dtype == np.uint8:
        d = np.abs(got.astype(np.int64) - want.astype(np.int64))
        assert d.max() <= 1, d.max()
        assert _share_exact(got, want) >= EXACT_SHARE[kind]
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_FLOAT)


EXACT_TRANSFORMS = [
    ("ImageCenterCrop", (20, 30), {}, False),
    ("ImageRandomCrop", (20, 30), {}, True),
    ("ImageFixedCrop", (0.1, 0.2, 0.7, 0.9), {}, False),
    ("ImageFixedCrop", (3, 4, 40, 30), {"normalized": False}, False),
    ("ImageHFlip", (), {}, True),
    ("ImageMirror", (), {}, False),
    ("ImageChannelNormalize", (123.0, 117.0, 104.0, 58.0, 57.0, 57.5), {},
     False),
    ("ImagePixelNormalizer", (np.full((37, 53, 3), 100.5, np.float32),), {},
     False),
    ("PerImageNormalize", (), {}, False),
    ("ImageBrightness", (), {}, True),
    ("ImageChannelOrder", (), {}, False),
    ("ImageExpand", (), {"max_expand_ratio": 2.0}, True),
    ("ImageFiller", (-0.1, 0.2, 0.6, 1.3), {"value": 7}, False),
    ("ImageMatToTensor", (), {}, False),
    ("ImageMatToTensor", (), {"format": "NCHW"}, False),
    ("ImageSetToSample", (), {"target_keys": ("label",)}, False),
]


@pytest.mark.parametrize("name,args,kwargs,seeded", EXACT_TRANSFORMS)
def test_transform_bit_for_bit(name, args, kwargs, seeded):
    jt, tt = _both(name, *args, seeded=seeded, **kwargs)
    for seed in range(3):
        s = _sample(seed=seed)
        want, got = jt.apply(dict(s)), tt.apply(dict(s))
        assert set(want) == set(got)
        for key in want:
            w, g = want[key], got[key]
            if isinstance(w, tuple):
                for a, b in zip(w, g):
                    np.testing.assert_array_equal(b, a)
            else:
                assert np.asarray(g).dtype == np.asarray(w).dtype
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("size", [(32, 32), (17, 90), (74, 106), (18, 26),
                                  (5, 3), (37, 53)])
def test_resize_as_cv2(dtype, size):
    jt, tt = _both("ImageResize", *size)
    s = _sample(seed=size[0])
    s["image"] = s["image"].astype(dtype)
    _hold(tt.apply(s)["image"], jt.apply(s)["image"], "resize")
    # a grey (h, w) image too
    grey = s["image"][..., 0]
    _hold(tpre.resize_linear(grey, size[1], size[0]),
          cv2.resize(grey, (size[1], size[0]),
                     interpolation=cv2.INTER_LINEAR), "resize")


@pytest.mark.parametrize("name,args,kwargs,seeded", [
    ("ImageAspectScale", (24,), {}, False),
    ("ImageAspectScale", (64,), {"max_size": 80}, False),
    ("ImageRandomAspectScale", ([20, 30, 45],), {}, True),
    ("ImageSaturation", (), {}, True),
    ("ImageHue", (), {}, True),
    ("ImageColorJitter", (), {"brightness_prob": 0.7,
                              "saturation_prob": 0.7, "hue_prob": 0.7},
     True)])
def test_cv2_backed_transform_within_a_level(name, args, kwargs, seeded):
    jt, tt = _both(name, *args, seeded=seeded, **kwargs)
    kind = "resize" if "Scale" in name else "hsv"
    for seed in range(4):
        s = _sample(seed=seed)
        _hold(tt.apply(dict(s))["image"], jt.apply(dict(s))["image"], kind)


@pytest.mark.parametrize("width", [256, 53])
def test_hsv_conversions_over_the_cube(width):
    """cv2's RGB2HSV and HSV2RGB on a grid of the 8-bit cube, in rows of
    ``width`` pixels: 256 runs cv2's vectorised body alone, 53 its scalar
    tail too (``tpre.HSV2RGB_BLOCK``)."""
    rgb = np.stack(np.meshgrid(np.arange(0, 256, 3), np.arange(256),
                               np.arange(0, 256, 5), indexing="ij"),
                   -1).reshape(-1, 3)
    rgb = rgb[:len(rgb) // width * width].reshape(-1, width, 3).astype(
        np.uint8)
    np.testing.assert_array_equal(tpre.rgb_to_hsv(rgb),
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))
    hsv = np.stack(np.meshgrid(np.arange(180), np.arange(0, 256, 3),
                               np.arange(256), indexing="ij"),
                   -1).reshape(-1, 3)
    hsv = hsv[:len(hsv) // width * width].reshape(-1, width, 3).astype(
        np.uint8)
    np.testing.assert_array_equal(tpre.hsv_to_rgb(hsv),
                                  cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def test_bytes_to_mat_and_chains():
    img = _sample()["image"]
    ok, buf = cv2.imencode(".png", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    jt, tt = _both("ImageBytesToMat")
    np.testing.assert_array_equal(
        tt.apply({"bytes": buf.tobytes()})["image"],
        jt.apply({"bytes": buf.tobytes()})["image"])
    j_chain = jimage.ImageResize(30, 40) | jimage.ImageCenterCrop(24, 24) | \
        jimage.ImageChannelNormalize(127.5, 127.5, 127.5, 127.5, 127.5,
                                     127.5)
    t_chain = timage.ImageResize(30, 40) | timage.ImageCenterCrop(24, 24) | \
        timage.ImageChannelNormalize(127.5, 127.5, 127.5, 127.5, 127.5,
                                     127.5)
    assert isinstance(t_chain, timage.ChainedPreprocessing)
    s = _sample()
    np.testing.assert_array_equal(t_chain(s)["image"], j_chain(s)["image"])
    np.testing.assert_array_equal(
        timage.ChainedPreprocessing([timage.ImageMirror()])([s])[0]["image"],
        jimage.ChainedPreprocessing([jimage.ImageMirror()])([s])[0]["image"])
    rp = [mod.ImageRandomPreprocessing(mod.ImageMirror(), 0.5,
                                       rng=random.Random(2))
          for mod in (jimage, timage)]
    for seed in range(6):
        s = _sample(seed=seed)
        np.testing.assert_array_equal(rp[1].apply(s)["image"],
                                      rp[0].apply(s)["image"])
    with pytest.raises(NotImplementedError):
        timage.Preprocessing().apply(s)


@pytest.mark.parametrize("train", [False, True])
def test_imagenet_transforms(train):
    img = np.random.RandomState(1).randint(0, 255, (300, 400, 3), np.uint8)
    if train:
        jt = jimage.imagenet_train_transforms(64, seed=3)
        tt = timage.imagenet_train_transforms(64, seed=3)
    else:
        jt = jimage.imagenet_val_transforms(64)
        tt = timage.imagenet_val_transforms(64)
    for _ in range(2):
        _hold(tt.apply({"image": img})["image"],
              jt.apply({"image": img})["image"], "resize")


def test_exports_are_jax_names():
    assert timage.__all__ == jimage.__all__
    assert len(timage.__all__) == 27         # ImageSet + the 26 transforms


# --- ImageSet ------------------------------------------------------------------
@pytest.fixture
def png_dir(tmp_path):
    """JAX's own fixture layout (tests/test_image.py)."""
    rng = np.random.RandomState(0)
    for cls in ("cat", "dog"):
        d = tmp_path / cls
        d.mkdir()
        for i in range(3):
            img = rng.randint(0, 255, (40, 50, 3), dtype=np.uint8)
            cv2.imwrite(str(d / f"{i}.png"), img)
    return str(tmp_path)


@pytest.mark.parametrize("one_based", [True, False])
def test_imageset_read_as_jax(orca_context, png_dir, one_based):
    jset = jimage.ImageSet.read(png_dir, with_label=True,
                                one_based_label=one_based)
    tset = timage.ImageSet.read(png_dir, with_label=True,
                                one_based_label=one_based, device="cpu")
    assert tset.label_map == jset.label_map
    assert tset.get_label() == jset.get_label()
    for a, b in zip(tset.get_image(), jset.get_image()):
        np.testing.assert_array_equal(a, b)
    assert [s["uri"] for p in tset.shards.collect() for s in p] == \
        [s["uri"] for p in jset.shards.collect() for s in p]
    pipe = [mod.ImageResize(32, 32) | mod.ImageCenterCrop(28, 28) |
            mod.ImageChannelNormalize(127.5, 127.5, 127.5, 127.5, 127.5,
                                      127.5) for mod in (jimage, timage)]
    jds = jset.transform(pipe[0]).to_dataset().collect()
    tds = tset.transform(pipe[1]).to_dataset().collect()
    assert len(jds) == len(tds)
    for a, b in zip(tds, jds):
        np.testing.assert_array_equal(a["x"][0], b["x"][0])
        np.testing.assert_array_equal(a["y"][0], b["y"][0])


def test_imageset_from_arrays_and_device_rule(monkeypatch, png_dir):
    imgs = np.random.RandomState(2).randint(0, 255, (5, 8, 8, 3), np.uint8)
    labels = np.arange(5)
    t = timage.ImageSet.from_arrays(imgs, labels, num_partitions=2)
    j = jimage.ImageSet.from_arrays(imgs, labels, num_partitions=2)
    assert t.get_label() == j.get_label()
    tds, jds = t.to_dataset().collect(), j.to_dataset().collect()
    for a, b in zip(tds, jds):
        np.testing.assert_array_equal(a["x"][0], b["x"][0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        timage.ImageSet.read(png_dir)
    with pytest.raises(NotImplementedError, match="card"):
        timage.ImageSet.read(os.path.join(FIXTURES, "classes"),
                             device="cpu")


def test_imageset_reads_the_lossless_fixtures():
    tset = timage.ImageSet.read(
        os.path.join(FIXTURES, "classes", "*", "*.[pb][nm][gp]"),
        device="cpu")
    uris = [s["uri"] for p in tset.shards.collect() for s in p]
    assert len(uris) == len(LOSSLESS)
    for uri, img in zip(uris, tset.get_image()):
        np.testing.assert_array_equal(img, _cv2_rgb(uri))


# --- image3d -------------------------------------------------------------------
def test_image3d_transforms_bit_for_bit():
    vol = np.random.RandomState(4).rand(9, 11, 13).astype(np.float32)
    cases = [("Crop3D", ((1, 2, 3), (4, 5, 6))),
             ("RandomCrop3D", (4, 5, 6, 7)),
             ("CenterCrop3D", (5, 6, 7)),
             ("Rotate3D", ((0.3, -0.2, 0.1),)),
             ("AffineTransform3D", (np.eye(3) * 1.1, np.array([0.5, 1, 0])))]
    for name, args in cases:
        jt = getattr(jimage3d, name)(*args)
        tt = getattr(timage3d, name)(*args)
        for _ in range(2):
            np.testing.assert_array_equal(tt(vol), jt(vol))
    chain = [getattr(m, "CenterCrop3D")(6, 7, 8).chain(
        getattr(m, "Rotate3D")((0.1, 0.2, 0.3))) for m in (jimage3d,
                                                           timage3d)]
    np.testing.assert_array_equal(chain[1](vol), chain[0](vol))
    u8 = (vol * 255).astype(np.uint8)
    np.testing.assert_array_equal(timage3d.Rotate3D((0.2, 0, 0))(u8),
                                  jimage3d.Rotate3D((0.2, 0, 0))(u8))


# --- NNImageReader -----------------------------------------------------------
@pytest.mark.parametrize("resize", [None, (24, 40), (80, 70)])
def test_nn_image_reader_as_jax(tmp_path, resize):
    from analytics_zoo_tpu.pipeline.nnframes.nn_image_reader import \
        NNImageReader as JReader
    from analytics_zoo_tpu_torch.pipeline.nnframes import NNImageReader
    for i, ext in enumerate((".png", ".bmp", ".png")):
        img = _picture(31 + i, 45 - i, seed=10 + i)
        cv2.imwrite(str(tmp_path / f"img{i}{ext}"), img)
    (tmp_path / "notes.txt").write_text("not an image")
    kw = {} if resize is None else dict(resize_height=resize[0],
                                        resize_width=resize[1])
    want = JReader.readImages(str(tmp_path), **kw)
    got = NNImageReader.read_images(str(tmp_path), device="cpu", **kw)
    assert len(got) == len(want) == 3
    for g, w in zip(got["image"], want["image"]):
        assert {k: v for k, v in g.items() if k != "data"} == \
            {k: v for k, v in w.items() if k != "data"}
        d = np.abs(g["data"].astype(np.int64) - w["data"].astype(np.int64))
        assert g["data"].shape == w["data"].shape
        assert d.max() <= (0 if resize is None else 1)
