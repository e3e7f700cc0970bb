"""Image file decoders: the port's counterpart of ``cv2.imread`` /
``cv2.imdecode(buf, cv2.IMREAD_COLOR)`` followed by ``COLOR_BGR2RGB``,
which the JAX package's ``feature/image`` calls. The card's machine has
neither cv2 nor PIL.

:func:`decode_image` gives ``(height, width, 3)`` uint8 RGB numpy arrays:

* **PNG** in numpy over ``zlib``, bit for bit what cv2 gives: every filter
  (None, Sub, Up, Average, Paeth), Adam7 interlacing, bit depths 1, 2, 4,
  8 and 16 (16-bit samples keep their high byte), colour types 0 (grey),
  2 (RGB), 3 (palette), 4 and 6 (grey and RGB with alpha; the alpha is
  dropped, and a palette's ``tRNS`` ignored, as ``IMREAD_COLOR`` does).
* **BMP**: uncompressed 24- and 32-bit (the fourth byte dropped) and 1-,
  4- and 8-bit palette files, bottom-up or top-down, bit for bit what cv2
  gives.
* **JPEG** on the card through nvJPEG (``csrc/jpeg_decode.cu``): one
  image a call into a CUDA uint8 tensor, copied back. The EXIF orientation
  tag is applied as ``cv2.imread`` applies it. CMYK, YCCK, arithmetic-coded,
  lossless and hierarchical files raise, naming what they are. nvJPEG's
  chroma upsampling and IDCT are not libjpeg-turbo's, so its pixels differ
  from cv2's by a few levels at edges; ``chip_smoke.py``'s ``image_codecs``
  phase holds them to limits that a quality-30 encode of the same picture
  misses. With ``device="cpu"`` a JPEG raises ``NotImplementedError``: the
  port has no host JPEG decoder, and nothing falls back to one.

Other formats raise ``ValueError``.
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from ...common.context import resolve_device

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8"
BMP_SIGNATURE = b"BM"


def image_format(data: bytes) -> str:
    """"png", "jpeg" or "bmp" from the file's first bytes; raises on any
    other."""
    if data[:8] == PNG_SIGNATURE:
        return "png"
    if data[:2] == JPEG_SIGNATURE:
        return "jpeg"
    if data[:2] == BMP_SIGNATURE:
        return "bmp"
    raise ValueError(f"not a PNG, JPEG or BMP file (first bytes "
                     f"{bytes(data[:8])!r})")


def decode_image(data: bytes, device=None, exif_orientation: bool = True
                 ) -> np.ndarray:
    """Encoded image bytes -> ``(height, width, 3)`` uint8 RGB. PNG and BMP
    decode on the host whatever ``device`` is; a JPEG decodes on the card
    (``device`` None means ``cuda``, and raises without one) or raises with
    ``device="cpu"``. ``exif_orientation=False`` leaves a JPEG's pixels as
    stored (as PIL's ``Image.open`` does)."""
    data = bytes(data)
    kind = image_format(data)
    if kind == "png":
        return decode_png(data)
    if kind == "bmp":
        return decode_bmp(data)
    return decode_jpeg(data, device, exif_orientation)


# --- PNG ---------------------------------------------------------------------
# Adam7 passes: (row start, column start, row step, column step)
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}


def _png_chunks(data: bytes):
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG without IEND")


def _unfilter(raw: np.ndarray, height: int, row_bytes: int, bpp: int
              ) -> np.ndarray:
    """Undo the per-row filters of one (sub-)image: ``raw`` holds ``height``
    rows of a filter byte and ``row_bytes`` filtered bytes. Returns the
    (height, row_bytes) uint8 scanlines.

    Sub, Average and Paeth read the byte ``bpp`` to the left, Up, Average
    and Paeth the byte above, so a pixel depends on its left and upper
    neighbours only: the pixels of one anti-diagonal (y + x = t, x counted
    in pixels) are independent, and each diagonal is computed in one pass
    over all five filters, each row taking its own."""
    rows = raw.reshape(height, row_bytes + 1)
    ftype = rows[:, 0].astype(np.int64)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"bad PNG filter type {int(ftype.max())}")
    filt = rows[:, 1:]
    if not ftype.any():
        return filt.copy()
    width = -(-row_bytes // bpp)
    padded = np.zeros((height, width * bpp), np.int64)
    padded[:, :row_bytes] = filt
    f = padded.reshape(height, width, bpp)
    # recon with a zero row above and a zero pixel to the left
    recon = np.zeros((height + 1, width + 1, bpp), np.int64)
    for t in range(height + width - 1):
        ys = np.arange(max(0, t - width + 1), min(height, t + 1))
        xs = t - ys
        a = recon[ys + 1, xs]
        b = recon[ys, xs + 1]
        c = recon[ys, xs]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = np.choose(ftype[ys][:, None],
                         (np.zeros_like(a), a, b, (a + b) >> 1, paeth))
        recon[ys + 1, xs + 1] = (f[ys, xs] + pred) & 255
    return recon[1:, 1:].reshape(height, width * bpp)[:, :row_bytes] \
        .astype(np.uint8)


def _samples(lines: np.ndarray, width: int, channels: int, depth: int
             ) -> np.ndarray:
    """Unfiltered scanlines -> (h, width, channels) samples: uint8 for
    depths up to 8 (unpacked, not scaled), uint16 for 16."""
    h = lines.shape[0]
    if depth == 16:
        return lines.view(">u2").reshape(h, width, channels).astype(np.uint16)
    if depth == 8:
        return lines.reshape(h, width, channels)
    bits = np.unpackbits(lines, axis=1)
    bits = bits[:, :width * depth].reshape(h, width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[..., None]


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (h, w, 3) uint8 RGB, as cv2's ``IMREAD_COLOR`` gives
    (after ``COLOR_BGR2RGB``)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, ctype, comp, filt_method, interlace = header
    if ctype not in _PNG_CHANNELS or depth not in _PNG_DEPTHS[ctype]:
        raise ValueError(f"unsupported PNG colour type {ctype} at bit "
                         f"depth {depth}")
    if comp != 0 or filt_method != 0 or interlace not in (0, 1):
        raise ValueError("unsupported PNG compression, filter method or "
                         "interlace method")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    channels = _PNG_CHANNELS[ctype]
    bits = channels * depth
    bpp = max(1, bits // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    passes = (_ADAM7 if interlace else ((0, 0, 1, 1),))
    dtype = np.uint16 if depth == 16 else np.uint8
    img = np.zeros((height, width, channels), dtype)
    pos = 0
    for y0, x0, dy, dx in passes:
        ph = -(-(height - y0) // dy) if height > y0 else 0
        pw = -(-(width - x0) // dx) if width > x0 else 0
        if ph == 0 or pw == 0:
            continue
        row_bytes = -(-pw * bits // 8)
        n = ph * (row_bytes + 1)
        if pos + n > raw.size:
            raise ValueError("truncated PNG image data")
        lines = _unfilter(raw[pos:pos + n], ph, row_bytes, bpp)
        pos += n
        img[y0::dy, x0::dx] = _samples(lines, pw, channels, depth)
    if depth == 16:
        img = (img >> 8).astype(np.uint8)        # the high byte
    if ctype == 3:
        idx = img[..., 0]
        if idx.max(initial=0) >= len(palette):
            raise ValueError("PNG palette index out of range")
        return palette[idx]
    if ctype in (0, 4):
        grey = img[..., 0]
        if depth < 8:
            grey = grey * np.uint8(255 // ((1 << depth) - 1))
        return np.repeat(grey[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


# --- BMP ---------------------------------------------------------------------
def decode_bmp(data: bytes) -> np.ndarray:
    """Uncompressed BMP bytes (24/32-bit, or 1/4/8-bit palette) -> (h, w, 3)
    uint8 RGB, as cv2's ``IMREAD_COLOR`` gives."""
    if data[:2] != BMP_SIGNATURE or len(data) < 26:
        raise ValueError("not a BMP file")
    offset = struct.unpack("<I", data[10:14])[0]
    header_size = struct.unpack("<I", data[14:18])[0]
    if header_size == 12:                        # OS/2 BITMAPCOREHEADER
        width, height, _, depth = struct.unpack("<HhHH", data[18:26])
        compression, colours, entry = 0, 0, 3
    elif header_size >= 40:
        width, height, _, depth, compression = struct.unpack(
            "<iiHHI", data[18:34])
        colours = struct.unpack("<I", data[46:50])[0]
        entry = 4
    else:
        raise ValueError(f"unsupported BMP header of {header_size} bytes")
    if compression not in (0, 3) or (compression == 3 and depth != 32):
        raise ValueError(f"unsupported BMP compression {compression} at "
                         f"{depth} bits (only uncompressed files)")
    if compression == 3:
        masks = struct.unpack("<III", data[54:66])   # after the 40 bytes
        if masks != (0xFF0000, 0xFF00, 0xFF):
            raise ValueError(f"unsupported BMP bit fields {masks}")
    if depth not in (1, 4, 8, 24, 32):
        raise ValueError(f"unsupported BMP bit depth {depth}")
    top_down = height < 0
    height = abs(height)
    stride = ((width * depth + 31) // 32) * 4
    body = np.frombuffer(data, np.uint8, count=stride * height, offset=offset)
    rows = body.reshape(height, stride)
    if not top_down:
        rows = rows[::-1]
    if depth >= 24:
        px = rows[:, :width * depth // 8].reshape(height, width, depth // 8)
        return np.ascontiguousarray(px[..., 2::-1])   # BGR(X) -> RGB
    n = colours or (1 << depth)
    table = np.frombuffer(data, np.uint8, count=n * entry,
                          offset=14 + header_size)
    table = table.reshape(n, entry)[:, 2::-1]          # BGR(A) -> RGB
    idx = _samples(np.ascontiguousarray(rows), width, 1, depth)[..., 0] \
        if depth < 8 else rows[:, :width]
    if idx.max(initial=0) >= n:
        raise ValueError("BMP palette index out of range")
    return np.ascontiguousarray(table[idx])


# --- JPEG --------------------------------------------------------------------
_SOF_NAMES = {0xC0: "baseline", 0xC1: "extended sequential",
              0xC2: "progressive", 0xC3: "lossless",
              0xC5: "differential sequential (hierarchical)",
              0xC6: "differential progressive (hierarchical)",
              0xC7: "differential lossless (hierarchical)",
              0xC9: "arithmetic-coded sequential",
              0xCA: "arithmetic-coded progressive",
              0xCB: "arithmetic-coded lossless",
              0xCD: "arithmetic-coded differential sequential",
              0xCE: "arithmetic-coded differential progressive",
              0xCF: "arithmetic-coded differential lossless"}
_SOF_DECODED = (0xC0, 0xC1, 0xC2)


class JpegInfo(NamedTuple):
    """What the markers say of a JPEG's first frame."""
    width: int
    height: int
    components: int
    frame: str
    orientation: int


def _exif_orientation(body: bytes) -> int:
    """The Orientation tag (0x0112) of IFD0 in an APP1 Exif segment's
    body, 1 when it has none."""
    if body[:6] != b"Exif\x00\x00":
        return 1
    tiff = body[6:]
    if tiff[:2] == b"II":
        end = "<"
    elif tiff[:2] == b"MM":
        end = ">"
    else:
        return 1
    try:
        ifd = struct.unpack(end + "I", tiff[4:8])[0]
        count = struct.unpack(end + "H", tiff[ifd:ifd + 2])[0]
        for i in range(count):
            entry = tiff[ifd + 2 + 12 * i:ifd + 14 + 12 * i]
            tag, typ = struct.unpack(end + "HH", entry[:4])
            if tag == 0x0112 and typ == 3:
                value = struct.unpack(end + "H", entry[8:10])[0]
                return value if 1 <= value <= 8 else 1
    except struct.error:
        return 1
    return 1


def jpeg_info(data: bytes) -> JpegInfo:
    """Walks the markers up to the first scan. Raises ``ValueError`` on a
    file that is not a JPEG, and naming what it is on a CMYK or YCCK
    file or a frame nvJPEG is not asked to decode here (arithmetic coding,
    lossless, hierarchical)."""
    if data[:2] != JPEG_SIGNATURE:
        raise ValueError("not a JPEG file")
    pos, orientation, adobe, sof = 2, 1, None, None
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"corrupt JPEG: no marker at byte {pos}")
        marker = data[pos + 1]
        if marker == 0xFF:                        # fill byte
            pos += 1
            continue
        if marker in (0x01,) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        body = data[pos + 4:pos + 2 + length]
        if marker == 0xE1 and orientation == 1:
            orientation = _exif_orientation(body)
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]                      # colour transform
        elif marker in _SOF_NAMES and sof is None:
            _, height, width, comps = struct.unpack(">BHHB", body[:6])
            sof = (marker, width, height, comps)
        elif marker == 0xDA:                      # start of scan
            break
        pos += 2 + length
    if sof is None:
        raise ValueError("JPEG without a frame header")
    marker, width, height, comps = sof
    if marker not in _SOF_DECODED:
        raise ValueError(f"{_SOF_NAMES[marker]} JPEG is not supported")
    if comps == 4:
        kind = "YCCK" if adobe == 2 else "CMYK"
        raise ValueError(f"{kind} JPEG is not supported (4 components)")
    if comps not in (1, 3):
        raise ValueError(f"JPEG with {comps} components is not supported")
    return JpegInfo(width, height, comps, _SOF_NAMES[marker], orientation)


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """The EXIF orientation as cv2 applies it (``ApplyExifOrientation``):
    a flip and/or a transpose of the decoded pixels."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    flip = {2: 1, 3: -1, 4: 0, 6: 1, 7: -1, 8: 0}.get(orientation)
    if flip in (1, -1):
        img = img[:, ::-1]
    if flip in (0, -1):
        img = img[::-1]
    return np.ascontiguousarray(img)


def nvjpeg_decode(data: bytes, info: Optional[JpegInfo] = None,
                  device="cuda") -> torch.Tensor:
    """Decodes one JPEG on the card with nvJPEG (``csrc/jpeg_decode.cu``)
    into a new ``(height, width, 3)`` uint8 CUDA tensor, on the current
    stream, before any EXIF orientation. Raises with nvJPEG's status if the
    decode fails; adds one to ``nvjpeg_decode.launches`` a call."""
    from ...ops import _kernels
    info = info or jpeg_info(data)
    dev = torch.device(device)
    if dev.type != "cuda":
        raise NotImplementedError(
            "JPEG decodes on the card only (nvJPEG): the port has no host "
            "JPEG decoder")
    out = torch.empty((info.height, info.width, 3), dtype=torch.uint8,
                      device=dev)
    lib = _kernels.load("jpeg_decode")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.zoo_jpeg_decode(data, len(data), out.data_ptr(),
                                  info.width, info.height, stream)
    nvjpeg_decode.launches += 1
    if err:
        raise RuntimeError(f"nvJPEG decode failed: {_status(lib, err)}")
    return out


nvjpeg_decode.launches = 0

_NVJPEG_STATUS = {1: "NVJPEG_STATUS_NOT_INITIALIZED",
                  2: "NVJPEG_STATUS_INVALID_PARAMETER",
                  3: "NVJPEG_STATUS_BAD_JPEG",
                  4: "NVJPEG_STATUS_JPEG_NOT_SUPPORTED",
                  5: "NVJPEG_STATUS_ALLOCATOR_FAILURE",
                  6: "NVJPEG_STATUS_EXECUTION_FAILED",
                  7: "NVJPEG_STATUS_ARCH_MISMATCH",
                  8: "NVJPEG_STATUS_INTERNAL_ERROR",
                  9: "NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED",
                  10: "NVJPEG_STATUS_INCOMPLETE_BITSTREAM"}


def _status(lib, err: int) -> str:
    if err == 999:
        return "nvJPEG reads another image size than the frame header"
    if err >= 1000:
        return (f"CUDA error {err - 1000}: "
                f"{lib.zoo_cuda_error_string(err - 1000).decode()}")
    return f"nvJPEG status {err} ({_NVJPEG_STATUS.get(err, 'unknown')})"


def decode_jpeg(data: bytes, device=None, exif_orientation: bool = True
                ) -> np.ndarray:
    """JPEG bytes -> (h, w, 3) uint8 RGB with the EXIF orientation applied
    (unless ``exif_orientation`` is False), decoded on the card;
    ``device="cpu"`` raises ``NotImplementedError``."""
    info = jpeg_info(data)
    if device is not None and torch.device(device).type == "cpu":
        raise NotImplementedError(
            "JPEG decodes on the card only (nvJPEG): the port has no host "
            "JPEG decoder; pass device='cuda' (or None)")
    dev = resolve_device(device)
    img = nvjpeg_decode(data, info, dev).cpu().numpy()
    return apply_orientation(img, info.orientation if exif_orientation
                             else 1)


def read_image(path: str, device=None, exif_orientation: bool = True
               ) -> np.ndarray:
    """:func:`decode_image` of a file."""
    with open(path, "rb") as f:
        return decode_image(f.read(), device, exif_orientation)


__all__ = ["decode_image", "decode_png", "decode_bmp", "decode_jpeg",
           "jpeg_info", "apply_orientation", "nvjpeg_decode", "read_image",
           "image_format", "JpegInfo"]
