"""The serving subset of ``insenticap_model_tpu/preprocessing.py``: image
decoding, the resize bucket ladder, bucket assignment and resize, uint8 RGB
normalisation and the sentiment-word ranking of detected concepts
(reference preprocess.py:280-302).

The JAX package decodes and resizes with PIL (:50-117). The port has no
PIL, so it carries its own, to give PIL's arrays bit for bit:

* ``load_image`` / ``load_image_bytes``: JPEG through the host library
  ``csrc/imgdec.cc`` (libjpeg's integer IDCT, fancy upsampling and colour
  tables; built by ``ops/_build.load_host`` at first use) and PNG here
  (chunks and CRCs, zlib, then the row filters in the same library). The
  arrays are ``_pil_to_array``'s: "L" stays 2-D, "RGBA" drops its alpha,
  every other mode becomes RGB. What the decoders do not take raises
  ``ValueError`` naming it: progressive, lossless and arithmetic-coded
  JPEG, CMYK/YCCK and Adobe-RGB JPEG, 12-bit JPEG, interlaced PNG and
  16-bit PNG. Greyscale PNG at 1, 2 and 4 bits is read as PIL reads it:
  1 bit is mode "1" (RGB of 0 and 255), 2 and 4 bits are "L" scaled to
  0..255.
* ``resize_to_bucket``: Pillow's ``BILINEAR`` resampler
  (``libImaging/Resample.c``) in numpy: separable, the horizontal pass
  first with a uint8 round between the passes, the triangle filter widened
  by the scale when it shrinks, weights in 22-bit fixed point.
"""
from __future__ import annotations

import ctypes
import math
import struct
import zlib
from collections import defaultdict
from typing import Dict, List

import numpy as np

# Static shape ladder of the resize policy: 448x448 plus the two 3:4
# aspects. Every extent is a multiple of 32, so the last conv map is
# (H/32, W/32); at 448x448 that is the 14x14 att grid itself.
DEFAULT_BUCKET_SHAPES = ((448, 448), (384, 512), (512, 384))


_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_SIGS = {"isc_jpeg_info": [_P, _LL, _IP, _IP, _IP, _P, _I],
         "isc_jpeg_decode": [_P, _LL, _P, _LL, _P, _I],
         "isc_png_unfilter": [_P, _LL, _P, _I, _LL, _I, _P, _I]}
_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# PIL refuses an image of more than twice Image.MAX_IMAGE_PIXELS (its
# DecompressionBombError); so do the decoders, before allocating anything
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)
# PNG colour type -> (channels, bit depths the port reads)
_PNG_TYPES = {0: (1, (1, 2, 4, 8)), 2: (3, (8,)), 3: (1, (1, 2, 4, 8)),
              4: (2, (8,)), 6: (4, (8,))}


def _lib():
    from .ops import _build
    return _build.load_host("imgdec", _SIGS)


def _call(fn, *args):
    err = ctypes.create_string_buffer(256)
    if fn(*args, err, len(err)) != 0:
        raise ValueError(err.value.decode(errors="replace"))


def _check_pixels(h: int, w: int) -> None:
    if h * w > MAX_PIXELS:
        raise ValueError(f"image of {h}x{w} pixels exceeds the limit of "
                         f"{MAX_PIXELS} (a decompression bomb to PIL too)")


def _decode_jpeg(data: bytes) -> np.ndarray:
    lib = _lib()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _call(lib.isc_jpeg_info, data, len(data), ctypes.byref(h),
          ctypes.byref(w), ctypes.byref(c))
    _check_pixels(h.value, w.value)
    shape = (h.value, w.value) + ((3,) if c.value == 3 else ())
    out = np.empty(shape, np.uint8)
    _call(lib.isc_jpeg_decode, data, len(data), out.ctypes.data, out.size)
    return out


def _png_chunks(data: bytes):
    pos = len(_PNG_SIG)
    while True:
        if pos + 8 > len(data):
            raise ValueError("PNG: truncated file (no IEND chunk)")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + n
        if end + 4 > len(data):
            raise ValueError(f"PNG: truncated file (in a {kind!r} chunk)")
        body = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG: corrupt data (CRC of a {kind!r} chunk)")
        yield kind, body
        if kind == b"IEND":
            return
        pos = end + 4


def _unpack_bits(rows: np.ndarray, depth: int, w: int) -> np.ndarray:
    """[h, rowbytes] packed samples (big-endian within a byte) ->
    [h, w] uint8 sample values."""
    per = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(rows.shape[0], rows.shape[1] * per)[:, :w]


def _decode_png(data: bytes) -> np.ndarray:
    ihdr, plte, idat = None, None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            ihdr = body
        elif kind == b"PLTE":
            plte = body
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None or len(ihdr) != 13:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB",
                                                              ihdr)
    if ctype not in _PNG_TYPES or comp or filt or not (w and h):
        raise ValueError(f"PNG: bad header (colour type {ctype}, size "
                         f"{w}x{h})")
    channels, depths = _PNG_TYPES[ctype]
    if depth == 16:
        raise ValueError("PNG: unsupported: 16-bit samples")
    if depth not in depths:
        raise ValueError(f"PNG: bad bit depth {depth} for colour type "
                         f"{ctype}")
    if interlace:
        raise ValueError("PNG: unsupported: interlaced (Adam7)")
    _check_pixels(h, w)
    rowbytes = (w * channels * depth + 7) // 8
    try:      # no more than the image holds, whatever the stream inflates to
        raw = zlib.decompressobj().decompress(b"".join(idat),
                                              h * (rowbytes + 1))
    except zlib.error as e:
        raise ValueError(f"PNG: corrupt image data ({e})") from None
    rows = np.empty((h, rowbytes), np.uint8)
    _call(_lib().isc_png_unfilter, raw, len(raw), rows.ctypes.data, h,
          rowbytes, max(1, channels * depth // 8))
    if depth < 8:
        rows = _unpack_bits(rows, depth, w)
    if ctype == 3:
        if plte is None or len(plte) % 3:
            raise ValueError("PNG: palette image without a valid PLTE")
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(plte) // 3] = np.frombuffer(plte, np.uint8).reshape(-1, 3)
        return pal[rows]
    if ctype == 0:
        if depth == 1:                  # PIL mode "1", then RGB
            return np.repeat((rows * 255)[:, :, None], 3, axis=2)
        return rows * (255 // ((1 << depth) - 1))    # "L;2", "L;4", "L"
    img = rows.reshape(h, w, channels)
    if ctype == 4:                      # "LA" -> RGB
        return np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])       # RGB, RGBA


def load_image_bytes(data: bytes) -> np.ndarray:
    """Encoded JPEG or PNG bytes -> HWC uint8 RGB, or HW uint8 for a
    greyscale image, as the JAX package's PIL path gives them. Anything
    else, or what the decoders do not take, raises ValueError."""
    data = bytes(data)
    if data[:2] == b"\xff\xd8":
        return _decode_jpeg(data)
    if data[:8] == _PNG_SIG:
        return _decode_png(data)
    raise ValueError("not a JPEG or PNG image")


def load_image(path: str) -> np.ndarray:
    """``load_image_bytes`` of a file."""
    with open(path, "rb") as f:
        return load_image_bytes(f.read())


def to_rgb_uint8(image: np.ndarray) -> np.ndarray:
    """gray -> RGB and alpha dropped, staying uint8; the one definition
    lives with the encoder."""
    from .models.encoder import to_rgb_uint8 as impl
    return impl(image)


def bucket_for_shape(h: int, w: int, bucket_shapes) -> tuple:
    """Nearest bucket by log aspect ratio (a tie goes to the first
    listed)."""
    aspect = math.log(w / h)
    return min(bucket_shapes,
               key=lambda b: abs(math.log(b[1] / b[0]) - aspect))


def _resample_taps(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` for the bilinear filter and
    ``normalize_coeffs_8bpc``: (first input index [out], int64 weights
    [out, ksize] in 22-bit fixed point, zero past each output's span)."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    x = np.arange(ksize)
    t = np.abs(((x[None] + xmin[:, None]).astype(np.float64)
                - center[:, None] + 0.5) * (1.0 / filterscale))
    k = np.where((t < 1.0) & (x[None] < xmax[:, None]), 1.0 - t, 0.0)
    ww = np.zeros(out_size)
    for i in range(ksize):              # the C loop's order of the sum
        ww = ww + k[:, i]
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0, 1, ww)[:, None],
                 k)
    return xmin, np.trunc(0.5 + k * (1 << 22)).astype(np.int64)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resampler along ``axis`` (0 rows, 1
    columns) of a uint8 [H, W, C] image, vectorised over the outputs."""
    in_size = img.shape[axis]
    xmin, kk = _resample_taps(in_size, out_size)
    idx = np.minimum(xmin[:, None] + np.arange(kk.shape[1]), in_size - 1)
    # 255 x (2^22 + a few) + 2^21 fits int32, as in Pillow's INT32 sums;
    # the resampled axis outermost, so that a tap gathers whole rows
    src = np.ascontiguousarray(np.moveaxis(img, axis, 0)).astype(np.int32)
    kk = kk.astype(np.int32)
    acc = np.full((out_size,) + src.shape[1:], 1 << 21, np.int32)
    for i in range(kk.shape[1]):
        acc += src[idx[:, i]] * kk[:, i, None, None]
    out = np.clip(acc >> 22, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_to_bucket(img_u8: np.ndarray, bucket: tuple) -> np.ndarray:
    """Bilinear resize of an RGB uint8 image to the bucket extent, as
    PIL's ``Image.resize(..., BILINEAR)`` gives it (the JAX package's
    resize). Identity when the image is already bucket-shaped: the bucket
    path then matches the exact path bit for bit."""
    if tuple(img_u8.shape[:2]) == tuple(bucket):
        return img_u8
    h, w = (int(v) for v in bucket)
    out = np.asarray(img_u8, np.uint8)
    if out.shape[1] != w:               # horizontal pass first
        out = _resample_axis(out, w, 1)
    if out.shape[0] != h:
        out = _resample_axis(out, h, 0)
    return np.ascontiguousarray(out)


def _rank_sentis(cpts, detector_table) -> List[str]:
    """Sentiment words of the concepts' table entries, scores summed per
    word, ranked by the sum (descending; equal sums keep first-seen
    order)."""
    sentis = []
    for con in cpts:
        sentis.extend(detector_table.get(con, []))
    if not sentis:
        return []
    acc: Dict[str, float] = defaultdict(float)
    for w, s in sentis:
        acc[w] += s
    return [w for w, _ in sorted(acc.items(), key=lambda p: p[1],
                                 reverse=True)]
