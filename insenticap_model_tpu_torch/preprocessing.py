"""Offline preprocessing and the image helpers of serving: the port's
``insenticap_model_tpu/preprocessing.py`` (reference preprocess.py, L1 in
SURVEY.md §1).

The serving half: image decoding, the resize bucket ladder, bucket
assignment and resize, uint8 RGB normalisation and the sentiment-word
ranking of detected concepts (reference preprocess.py:280-302). The
offline half: feature extraction (``extract_imgs_feat``: ResNet-101 on the
card, whose stem runs the max-pool kernel), caption and corpus processing,
sentiment-word mining, the vocabularies, the sentiment-image split and the
per-sentiment LMs, each writing the JAX package's JSON byte for byte (the
same code over the port's ``text`` module, whose tokens and tags are the
JAX package's).

The JAX package decodes and resizes with PIL (:50-117). The port has no
PIL, so it carries its own, to give PIL's arrays bit for bit:

* ``load_image`` / ``load_image_bytes``: JPEG through the host library
  ``csrc/imgdec.cc`` (baseline, extended-sequential and progressive
  Huffman JPEG of 1, 3 or 4 components; libjpeg's integer IDCT as
  libjpeg-turbo's x86 SIMD code computes it, fancy upsampling, colour
  space choice and colour tables, and libjpeg-turbo's block smoothing of
  an incomplete progression; YCbCr, RGB (Adobe
  transform 0 or ids 'R' 'G' 'B'), CMYK and YCCK, the last two read as
  PIL reads them, inverted, then its CMYK -> RGB; built by
  ``ops/_build.load_host`` at first use) and PNG here (chunks and CRCs,
  zlib, Adam7's passes, then the row filters in the same library). The
  arrays are ``_pil_to_array``'s: "L" stays 2-D, "RGBA" drops its alpha,
  every other mode becomes RGB. What the decoders do not take raises
  ``ValueError`` naming it: lossless, hierarchical and arithmetic-coded
  JPEG, 12-bit and 2-component JPEG. Greyscale PNG at 1, 2 and 4 bits
  is read as PIL reads it: 1 bit is mode "1" (RGB of 0 and 255), 2 and
  4 bits are "L" scaled to 0..255. At 16 bits PIL keeps grey as "I;16",
  whose RGB clamps each sample at 255, and takes the high byte of every
  other type (grey+alpha as RGBA, grey in R, G and B). GIF (its first
  frame) and BMP follow Pillow's GifImagePlugin and BmpImagePlugin here,
  with GIF's LZW and BMP's RLE8/RLE4 in the same library: a GIF frame on
  its logical screen (grown to hold it; the rest index 0, or the
  transparency index), "L" without a colour table or with the identity
  grey ramp, else RGB through the frame's table; BMP at 1, 4 and 8 bits
  through the palette (black and white as "1", the grey ramp as "L", each
  read with Pillow's raw mode), 16 bits (5-5-5, 5-6-5) with Pillow's
  floor-division expansion, 24 and 32 bits (the bitfield layouts Pillow
  names), RLE8 and RLE4, headers of 12 to 124 bytes. WebP as libwebp 1.6
  decodes it for PIL: the RIFF container (simple, VP8X with its metadata
  chunks skipped, or an animation's first frame on a canvas cleared to
  transparent black) checked here as libwebp's demuxer checks it; in the
  same library the lossless VP8L bitstream (prefix codes, LZ77, colour
  cache, the four transforms) and the lossy VP8 key frame (boolean-coded
  modes and tokens, the inverse transforms, intra prediction, the loop
  filters, fancy upsampling and libwebp's YUV -> RGB), whose ALPH chunk is
  decoded only as far as libwebp refuses it; RGB always. TIFF's first
  page as Pillow's TiffImagePlugin reads it: its IFD as
  ImageFileDirectory_v2 reads it, the layout's mode and raw mode of
  OPEN_INFO, uncompressed strips and tiles by Pillow's raw decoders (its
  tile list, strides and quirks), PackBits and LZW (in the same library)
  and Deflate as libtiff decodes them for Pillow (fill order, predictors
  2 and 3, native 16-bit order, planes a band each), JPEG as libtiff
  drives libjpeg, YCbCr but JPEG in one plane as libtiff's RGBA interface
  reads it (data units, libtiff's buffers, its colour tables), CCITT (RLE,
  RLEW, Group 3 and Group 4, in the same library) as libtiff's fax codec
  decodes it, its recovery from bad codes included, the Orientation tag
  applied, then PIL's conversion to RGB (CIELAB through LittleCMS's
  transform, emulated: its 33^3 table and tetrahedral interpolation, the
  latter in the same library). The other formats that Pillow's plugins
  recognise by signature (PPM, ...), and TIFF's other compressions, are
  refused by name.
* ``resize_to_bucket``: Pillow's ``BILINEAR`` resampler
  (``libImaging/Resample.c``) in numpy: separable, the horizontal pass
  first with a uint8 round between the passes, the triangle filter widened
  by the scale when it shrinks, weights in 22-bit fixed point.

The JAX package's documented divergences from the reference hold here too:
idx2word's dedup is sorted (the reference's ``list(set(...))`` order
depends on the hash seed, preprocess.py:274-275), POS tags come from
``text.py``, and the LMs are trained by the repo's C++ ``isclm`` where
SRILM's ``ngram-count`` is absent (KenLM files are skipped with a note
where ``lmplz`` is absent). Feature stores are written in the native
format only: ``store_format="h5"`` is refused by name, as the port's
readers refuse HDF5 (the card's machine has no h5py).
"""
from __future__ import annotations

import ctypes
import functools
import json
import math
import os
import random
import shutil
import struct
import subprocess
import sys
import zlib
from collections import Counter, defaultdict
from copy import deepcopy
from fractions import Fraction
from typing import Dict, List, Optional

import numpy as np
import torch

from . import text
from .data.feature_store import write_native_store
from .utils.dtypes import resolve_device, to_device

CONCEPT_POS = ("VERB", "NOUN")  # reference preprocess.py:20

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
         "isc_png_unfilter": [_P, _LL, _P, _I, _LL, _I, _P, _I],
         "isc_gif_lzw": [_P, _LL, _P] + [_LL] * 6 + [_I, _I, _P, _I],
         "isc_bmp_rle": [_P, _LL, _LL, _P, _LL, _LL, _I, _P, _I],
         "isc_vp8l_decode": [_P, _LL, _P, _LL, _LL, _P, _I],
         "isc_vp8_decode": [_P, _LL, _P, _LL, _LL, _P, _I],
         "isc_vp8l_alpha_check": [_P, _LL, _LL, _LL, _P, _I],
         "isc_tiff_packbits": [_P, _LL, _P, _LL, _P, _I],
         "isc_tiff_lzw": [_P, _LL, _P, _LL, _I, _P, _I],
         "isc_tiff_inflate": [_P, _LL, _P, _LL, _P, _P, _I],
         "isc_tiff_jpeg_tables": [_P, _LL, _P, _P, _I],
         "isc_tiff_jpeg": [_P, _LL, _P, _LL, _LL, _LL] + [_I] * 5 + [
             _LL, _LL, _P, _LL, _P, _I],
         "isc_tiff_lab": [_P, _LL, _LL, _P, _P, _P, _I],
         "isc_tiff_fax": [_P, _LL, _P] + [_LL] * 3 + [_I, _I, _P, _LL, _LL,
                                                      _P, _P, _P, _I]}
_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# formats that Pillow's plugins recognise (by their ``_accept``
# signatures) and the decoders do not read: a refusal names them. Each
# entry: (name, offset, prefixes)
_REFUSED = (("XV thumbnail", 0, (b"P7 332",)),
            ("PPM (PBM, PGM, PNM, PFM)", 0,
             tuple(b"P" + bytes([c]) for c in b"0123456fy")),
            ("ICO", 0, (b"\0\0\1\0",)),
            ("CUR or TGA", 0, (b"\0\0\2\0",)),
            ("JPEG 2000", 0, (b"\xffO\xffQ", b"\0\0\0\x0cjP  \r\n\x87\n")),
            ("AVIF", 4, (b"ftypavif", b"ftypavis")),
            ("QOI", 0, (b"qoif",)), ("PSD", 0, (b"8BPS",)),
            ("DDS", 0, (b"DDS ",)), ("ICNS", 0, (b"icns",)),
            ("SGI", 0, (b"\x01\xda",)), ("Sun raster", 0, (b"Y\xa6j\x95",)),
            ("PCX", 0, (b"\n\0", b"\n\2", b"\n\3", b"\n\5")),
            ("DCX", 0, (b"\xb1h\xde:",)), ("BLP", 0, (b"BLP1", b"BLP2")),
            ("FTEX", 0, (b"FTEX",)), ("MSP", 0, (b"DanM", b"LinS")),
            ("IM", 0, (b"Image type:",)), ("FITS", 0, (b"SIMPLE",)),
            ("HDF5", 0, (b"\x89HDF\r\n\x1a\n",)),
            ("EPS", 0, (b"%!PS", b"\xc5\xd0\xd3\xc6")),
            ("XPM", 0, (b"/* XPM */",)), ("XBM", 0, (b"#define",)),
            ("MPEG", 0, (b"\0\0\1\xb3",)))
# WebP: libwebp's largest chunk payload (MAX_CHUNK_PAYLOAD) and the VP8X
# flags: animation, alpha, and all five that it knows (with ICC, EXIF and
# XMP)
_WEBP_MAX_PAYLOAD = 0xFFFFFFFF - 9
_WEBP_ANIMATION, _WEBP_ALPHA, _WEBP_VALID_FLAGS = 0x02, 0x10, 0x3E
# BMP: the DIB header sizes Pillow reads; its raw mode for each depth, and
# for each bitfields layout (bits, masks); a raw mode's bits a pixel (32
# for the others); the bytes of R, G and B in a 24- or 32-bit pixel
_BMP_HEADERS = (12, 40, 52, 56, 64, 108, 124)
_BMP_RAW = {1: "P;1", 4: "P;4", 8: "P", 16: "BGR;15", 24: "BGR", 32: "BGRX"}
_BMP_MASKS = {(32, (0xFF0000, 0xFF00, 0xFF, 0)): "BGRX",
              (32, (0xFF000000, 0xFF0000, 0xFF00, 0)): "XBGR",
              (32, (0xFF000000, 0xFF00, 0xFF, 0)): "BGXR",
              (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
              (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
              (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
              (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
              (32, (0, 0, 0, 0)): "BGRA",
              (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
              (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
              (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15"}
_RAW_BITS = {"1": 1, "L": 8, "P;1": 1, "P;4": 4, "P": 8, "BGR;15": 16,
             "BGR;16": 16, "BGR": 24}
_RAW_RGB = {"BGR": (2, 1, 0), "BGRX": (2, 1, 0), "XBGR": (3, 2, 1),
            "BGXR": (3, 1, 0), "ABGR": (3, 2, 1), "RGBA": (0, 1, 2),
            "BGRA": (2, 1, 0), "BGAR": (3, 1, 0)}
# PIL refuses an image of more than twice Image.MAX_IMAGE_PIXELS (its
# DecompressionBombError); so do the decoders, before allocating anything
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)
# PNG colour type -> (channels, bit depths)
_PNG_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
              4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7's seven passes: (x0, y0, dx, dy), each a sub-image of the pixels
# (x0 + i dx, y0 + j dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


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


def _png_passes(w: int, h: int, interlace: int):
    """The sub-images the image data holds, in order: [(x0, y0, dx, dy,
    width, height)], the whole image, or Adam7's seven passes less the
    empty ones (a pass with no column or no row has no bytes, not even
    filter bytes). PIL takes any nonzero interlace method as Adam7."""
    if not interlace:
        return [(0, 0, 1, 1, w, h)]
    out = []
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw > 0 and ph > 0:
            out.append((x0, y0, dx, dy, pw, ph))
    return out


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
    if depth not in depths:
        raise ValueError(f"PNG: bad bit depth {depth} for colour type "
                         f"{ctype}")
    _check_pixels(h, w)
    passes = _png_passes(w, h, interlace)

    def rowbytes(width):
        return (width * channels * depth + 7) // 8
    try:      # no more than the image holds, whatever the stream inflates to
        raw = zlib.decompressobj().decompress(
            b"".join(idat), sum(ph * (rowbytes(pw) + 1)
                                for *_, pw, ph in passes))
    except zlib.error as e:
        raise ValueError(f"PNG: corrupt image data ({e})") from None
    # the samples [h, w, channels], uint8 (big-endian uint16 at 16 bits),
    # pass by pass
    buf = np.frombuffer(raw, np.uint8)
    dtype = np.dtype(">u2" if depth == 16 else np.uint8)
    samples = np.empty((h, w, channels), dtype)
    pos = 0
    for x0, y0, dx, dy, pw, ph in passes:
        rows = np.empty((ph, rowbytes(pw)), np.uint8)
        _call(_lib().isc_png_unfilter, buf[pos:].ctypes.data, len(buf) - pos,
              rows.ctypes.data, ph, rows.shape[1],
              max(1, channels * depth // 8))
        pos += rows.size + ph
        if depth < 8:
            part = _unpack_bits(rows, depth, pw)[:, :, None]
        else:
            part = rows.view(dtype).reshape(ph, pw, channels)
        samples[y0::dy, x0::dx] = part
    if depth == 16:
        if ctype == 0:                  # "I;16", then RGB: clamped at 255
            return np.repeat(np.minimum(samples, 255).astype(np.uint8), 3,
                             axis=2)
        samples = (samples >> 8).astype(np.uint8)     # "RGB;16B" etc.
    if ctype == 3:
        if plte is None or len(plte) % 3:
            raise ValueError("PNG: palette image without a valid PLTE")
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(plte) // 3] = np.frombuffer(plte, np.uint8).reshape(-1, 3)
        return pal[samples[:, :, 0]]
    if ctype == 0:
        grey = samples[:, :, 0]
        if depth == 1:                  # PIL mode "1", then RGB
            return np.repeat((grey * 255)[:, :, None], 3, axis=2)
        return grey * (255 // ((1 << depth) - 1))    # "L;2", "L;4", "L"
    if ctype == 4:                      # "LA" (or "LA;16B" as RGBA) -> RGB
        return np.repeat(samples[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(samples[:, :, :3])   # RGB, RGBA


def _palette_rgb(entries: bytes, width: int, order=(0, 1, 2)) -> np.ndarray:
    """[256, 3] uint8 RGB of a palette of ``width``-byte entries (R, G, B at
    ``order``), as Pillow's ``putpalette`` takes it: more than 256 entries
    refused, the indices past the last entry black."""
    n = len(entries) // width
    if n > 256:
        raise ValueError(f"invalid palette size ({n} entries)")
    pal = np.zeros((256, 3), np.uint8)
    pal[:n] = np.frombuffer(entries[:n * width], np.uint8).reshape(
        n, width)[:, list(order)]
    return pal


def _gif_palette_needed(p: bytes) -> bool:
    """GifImagePlugin's ``_is_palette_needed``: False for the identity grey
    ramp (entry i is (i, i, i)), which Pillow reads as mode "L"."""
    for i in range(0, len(p), 3):
        for k in range(3):
            if len(p) <= i + k:        # Pillow's IndexError: not a GIF
                raise ValueError("GIF: truncated colour table")
            if p[i + k] != (i // 3 if k == 0 else p[i]):
                return True
    return False


def _decode_gif(data: bytes) -> np.ndarray:
    """The first frame of a GIF, as PIL's ``Image.open`` gives it: pasted
    at its offset into the logical screen (grown to hold a frame that
    reaches past it), the rest of the screen palette index 0, or frame 0's
    transparency index where its graphic control block sets one. Mode "L"
    (the index plane, 2-D) without a colour table or with the identity grey
    ramp, else "P" as RGB through the table (the frame's own, or the
    global one)."""
    if len(data) < 13:
        raise ValueError("GIF: truncated header")
    w, h, flags = struct.unpack("<HHB", data[6:11])
    pos = 13
    palette = None                       # None: none; False: the grey ramp
    if flags & 128:
        table = data[pos:pos + (3 << ((flags & 7) + 1))]
        pos += len(table)
        if _gif_palette_needed(table):
            palette = table

    def read(k):
        nonlocal pos
        out = data[pos:pos + k]
        pos += len(out)
        return out

    def sub_block():
        k = read(1)
        return read(k[0]) if k and k[0] else None
    transparency = frame = None
    s = read(1)
    if not s or s == b";":
        raise ValueError("GIF: no image in the file")
    while True:                          # GifImagePlugin's _seek(0)
        if not s:
            s = read(1)
        if not s or s == b";":
            break
        if s == b"!":                    # an extension
            s = read(1)
            if not s:
                raise ValueError("GIF: truncated extension")
            block = sub_block()
            if s[0] == 249 and block is not None:
                if len(block) < 3 or (block[0] & 1 and len(block) < 4):
                    raise ValueError("GIF: truncated graphic control block")
                if block[0] & 1:
                    transparency = block[3]
            elif s[0] == 254:            # a comment: its blocks, no more
                while block:
                    block = sub_block()
                s = b""
                continue
            elif s[0] == 255 and block is not None and block.startswith(
                    b"NETSCAPE2.0"):     # its loop count: one block more
                sub_block()
            while sub_block():
                pass
        elif s == b",":                  # the image descriptor
            d = read(9)
            if len(d) < 9:
                raise ValueError("GIF: truncated image descriptor")
            x0, y0, fw, fh, fl = struct.unpack("<HHHHB", d)
            w, h = max(w, x0 + fw), max(h, y0 + fh)
            if fl & 128:
                table = read(3 << ((fl & 7) + 1))
                palette = table if _gif_palette_needed(table) else False
            k = read(1)
            if not k:
                raise ValueError("GIF: truncated image data")
            frame = (x0, y0, fw, fh, bool(fl & 64), k[0], pos)
            break
        s = b""
    if frame is None:
        raise ValueError("GIF: no image in the file")
    if not (w and h):
        raise ValueError(f"GIF: empty image ({w}x{h})")
    _check_pixels(h, w)
    x0, y0, fw, fh, interlace, bits, pos = frame
    plane = np.full((h, w), transparency or 0, np.uint8)
    lzw = data[pos:]
    _call(_lib().isc_gif_lzw, lzw, len(lzw), plane.ctypes.data, w, h, x0,
          y0, fw, fh, bits, int(interlace))
    if not palette:
        return plane
    return _palette_rgb(palette, 3)[plane]


def _unpack16(px: np.ndarray, green_bits: int) -> np.ndarray:
    """Pillow's BGR;15 (5-5-5) or BGR;16 (5-6-5) samples -> RGB: each
    field v of b bits read as v * 255 // (2^b - 1)."""
    px = px.astype(np.uint32)
    b = px & 31
    g = (px >> 5) & ((1 << green_bits) - 1)
    r = (px >> (5 + green_bits)) & 31
    gmax = (1 << green_bits) - 1
    return np.stack([r * 255 // 31, g * 255 // gmax, b * 255 // 31],
                    -1).astype(np.uint8)


def _decode_bmp(data: bytes) -> np.ndarray:
    """A BMP as PIL's BmpImagePlugin opens it: 1, 4 and 8 bits through
    the palette (a black-and-white one read as mode "1", the identity grey
    ramp as "L", each with its own raw mode over the file's rows), 16 bits
    as 5-5-5 or 5-6-5, 24 and 32 bits (the bitfield layouts Pillow names,
    the alpha dropped), RLE8 and RLE4; bottom-up or top-down rows padded to
    4 bytes."""
    if len(data) < 18:
        raise ValueError("BMP: truncated header")
    offset, hsize = struct.unpack("<II", data[10:18])
    if hsize not in _BMP_HEADERS:
        raise ValueError(f"BMP: unsupported header size {hsize}")
    if len(data) < 14 + hsize:
        raise ValueError("BMP: truncated header")
    hd = data[18:14 + hsize]
    pos = 14 + hsize
    direction, compression, colors, masks = -1, 0, 0, None
    if hsize == 12:                      # OS/2 1.x: 16-bit sizes
        w, h, _, bits = struct.unpack("<HHHH", hd[:8])
        pad = 3
    else:
        w, h, _, bits, compression = struct.unpack("<IIHHI", hd[:16])
        (colors,) = struct.unpack("<I", hd[28:32])
        if hd[7] == 0xFF:                # a negative height: top-down rows
            direction, h = 1, 2 ** 32 - h
        pad = 4
        if compression == 3:             # the bitfields' masks
            if hsize >= 52:
                masks = struct.unpack("<4I", hd[36:52] if hsize >= 56
                                      else hd[36:48] + bytes(4))
            else:
                if len(data) < pos + 12:
                    raise ValueError("BMP: truncated bitfield masks")
                masks = struct.unpack("<3I", data[pos:pos + 12]) + (0,)
                pos += 12
    if bits not in _BMP_RAW:
        raise ValueError(f"BMP: unsupported bit depth {bits}")
    colors = colors or 1 << bits
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    raw = _BMP_RAW[bits]
    rle = compression in (1, 2)
    if compression == 3:
        key = (bits, masks if bits == 32 else masks[:3])
        if key not in _BMP_MASKS:
            raise ValueError(f"BMP: unsupported bitfields layout "
                             f"({bits} bits, masks {masks})")
        raw = _BMP_MASKS[key]
    elif compression not in (0, 1, 2):
        names = {4: "JPEG", 5: "PNG"}
        raise ValueError(f"BMP: unsupported compression "
                         f"{names.get(compression, compression)}")
    pal = None
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise ValueError(f"BMP: unsupported palette size {colors}")
        entries = data[pos:pos + pad * colors]
        pos += len(entries)
        grey = ((0, 255) if colors == 2 else range(colors))
        if all(entries[i * pad:i * pad + 3] == bytes([v & 255] * 3)
               for i, v in enumerate(grey)):
            raw = "1" if colors == 2 else "L"
        else:
            pal = _palette_rgb(entries, pad, (2, 1, 0))
    if not (w and h):
        raise ValueError(f"BMP: empty image ({w}x{h})")
    _check_pixels(h, w)
    start = offset or pos
    if rle:
        if raw not in ("P", "L", "P;1", "P;4"):
            raise ValueError(f"BMP: RLE at {bits} bits ({raw})")
        px = np.empty((h, w), np.uint8)
        body = data[start:]
        _call(_lib().isc_bmp_rle, body, len(body), start, px.ctypes.data, w,
              h, int(compression == 2))
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        row = (w * _RAW_BITS.get(raw, 32) + 7) // 8
        if row > stride:
            raise ValueError(f"BMP: rows of {stride} bytes hold no {raw} "
                             f"row of {w} pixels")
        if len(data) - start < (h - 1) * stride + row:
            raise ValueError("BMP: truncated image data")
        rows = np.frombuffer(data, np.uint8, h * stride - stride + row,
                             start)
        rows = np.lib.stride_tricks.as_strided(rows, (h, row), (stride, 1))
        if raw in ("1", "P;1", "P;4"):
            px = _unpack_bits(rows, 4 if raw == "P;4" else 1, w)
        elif raw in ("L", "P"):
            px = rows
        elif raw in ("BGR;15", "BGR;16"):
            px = _unpack16(rows[:, :2 * w].copy().view("<u2"),
                           5 if raw == "BGR;15" else 6)
        else:
            px = rows.reshape(h, w, -1)[:, :, list(_RAW_RGB[raw])]
    if direction < 0:
        px = px[::-1]
    if raw == "1":                       # mode "1", then RGB
        return np.repeat((px * 255)[:, :, None], 3, axis=2)
    if pal is not None:
        return pal[px]
    return np.ascontiguousarray(px)


def _le(b: bytes, at: int, n: int) -> int:
    return int.from_bytes(b[at:at + n], "little")


def _vp8l_info(b: bytes):
    """VP8LGetInfo: (width, height) of a VP8L bitstream's header, or None
    (short, a bad signature or version)."""
    if len(b) < 5 or b[0] != 0x2F or b[4] >> 5:
        return None
    v = _le(b, 1, 4)
    return (v & 0x3FFF) + 1, (v >> 14 & 0x3FFF) + 1


def _vp8_info(b: bytes, size: int):
    """VP8GetInfo: (width, height) of a lossy key frame's header, or None."""
    if len(b) < 10 or b[3:6] != b"\x9d\x01\x2a":
        return None
    bits = _le(b, 0, 3)
    w, h = _le(b, 6, 2) & 0x3FFF, _le(b, 8, 2) & 0x3FFF
    if (bits & 1 or bits >> 1 & 7 > 3 or not bits >> 4 & 1
            or bits >> 5 >= size or not (w and h)):
        return None
    return w, h


class _WebPFrame:
    """A frame of libwebp's demuxer: its place on the canvas, its size (the
    image chunk's own), its image and ALPH chunks (offset, size with the
    chunk header; None until read) and its number, 0 until a chunk sets
    it."""

    def __init__(self, x=0, y=0, w=0, h=0):
        self.x, self.y, self.w, self.h = x, y, w, h
        self.image = self.alpha = None
        self.num = 0


class _WebPDemux:
    """libwebp's demuxer (src/demux/demux.c) over a whole file: the RIFF
    header, then a simple file (one VP8L or VP8 chunk and what follows it)
    or an extended one (VP8X, then its chunks, the frames of an animation
    in ANMF chunks), then the validation of either; any fault raises
    ValueError, as WebPDemux returns no demuxer. Bytes past the RIFF size
    are ignored; a file shorter than it is refused. The first chunk is one
    of VP8X, VP8L and VP8 (Pillow opens no other)."""

    def __init__(self, data: bytes):
        self.d = data
        if len(data) < 20:
            self.fail("truncated file")
        riff = _le(data, 4, 4)
        if not 8 <= riff <= _WEBP_MAX_PAYLOAD:
            self.fail(f"bad RIFF size {riff}")
        self.end = riff + 8
        if len(data) < self.end:
            self.fail("truncated file (shorter than its RIFF size)")
        self.pos, self.flags = 12, 0
        self.canvas, self.frames = None, []
        if data[12:16] == b"VP8X":
            self.vp8x()
            self.validate_extended()
        else:                           # simple: its image is the canvas
            self.single_image()

    @staticmethod
    def fail(what):
        raise ValueError(f"WebP: {what}")

    def avail(self):
        return self.end - self.pos

    def chunk_header(self):
        """(tag, size, padded size) of the chunk at pos, pos past its
        header; refused where the padded chunk reaches past the RIFF."""
        tag, size = self.d[self.pos:self.pos + 4], _le(self.d, self.pos + 4, 4)
        self.pos += 8
        if size > _WEBP_MAX_PAYLOAD or size + (size & 1) > self.avail():
            self.fail(f"chunk {tag!r} of {size} bytes past the RIFF size")
        return tag, size, size + (size & 1)

    def more_or_end(self):
        """At the end of the RIFF: True; else the next chunk's header must
        be there."""
        if self.pos == self.end:
            return True
        if self.avail() < 8:
            self.fail("truncated chunk header")
        return False

    def store_frame(self, num, min_size, f):
        """StoreFrame: the ALPH and image chunks of a frame, up to the
        first other chunk (or a second of either)."""
        if self.avail() < max(8, min_size):
            self.fail("truncated frame")
        while True:
            start = self.pos
            tag, _, padded = self.chunk_header()
            if tag == b"ALPH" and f.alpha is None:
                f.alpha, f.num = (start, 8 + padded), num
            elif tag == b"VP8L" and f.alpha is not None:
                self.fail("a VP8L chunk after an ALPH chunk")
            elif tag in (b"VP8 ", b"VP8L") and f.image is None:
                # WebPGetFeatures of the chunk: its header, whole
                head = self.d[start + 8:min(start + 18, self.pos + padded)]
                wh = (_vp8l_info(head) if tag == b"VP8L"
                      else _vp8_info(head, _le(self.d, start + 4, 4)))
                if wh is None:
                    self.fail(f"bad {tag.decode().strip()} header")
                f.w, f.h = wh
                f.image, f.num = (start, 8 + padded), num
            else:
                self.pos = start
                return
            self.pos += padded
            if self.more_or_end():
                return

    def single_image(self):
        if self.frames or self.avail() < 8:
            self.fail("misplaced image chunk")
        f = _WebPFrame()
        self.store_frame(1, 0, f)
        if not self.flags & _WEBP_ALPHA:
            f.alpha = None
        if self.canvas is None:
            self.canvas = (f.w, f.h)
        self.frames.append(f)

    def vp8x(self):
        if self.avail() < 8:
            self.fail("truncated VP8X chunk")
        _, size, padded = self.chunk_header()
        if size < 10:
            self.fail(f"VP8X chunk of {size} bytes")
        d, p = self.d, self.pos
        self.flags = d[p]
        self.canvas = 1 + _le(d, p + 4, 3), 1 + _le(d, p + 7, 3)
        if self.canvas[0] * self.canvas[1] >= 1 << 32:
            self.fail(f"canvas of {self.canvas[0]}x{self.canvas[1]}")
        self.pos += padded
        if self.avail() < 8:
            self.fail("no chunk after VP8X")
        animation = self.flags & _WEBP_ANIMATION
        anim_seen = False
        while True:
            start = self.pos
            tag, _, padded = self.chunk_header()
            if tag == b"VP8X":
                self.fail("a second VP8X chunk")
            if tag in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim_seen or animation:
                    self.fail("an image outside the animation's frames")
                self.pos = start
                self.single_image()
            elif tag == b"ANIM":
                if padded < 6:
                    self.fail("ANIM chunk too short")
                anim_seen = True
                self.pos += padded
            elif tag == b"ANMF":
                if not anim_seen:
                    self.fail("ANMF chunk before ANIM")
                self.anmf(padded, animation)
            else:                         # ICCP, EXIF, XMP, unknown
                self.pos += padded
            if self.more_or_end():
                return

    def anmf(self, size, animation):
        """ParseAnimationFrame: the ANMF header (offset / 2, size - 1,
        duration, flags), then its image chunks, which give the frame its
        size."""
        if self.avail() < 16 or size < 16:
            self.fail("ANMF chunk too short")
        d, p = self.d, self.pos
        f = _WebPFrame(2 * _le(d, p, 3), 2 * _le(d, p + 3, 3),
                       1 + _le(d, p + 6, 3), 1 + _le(d, p + 9, 3))
        if f.w * f.h >= 1 << 32:
            self.fail(f"frame of {f.w}x{f.h}")
        self.pos += 16
        self.store_frame(len(self.frames) + 1, size - 16, f)
        if self.pos - p - 16 > size - 16:
            self.fail("frame data past its ANMF chunk")
        if animation and f.num > 0:
            self.frames.append(f)

    def validate_extended(self):
        """IsValidExtendedFormat: known flags, some frame, each whole (an
        ALPH chunk before its image), on the canvas (the whole canvas
        without animation)."""
        animation = self.flags & _WEBP_ANIMATION
        if not self.frames or self.flags & ~_WEBP_VALID_FLAGS:
            self.fail("no frame, or unknown VP8X flags")
        cw, ch = self.canvas
        for f in self.frames:
            if not animation and f.num > 1:
                self.fail("more than one image without animation")
            if f.image is None or (f.alpha is not None
                                   and f.alpha[0] > f.image[0]):
                self.fail("an incomplete frame")
            if animation:
                inside = f.x + f.w <= cw and f.y + f.h <= ch
            else:
                inside = (f.x, f.y, f.w, f.h) == (0, 0, cw, ch)
            if not inside:
                self.fail(f"a frame of {f.w}x{f.h} at ({f.x}, {f.y}) off "
                          f"the {cw}x{ch} canvas")


def _check_alph(chunk: bytes, w: int, h: int) -> None:
    """An ALPH chunk's payload, as libwebp's ALPHInit and ALPHDecode refuse
    it: no data past the header byte; a compression other than none (0)
    or VP8L (1), a pre-processing past level reduction (1), reserved bits
    set; raw data shorter than the w x h plane; a VP8L stream (no header
    of its own, the frame's size) that ``isc_vp8l_alpha_check`` refuses.
    The alpha is not decoded further: PIL's RGB does not depend on it."""
    if len(chunk) <= 1:
        raise ValueError("WebP: empty ALPH chunk")
    method, pre, reserved = chunk[0] & 3, chunk[0] >> 4 & 3, chunk[0] >> 6
    if method > 1 or pre > 1 or reserved:
        raise ValueError(f"WebP: bad ALPH header {chunk[0]:#04x}")
    if method == 0:
        if len(chunk) - 1 < w * h:
            raise ValueError("WebP: truncated raw ALPH data")
        return
    body = chunk[1:]
    _call(_lib().isc_vp8l_alpha_check, body, len(body), w, h)


def _decode_webp(data: bytes) -> np.ndarray:
    """A WebP file as PIL opens it (its WebPAnimDecoder, libwebp 1.6): the
    container checked as libwebp's demuxer and WebPGetFeatures check it,
    then the first frame decoded onto a canvas cleared to transparent
    black, at the frame's offset (the first frame of an animation is a key
    frame: no blending, ANIM's background colour unused): a VP8L bitstream
    by ``isc_vp8l_decode``, a VP8 key frame by ``isc_vp8_decode``, with
    its ALPH chunk, where the demuxer keeps one, checked by ``_check_alph``
    (decoded as far as libwebp refuses it). RGB always: a grey or paletted
    image was coded as ARGB or YUV 4:2:0; the alpha is dropped, the RGB
    under it kept exactly (libwebp's RGBA is not premultiplied)."""
    if data[12:16] not in (b"VP8 ", b"VP8L", b"VP8X"):   # Pillow's _accept
        raise ValueError(f"WebP: unknown first chunk {data[12:16]!r}")
    # the animation decoder's WebPGetFeatures of the whole file refuses a
    # VP8X chunk of another size than 10 (its other checks are the
    # demuxer's too)
    if data[12:16] == b"VP8X" and _le(data, 16, 4) != 10:
        raise ValueError("WebP: VP8X chunk not of 10 bytes")
    demux = _WebPDemux(data)
    cw, ch = demux.canvas
    _check_pixels(ch, cw)
    f = demux.frames[0]
    start, size = f.image
    frame = np.empty((f.h, f.w, 3), np.uint8)
    body = data[start + 8:start + size]
    lossless = data[start:start + 4] == b"VP8L"
    _call(_lib().isc_vp8l_decode if lossless else _lib().isc_vp8_decode,
          body, len(body), frame.ctypes.data, f.w, f.h)
    if f.alpha is not None:             # a VP8 frame's: VP8L has no ALPH
        a = f.alpha[0] + 8
        _check_alph(data[a:a + _le(data, a - 4, 4)], f.w, f.h)
    if (f.w, f.h) == (cw, ch):
        return frame
    canvas = np.zeros((ch, cw, 3), np.uint8)
    canvas[f.y:f.y + f.h, f.x:f.x + f.w] = frame
    return canvas


# TIFF, as Pillow 12.1's TiffImagePlugin reads it: a signature of
# ``_accept``; the field types (size, struct code of one value; None: the
# bytes, or the text for ASCII; the rationals two codes), of which Pillow's
# ImageFileDirectory_v2 loads all but SLONG8 and IFD8 and libtiff reads the
# integer ones (``_LIBTIFF_INTS``) where it wants a number; the tags whose
# value is a single one (the first of the entry's; every other tag a
# tuple), the names that an ASCII value of a tag stands for (TiffTags'
# enums); COMPRESSION_INFO (1 is Pillow's raw decoders', the rest
# libtiff's; the port reads 1, PackBits, LZW, Deflate, JPEG and CCITT)
_TIFF_SIGS = (b"MM\0*", b"II*\0", b"MM*\0", b"II\0*", b"MM\0+", b"II+\0")
_TIFF_TYPES = {1: (1, None), 2: (1, None), 3: (2, "H"), 4: (4, "L"),
               5: (8, "L"), 6: (1, "b"), 7: (1, None), 8: (2, "h"),
               9: (4, "l"), 10: (8, "l"), 11: (4, "f"), 12: (8, "d"),
               13: (4, "L"), 16: (8, "Q"), 17: (8, "q"), 18: (8, "Q")}
_TIFF_PIL_SKIPS = (17, 18)
_LIBTIFF_INTS = (1, 3, 4, 6, 8, 9, 16, 17)
_INT_MAX = (1 << 31) - 1                # Pillow's bound on a strip or tile
_TIFF_SCALAR = {256, 257, 259, 262, 266, 274, 277, 278, 284, 317, 322, 323}
_TIFF_ENUMS = {
    259: {"Uncompressed": 1, "CCITT 1d": 2, "Group 3 Fax": 3,
          "Group 4 Fax": 4, "LZW": 5, "JPEG": 6, "PackBits": 32773},
    262: {"WhiteIsZero": 0, "BlackIsZero": 1, "RGB": 2, "RGB Palette": 3,
          "Transparency Mask": 4, "CMYK": 5, "YCbCr": 6, "CieLAB": 8,
          "CFA": 32803, "LinearRaw": 32892},
    284: {"Contiguous": 1, "Separate": 2},
    317: {"none": 1, "Horizontal Differencing": 2}}
_TIFF_CODECS = {1: "raw", 2: "CCITT RLE", 3: "CCITT Group 3",
                4: "CCITT Group 4", 5: "LZW", 6: "old-style JPEG", 7: "JPEG",
                8: "Deflate", 32771: "CCITT RLEW", 32773: "PackBits",
                32809: "ThunderScan", 32946: "Deflate", 34676: "SGILog",
                34677: "SGILog24", 34925: "LZMA", 50000: "Zstandard",
                50001: "WebP"}


def _tiff_open_info():
    """Pillow's OPEN_INFO: (byte order, photometric, sample format, fill
    order, bits per sample, extra samples) -> (mode, raw mode)."""
    both, info = (b"II", b"MM"), {}

    def put(orders, photo, fmt, fill, bits, extra, mode, raw):
        for o in orders:
            info[(o, photo, (fmt,), fill, bits, extra)] = (mode, raw)
    for depth in (1, 2, 4, 8):           # grey, min-is-white and -black
        base = "1" if depth == 1 else "L" if depth == 8 else f"L;{depth}"
        for photo, inv in ((0, "I"), (1, "")):
            for fill, rev in ((1, ""), (2, "R")):
                suffix = inv + rev
                raw = base + (";" if suffix and ";" not in base else "") + (
                    suffix)
                put(both, photo, 1, fill, (depth,), (),
                    "1" if depth == 1 else "L", raw)
        for fill, rev in ((1, ""), (2, "R")):          # palette
            raw = "P" + (f";{depth}" if depth < 8 else "") + (
                (rev if depth < 8 else ";R") if rev else "")
            put(both, 3, 1, fill, (depth,), (), "P", raw)
    put(both, 1, 2, 1, (8,), (), "L", "L")
    put((b"II",), 1, 1, 1, (12,), (), "I;16", "I;12")
    put((b"II",), 0, 1, 1, (16,), (), "I;16", "I;16")
    put((b"II",), 1, 1, 1, (16,), (), "I;16", "I;16")
    put((b"MM",), 1, 1, 1, (16,), (), "I;16B", "I;16B")
    put((b"II",), 1, 1, 2, (16,), (), "I;16", "I;16R")
    put((b"II",), 1, 2, 1, (16,), (), "I", "I;16S")
    put((b"MM",), 1, 2, 1, (16,), (), "I", "I;16BS")
    for photo in (0, 1):
        put((b"II",), photo, 3, 1, (32,), (), "F", "F;32F")
        put((b"MM",), photo, 3, 1, (32,), (), "F", "F;32BF")
    put((b"II",), 1, 1, 1, (32,), (), "I", "I;32N")
    put((b"II",), 1, 2, 1, (32,), (), "I", "I;32S")
    put((b"MM",), 1, 2, 1, (32,), (), "I", "I;32BS")
    put(both, 1, 1, 1, (8, 8), (2,), "LA", "LA")
    put(both, 2, 1, 1, (8, 8, 8), (), "RGB", "RGB")
    put(both, 2, 1, 2, (8, 8, 8), (), "RGB", "RGB;R")
    put(both, 2, 1, 1, (8,) * 4, (), "RGBA", "RGBA")
    for extra, raw in (((0,), "RGBX"), ((0, 0), "RGBXX"),
                       ((0, 0, 0), "RGBXXX")):
        put(both, 2, 1, 1, (8,) * (3 + len(extra)), extra, "RGB", raw)
    for first, name in ((1, "RGBa"), (2, "RGBA")):
        for pad in range(3):
            extra = (first,) + (0,) * pad
            put(both, 2, 1, 1, (8,) * (4 + pad), extra, "RGBA",
                name + "X" * pad)
    put(both, 2, 1, 1, (8,) * 4, (999,), "RGBA", "RGBA")
    for o, e in ((b"II", "L"), (b"MM", "B")):
        put((o,), 2, 1, 1, (16,) * 3, (), "RGB", "RGB;16" + e)
        put((o,), 2, 1, 1, (16,) * 4, (), "RGBA", "RGBA;16" + e)
        put((o,), 2, 1, 1, (16,) * 4, (0,), "RGB", "RGBX;16" + e)
        put((o,), 2, 1, 1, (16,) * 4, (1,), "RGBA", "RGBa;16" + e)
        put((o,), 2, 1, 1, (16,) * 4, (2,), "RGBA", "RGBA;16" + e)
        put((o,), 5, 1, 1, (16,) * 4, (), "CMYK", "CMYK;16" + e)
    put(both, 3, 1, 1, (8, 8), (0,), "P", "PX")
    put(both, 3, 1, 1, (8, 8), (2,), "PA", "PA")
    for pad in range(3):
        put(both, 5, 1, 1, (8,) * (4 + pad), (0,) * pad, "CMYK",
            "CMYK" + "X" * pad)
    put(both, 6, 1, 1, (8,), (), "L", "L")
    put(both, 6, 1, 1, (8, 8, 8), (), "RGB", "RGBX")
    put(both, 8, 1, 1, (8, 8, 8), (), "LAB", "LAB")
    return info


_TIFF_OPEN = _tiff_open_info()
# the bands of the modes of more than one that the raw route's planar
# layers fill (Pillow's unpackers of one character; "LA" and "PA" have
# none), and the number of bands of each mode in Pillow's images
_TIFF_BANDS = {"RGB": "RGB", "RGBA": "RGBA", "CMYK": "CMYK", "LAB": "LAB"}
_TIFF_NBANDS = {"LA": 2, "PA": 2, "RGB": 3, "LAB": 3, "RGBA": 4, "CMYK": 4}
# Pillow's ImageFile maps a file of one tile whose raw mode is its mode
# (Image._MAPMODES) rather than decoding it: bytes a pixel
_TIFF_MAP = {"L": 1, "P": 1, "I;16": 2, "I;16B": 2, "RGBA": 4, "CMYK": 4}
_BITREV = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
# JPEG in TIFF: the bytes of the tables a page's streams share
# (``isc_tiff_jpeg``'s TiffJpegTables); the field types libtiff reads
# JPEGTables from (TIFFReadDirEntryByteArray); YCbCrSubsampling's values
# that its strip and tile sizes take
_TIFF_JPEG_STATE = 4096
_LIBTIFF_BYTES = (2, 7) + _LIBTIFF_INTS
_YCBCR_FACTORS = (1, 2, 4)
# YCbCr through libtiff's RGBA interface (tif_getimage.c): the field types
# TIFFReadDirEntryFloatArray reads (the integers, the rationals, FLOAT and
# DOUBLE); the subsamplings its put routines take in one plane
# (putcontig8bitYCbCr{44,42,41,22,21,12,11}tile), separate planes taking
# 1 x 1 alone; TIFFGetFieldDefaulted's YCbCrCoefficients and (for YCbCr)
# ReferenceBlackWhite
_LIBTIFF_FLOATS = _LIBTIFF_INTS + (5, 10, 11, 12)
_YCBCR_CONTIG = ((4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1))
_YCBCR_LUMA = (0.299, 0.587, 0.114)
_YCBCR_REFBW = (0.0, 255.0, 128.0, 255.0, 128.0, 255.0)
# CCITT (``_TiffFax``): each compression's decoder in ``isc_tiff_fax``
# (Group 3 is 2 or, with T4Options bit 0, 3); the refusal of a page that
# libtiff decodes but leaves partly unwritten, where PIL shows whatever its
# buffer held
_TIFF_FAX = {"CCITT RLE": 0, "CCITT RLEW": 1, "CCITT Group 3": 2,
             "CCITT Group 4": 4}
_TIFF_FAX_UNWRITTEN = ("unsupported: TIFF CCITT rows that libtiff leaves "
                       "unwritten (PIL shows what its buffer held there)")


def _tiff_raw_bits(raw: str):
    """Bits a pixel of a raw mode Pillow unpacks (Unpack.c), or None where
    it has no unpacker for it (``L;IR``, ``P;1R``, ``P;2R``, ``P;4R``
    among OPEN_INFO's)."""
    if raw in ("L;IR", "P;1R", "P;2R", "P;4R"):
        return None
    if raw in ("I", "F"):
        return 32
    if len(raw) == 1:                   # a planar layer (or L, P)
        return 1 if raw == "1" else 8
    if raw.startswith("1"):
        return 1
    if raw[:2] in ("L;", "P;") and raw[2] in "124":
        return int(raw[2])
    if raw in ("L;I", "L;R", "P;R"):
        return 8
    if raw == "I;12":
        return 12
    if raw.startswith(("I;16", "F;32", "I;32")):
        return int(raw[2:4])
    wide = 16 if ";16" in raw else 8
    return wide * len(raw.split(";")[0])


def _tiff_unpack(raw: str, mode: str, rows: np.ndarray, xs: int):
    """[n, rowbytes] uint8 rows -> [n, xs] or [n, xs, bands] values of
    ``mode`` as Pillow's unpacker ``raw`` leaves them: "1" as 0 / 255,
    "I;16" and "I;16B" as uint16, "I" as int32, "F" as float32, the rest
    uint8 ("LA" and "PA" as two bands, L and A, P and A)."""
    n = rows.shape[0]
    name, _, suffix = raw.partition(";")
    if len(raw) == 1 and raw in "IF":   # a planar layer of I or F
        return np.ascontiguousarray(rows[:, :4 * xs]).view(
            "=i4" if raw == "I" else "=f4").copy()
    if name in ("1", "L", "P") and not suffix.startswith(("16", "12")):
        depth = _tiff_raw_bits(raw)
        if "R" in suffix:               # fill order 2: bits reversed
            rows = _BITREV[rows]
        v = _unpack_bits(rows, depth, xs) if depth < 8 else rows[:, :xs]
        top = (1 << depth) - 1
        if "I" in suffix:
            v = top - v
        if mode == "P":
            return v
        return v * np.uint8(255 // top)     # "1": 0 / 255; L;2, L;4 scaled
    if raw == "I;12":                   # two samples in three bytes
        t = np.pad(rows, ((0, 0), (0, 3)))[:, :(xs + 1) // 2 * 3]
        t = t.reshape(n, -1, 3).astype(np.uint16)
        v = np.stack([t[:, :, 0] << 4 | t[:, :, 1] >> 4,
                      (t[:, :, 1] & 15) << 8 | t[:, :, 2]], -1)
        return v.reshape(n, -1)[:, :xs]
    if name in ("I", "F"):              # I;16*, I;32*, F;32*
        if suffix == "16R":
            rows = _BITREV[rows]
        size = 2 if suffix.startswith("16") else 4
        kind = ("f" if name == "F" else
                "i" if suffix.endswith("S") or size == 4 else "u")
        order = (">" if suffix[2:3] == "B" else
                 "=" if suffix.endswith("N") else "<")
        v = np.ascontiguousarray(rows[:, :xs * size]).view(
            order + kind + str(size))
        return v.astype({"I": np.int32, "F": np.float32}.get(mode,
                                                             np.uint16))
    if len(raw) == 1:                   # a planar layer: 8 bits
        return rows[:, :xs]
    if suffix == "R":                   # RGB;R: fill order 2
        rows = _BITREV[rows]
    # interleaved samples: 8 bits, or the high byte of 16 (the second
    # byte of little-endian and, on this host, native order)
    wide = suffix.startswith("16")
    per = len(name) * (2 if wide else 1)
    px = rows[:, :xs * per].reshape(n, xs, per)
    if wide:
        px = px[:, :, 0::2] if suffix == "16B" else px[:, :, 1::2]
    if name == "PX":
        return px[:, :, 0]
    bands = {"LA": 2, "PA": 2, "LAB": 3}.get(
        name, 4 if mode in ("RGBA", "CMYK") else 3)
    v = px[:, :, :bands]
    if name == "LAB":                   # a* and b* stored signed
        return v ^ np.array([0, 128, 128], np.uint8)
    if name.startswith("RGBa"):         # premultiplied: undone
        return _tiff_unpremultiply(v)
    return v


def _tiff_unpremultiply(v: np.ndarray) -> np.ndarray:
    """Pillow's RGBa -> RGBA: each colour times 255 over the alpha,
    clipped (a transparent pixel black, an opaque one as it is)."""
    a = v[:, :, 3:].astype(np.int32)
    c = np.minimum(v[:, :, :3] * np.int32(255) // np.maximum(a, 1), 255)
    c = np.where(a == 0, 0, np.where(a == 255, v[:, :, :3], c))
    return np.concatenate([c, a], -1).astype(np.uint8)


def _tiff_entries(data: bytes, at: int, big: bool, e: str):
    """The IFD at ``at`` as it stands: (its count of entries, [(tag, type,
    count, the value field's bytes)] for as many entries as the file
    holds)."""
    head, entry, inline = (8, 20, 8) if big else (2, 12, 4)
    if at + head > len(data):
        return 0, []
    (count,) = struct.unpack(e + ("Q" if big else "H"), data[at:at + head])
    entries = []
    for pos in range(at + head, at + head + count * entry, entry):
        if pos + entry > len(data):
            break
        tag, typ, n = struct.unpack(e + ("HHQ" if big else "HHL"),
                                    data[pos:pos + entry - inline])
        entries.append((tag, typ, n, data[pos + entry - inline:pos + entry]))
    return count, entries


def _tiff_tags(data: bytes, entries, big: bool, e: str) -> dict:
    """ImageFileDirectory_v2.load of an IFD's entries: {tag: (type, its
    bytes)}. An entry of a type Pillow has no loader for, or with no data,
    is skipped; an entry's data that reaches past the end of the file ends
    the reading, keeping what was read (Pillow warns), as does a table
    that does (``_tiff_entries`` holds no more)."""
    tags, inline = {}, 8 if big else 4
    for tag, typ, n, field in entries:
        if typ not in _TIFF_TYPES or typ in _TIFF_PIL_SKIPS:
            continue
        size = n * _TIFF_TYPES[typ][0]
        if size > inline:
            (off,) = struct.unpack(e + ("Q" if big else "L"), field)
            if off + size > len(data):
                return tags
            field = data[off:off + size]
        if size:
            tags[tag] = (typ, field[:size])
    return tags


def _tiff_value(tag: int, typ: int, raw: bytes, e: str):
    """A tag's value as ImageFileDirectory_v2 gives it: BYTE data as
    bytes, ASCII as text (a name in ``_TIFF_ENUMS`` as its number), the
    rationals as fractions (NaN over 0), the numbers as numbers; a tag of
    ``_TIFF_SCALAR`` its first value, any other a tuple (BYTE's bytes
    whole)."""
    if typ == 1:
        return raw
    if typ in (2, 7):
        if typ == 2:
            text = (raw[:-1] if raw.endswith(b"\0") else raw).decode(
                "latin-1", "replace")
            raw = _TIFF_ENUMS.get(tag, {}).get(text, text)
        return raw if tag in _TIFF_SCALAR else (raw,)
    code = _TIFF_TYPES[typ][1]
    vals = struct.unpack(f"{e}{len(raw) // struct.calcsize('=' + code)}"
                         f"{code}", raw)
    if typ in (5, 10):
        vals = tuple(Fraction(a, b) if b else math.nan
                     for a, b in zip(vals[::2], vals[1::2]))
    return vals[0] if tag in _TIFF_SCALAR else vals


class _Tiff:
    """The first page of a TIFF as Pillow's TiffImageFile sets it up
    (``_open``, ``_seek(0)``, ``_setup``): its size, orientation, mode and
    raw mode, compression and the tags; every fault Pillow raises at open
    raises ValueError."""

    def __init__(self, data: bytes):
        if len(data) < 8 or (data[2] == 43 and len(data) < 16):
            raise ValueError("TIFF: truncated header")
        self.data, self.big = data, data[2] == 43
        self.e = e = "<" if data[:2] == b"II" else ">"
        (first,) = struct.unpack(e + "Q", data[8:16]) if self.big else (
            struct.unpack(e + "L", data[4:8]))
        if not first:
            raise ValueError("TIFF: no image in the file")
        if first >= 1 << 63:
            raise ValueError("TIFF: no image at the first IFD's offset")
        self.ifd = first
        self.nentries, self.entries = _tiff_entries(data, first, self.big, e)
        raw = _tiff_tags(data, self.entries, self.big, e)
        self.tags = {t: _tiff_value(t, ty, b, e) for t, (ty, b) in raw.items()}
        try:
            self.setup()
        except (TypeError, IndexError, KeyError) as err:
            raise ValueError(f"TIFF: bad tags ({err!r})") from None

    def get(self, tag, default=None):
        return self.tags.get(tag, default)

    def setup(self):
        get = self.get
        if 0xBC01 in self.tags:
            raise ValueError("TIFF: a Windows Media Photo file")
        code = get(259, 1)
        if code not in _TIFF_CODECS:
            raise ValueError(f"TIFF: unknown compression {code!r}")
        self.compression = code
        self.planar = get(284, 1)
        photo = get(262, 0)
        if _TIFF_CODECS[code] == "old-style JPEG":
            photo = 6
        fill = get(266, 1)
        if 256 not in self.tags or 257 not in self.tags:
            raise ValueError("TIFF: missing dimensions")
        self.w, self.h = get(256), get(257)
        if not (isinstance(self.w, int) and isinstance(self.h, int)):
            raise ValueError("TIFF: invalid dimensions")
        self.orientation = get(274)
        fmt = get(339, (1,))
        if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
            fmt = (1,)
        bps = get(258, (1,))
        extra = get(338, ())
        count = (3 if photo in (2, 6, 8) else 4 if photo == 5 else 1) + (
            len(extra))
        spp = get(277, 3 if _TIFF_CODECS[code] == "old-style JPEG"
                  and photo in (2, 6) else 1)
        if spp > 6:
            raise ValueError(f"TIFF: {spp} samples per pixel")
        if spp < len(bps):
            bps = bps[:spp]
        elif spp > len(bps) and len(bps) == 1:
            bps = bps * spp
        if len(bps) != spp:
            raise ValueError("TIFF: unknown data organization")
        key = (self.data[:2], photo, fmt, fill, bps, extra)
        if key not in _TIFF_OPEN:
            raise ValueError(f"TIFF: unknown pixel mode {key[1:]}")
        self.mode, self.raw = _TIFF_OPEN[key]
        self.key, self.photo, self.fill = key, photo, fill
        self.bps, self.spp, self.count = bps, spp, count
        if self.mode in ("P", "PA"):    # ColorMap: R, then G, then B
            cmap = [v // 256 & 255 for v in self.tags[320]]
            n = len(cmap) // 3
            if n > 256:
                raise ValueError(f"TIFF: a palette of {n} entries")
            self.palette = np.zeros((256, 3), np.uint8)
            self.palette[:n] = np.array(cmap[:3 * n], np.uint8).reshape(
                3, n).T

    def raw_tiles(self):
        """Pillow's tiles of the raw route (``_setup``): [(offset, (x0,
        y0, x1, y1), raw mode, stride)], one a strip or tile offset, the
        last offset alone where one strip or tile covers the image (planar
        1), an edge tile's rows at the tile's stride, a planar layer's raw
        mode the raw mode's character at its index."""
        get = self.get
        if 273 in self.tags:
            offsets, h, w = self.tags[273], get(278, self.h), self.w
        elif 324 in self.tags:
            offsets, w, h = self.tags[324], get(322), get(323)
            if not (isinstance(w, int) and isinstance(h, int)):
                raise ValueError("TIFF: invalid tile dimensions")
        else:
            raise ValueError("TIFF: no strip or tile offsets")
        if w == self.w and h == self.h and self.planar != 2:
            offsets = offsets[-1:]
        tiles, x, y, layer = [], 0, 0, 0
        for offset in offsets:
            stride = w * sum(self.bps) / 8 if x + w > self.w else 0
            raw = self.raw
            if self.planar == 2:
                raw = self.raw[layer]
                stride /= self.count
            tiles.append((offset, (x, y, min(x + w, self.w),
                                   min(y + h, self.h)), raw, int(stride)))
            x += w
            if x >= self.w:
                x, y = 0, y + h
                if y >= self.h:
                    y, layer = 0, layer + 1
        return tiles


class _LibTiff:
    """The first IFD as libtiff 4.7's TIFFReadDirectory reads it for
    Pillow's libtiff decoder. The table whole (1 to 4096 entries), a tag's
    first entry; SamplesPerPixel, Compression, the dimensions, PlanarConfig,
    RowsPerStrip, ExtraSamples, the per-sample BitsPerSample, SampleFormat
    and Min/MaxSampleValue, the offsets and byte counts read strictly (a
    type that is not an integer's, a count or value it refuses, data past
    the end of the file raise ValueError, where libtiff fails the
    directory), FillOrder, Predictor and Photometric leniently (a fault
    leaves the default). The offsets and byte counts as TIFFFetchStripThing
    reads them (no more than the strips, too few padded with zeros);
    missing byte counts, or one strip's of 0, as EstimateStripByteCounts
    makes them."""

    def __init__(self, t: _Tiff):
        self.t = t
        if not 0 < t.nentries <= 4096 or len(t.entries) < t.nentries:
            raise ValueError("TIFF: a directory that libtiff cannot read")
        self.first = {}
        for ent in t.entries:
            self.first.setdefault(ent[0], ent)
        self.spp = self.number(277, 1, 0xFFFF)
        if not self.spp:
            raise ValueError("TIFF: 0 samples per pixel")
        try:
            self.compression = self.number(259, 1, 0xFFFF)
        except ValueError:
            self.compression = self.per_sample(259, 1)
        self.w, self.h = self.number(256, 0), self.number(257, 0)
        self.tw, self.tl = self.number(322, 0), self.number(323, 0)
        self.planar = self.number(284, 1, 0xFFFF)
        self.rps = self.number(278, None)
        extra = self.ints(self.first[338]) if 338 in self.first else ()
        if self.planar not in (1, 2) or self.rps == 0 or len(extra) > (
                self.spp) or any(v > 2 and v != 999 for v in extra):
            raise ValueError("TIFF: a value that libtiff refuses")
        if 256 not in self.first and 257 not in self.first:
            raise ValueError("TIFF: no ImageLength")
        self.tiled = 322 in self.first or 323 in self.first
        if self.tiled:
            self.nstrips = -(-self.w // self.tw) * -(-self.h // self.tl) if (
                self.tw and self.tl) else 0
        elif self.rps in (None, 0xFFFFFFFF):
            self.nstrips = 1
        else:                           # TIFFhowmany_32, 0 on overflow
            self.nstrips = -(-self.h // self.rps) if (
                self.h < 0xFFFFFFFF - (self.rps - 1)) else 0
        if self.planar == 2:
            self.nstrips *= self.spp
        if not self.nstrips:
            raise ValueError("TIFF: no strips or tiles")
        where = [e for e in t.entries if e[0] in (273, 324)]
        if not where:
            raise ValueError("TIFF: no strip or tile offsets")
        self.bps = self.per_sample(258, 1)
        fmt = self.per_sample(339, 1)
        self.per_sample(280, 0)
        self.per_sample(281, 0)
        if not 1 <= fmt <= 6:
            raise ValueError(f"TIFF: sample format {fmt}")
        self.fmt = fmt
        self.offsets = self.strips(self.first[where[-1][0]])
        counts = [e for e in t.entries if e[0] in (279, 325)]
        self.counts = self.strips(self.first[counts[-1][0]]) if counts else (
            None)
        self.fill = self.lenient(266, 1)
        if self.fill not in (1, 2):
            self.fill = 1
        self.photo = self.lenient(262, None)
        if self.photo == 3 and self.bps < 8 and not self.colormap():
            raise ValueError("TIFF: no ColorMap that libtiff reads")
        self.predictor = self.lenient(317, 1)
        if self.counts is None:
            if self.nstrips != (self.spp if self.planar == 2 else 1):
                raise ValueError("TIFF: missing StripByteCounts")
            self.counts = self.estimate()
        elif (self.nstrips == 1 and not self.tiled and self.offsets[0]
              and not self.counts[0]):
            self.counts = self.estimate()

    def ints(self, entry, limit=None, types=_LIBTIFF_INTS):
        """TIFFReadDirEntry*Array's integers of an entry: its first
        ``limit`` values, its field holding them where its whole count
        fits there; a negative value refused."""
        tag, typ, n, field = entry
        t = self.t
        if typ not in types:
            raise ValueError(f"TIFF: tag {tag} of a type libtiff refuses")
        size, code = _TIFF_TYPES[typ]
        code = code or "B"
        take = n if limit is None else min(n, limit)
        inline = 8 if t.big else 4
        if min(n, 10) * size > inline:
            (off,) = struct.unpack(t.e + ("Q" if t.big else "L"),
                                   field[:inline])
            if off + take * size > len(t.data):
                raise ValueError(f"TIFF: tag {tag}'s data past the end of "
                                 "the file")
            field = t.data[off:off + take * size]
        vals = struct.unpack(f"{t.e}{take}{code}", field[:take * size])
        if vals and min(vals) < 0:
            raise ValueError(f"TIFF: tag {tag}'s value out of range")
        return vals

    def number(self, tag, default, top=0xFFFFFFFF):
        """TIFFReadDirEntryShort (``top`` 0xFFFF) or Long of a tag read
        strictly: one value, in range."""
        if tag not in self.first:
            return default
        entry = self.first[tag]
        if entry[2] != 1:
            raise ValueError(f"TIFF: tag {tag} of {entry[2]} values")
        (v,) = self.ints(entry, types=_LIBTIFF_INTS + (
            (13, 18) if top > 0xFFFF else ()))
        if v > top:
            raise ValueError(f"TIFF: tag {tag}'s value out of range")
        return v

    def per_sample(self, tag, default):
        """TIFFReadDirEntryPersampleShort where one value is not given: a
        value a sample, all the same."""
        if tag not in self.first or self.first[tag][2] == 1:
            return self.number(tag, default, 0xFFFF)
        entry = self.first[tag]
        if entry[2] < self.spp:
            raise ValueError(f"TIFF: tag {tag} of too few values")
        vals = self.ints(entry)
        if max(vals) > 0xFFFF or len(set(vals[:self.spp])) > 1:
            raise ValueError(f"TIFF: tag {tag} of different values a "
                             "sample")
        return vals[0]

    def lenient(self, tag, default, top=0xFFFF):
        """A tag libtiff reads leniently: the default where it cannot."""
        try:
            return self.number(tag, default, top)
        except ValueError:
            return default

    def colormap(self) -> bool:
        """Whether libtiff keeps the ColorMap: after BitsPerSample in the
        table, of 3 x 2^bits values that it reads."""
        order = [e[0] for e in self.t.entries]
        entry = self.first.get(320)
        if entry is None or 258 not in order[:order.index(320)] or (
                entry[2] != 3 << self.bps):
            return False
        try:
            return max(self.ints(entry)) <= 0xFFFF
        except ValueError:
            return False

    def byte_array(self, entry):
        """TIFFReadDirEntryByteArray of an entry: BYTE, ASCII and
        UNDEFINED data as it is, the integer types' values where all are
        0-255; None where libtiff refuses it (or has no data), which
        leaves the tag unset."""
        tag, typ, n, field = entry
        t = self.t
        if typ not in _LIBTIFF_BYTES or not n:
            return None
        size, code = _TIFF_TYPES[typ]
        if n * size > (8 if t.big else 4):
            (off,) = struct.unpack(t.e + ("Q" if t.big else "L"),
                                   field[:8 if t.big else 4])
            if off + n * size > len(t.data):
                return None
            field = t.data[off:off + n * size]
        raw = field[:n * size]
        if typ in (1, 2, 7):
            return raw
        vals = struct.unpack(f"{t.e}{n}{code}", raw)
        return bytes(vals) if min(vals) >= 0 and max(vals) <= 255 else None

    def jpeg(self):
        """The JPEG codec's fields (TIFFInitJPEG's): JPEGTables (347,
        None where unset: of no values, or refused), and YCbCrSubsampling
        (530) as JPEGSetupDecode takes it: a pair read strictly, else, for
        a YCbCr page of three samples in one plane, the first strip's
        frame header's (JPEGFixupTagsSubsampling), else 2, 2."""
        entry = self.first.get(347)
        tables = self.byte_array(entry) if entry else None
        sub = self.pair(530)
        if sub is None and self.photo == 6 and self.planar == 1 and (
                self.spp == 3) and self.offsets[0]:
            sub = _jpeg_frame_sampling(self.t.data, self.offsets[0],
                                       self.counts[0], self.spp)
        return tables, tuple(sub or (2, 2))

    def pair(self, tag):
        """A pair of SHORTs as TIFFFetchNormalTag reads one
        (TIFF_SETGET_UINT16_PAIR: two values, TIFFReadDirEntryShortArray's
        integers in range), or None where it leaves the tag unset."""
        entry = self.first.get(tag)
        if entry is None or entry[2] != 2:
            return None
        try:
            vals = self.ints(entry)
        except ValueError:
            return None
        return vals if max(vals) <= 0xFFFF else None

    def floats(self, tag, count):
        """``count`` floats as TIFFFetchNormalTag reads them
        (TIFF_SETGET_C0_FLOAT, TIFFReadDirEntryFloatArray), float32: an
        integer's value, a rational's numerator over its denominator each
        as a float (0 over 0; an SRATIONAL's denominator read unsigned), a
        double clamped to +-FLT_MAX; None where
        libtiff leaves the tag unset (another count or type, data past the
        end of the file)."""
        entry = self.first.get(tag)
        if entry is None or entry[2] != count or entry[1] not in (
                _LIBTIFF_FLOATS):
            return None
        t, typ = self.t, entry[1]
        size, code = _TIFF_TYPES[typ]
        code, field = code or "B", entry[3]
        if count * size > len(field):
            (off,) = struct.unpack(t.e + ("Q" if t.big else "L"), field)
            if off + count * size > len(t.data):
                return None
            field = t.data[off:off + count * size]
        vals = np.array(struct.unpack(
            f"{t.e}{count * (2 if typ in (5, 10) else 1)}{code}",
            field[:count * size]))
        f32 = np.float32
        if typ in (5, 10):              # an SRATIONAL's denominator unsigned
            num, den = vals[0::2].astype(f32), (vals[1::2] % (1 << 32)
                                                ).astype(f32)
            with np.errstate(divide="ignore", invalid="ignore"):
                return np.where(den == 0, f32(0), num / den).astype(f32)
        if typ == 12:
            top = float(np.finfo(f32).max)
            vals = np.where(vals > top, top, np.where(vals < -top, -top,
                                                      vals))
        return vals.astype(f32)

    def strips(self, entry) -> list:
        """TIFFFetchStripThing: the first ``nstrips`` values; too few
        padded with zeros, up to a million strips."""
        vals = list(self.ints(entry, self.nstrips))
        if len(vals) < self.nstrips:
            if self.nstrips > 1000000:
                raise ValueError(f"TIFF: {entry[2]} offsets or byte counts "
                                 f"for {self.nstrips} strips")
            vals += [0] * (self.nstrips - len(vals))
        return vals

    def estimate(self) -> list:
        """EstimateStripByteCounts of a compressed page: the file's size
        less the header, the table and every entry's values kept outside
        it (all of the file where that is more), a plane's share under
        planar 2; the last cut at the end of the file (0 from past it)."""
        t = self.t
        size = len(t.data)
        inline = 8 if t.big else 4
        space = (16 + 8 + t.nentries * 20 + 8) if t.big else (
            8 + 2 + t.nentries * 12 + 4)
        for tag, typ, n, _ in t.entries:
            if typ not in _TIFF_TYPES:
                raise ValueError(f"TIFF: an entry of unknown type {typ}")
            width = _TIFF_TYPES[typ][0] * n
            space += width if width > inline else 0
        space = size if size < space else size - space
        if self.planar == 2:
            space //= self.spp
        counts = [space] * self.nstrips
        last = self.offsets[-1]
        if last + space > size:
            counts[-1] = max(size - last, 0)
        return counts


def _jpeg_frame_sampling(data: bytes, offset: int, count: int, spp: int):
    """libtiff's JPEGFixupTagsSubsampling: component 0's sampling
    factors from the frame header of the stream at ``offset`` (its
    ``count`` bytes, read from the file in chunks of up to 2048), where
    the other components' are 1 x 1 and both factors are 1, 2 or 4; None
    where it finds none (a marker it does not pass over, or the end of
    the stream or of a chunk the file cannot fill)."""
    at, left, buf, i = offset, count, b"", 0

    def byte():
        nonlocal at, left, buf, i
        if i == len(buf):
            take = min(2048, left)
            if not take or at + take > len(data):
                raise EOFError
            buf, i, at, left = data[at:at + take], 0, at + take, left - take
        i += 1
        return buf[i - 1]

    def skip(k):
        nonlocal at, left, buf, i
        if k <= len(buf) - i:
            i += k
            return
        k -= len(buf) - i
        buf, i = b"", 0
        at, left = (at + k, left - k) if k <= left else (at, 0)
    try:
        while True:
            m = byte()
            while m != 0xFF:
                m = byte()
            while m == 0xFF:
                m = byte()
            if m == 0xD8:
                continue
            length = byte() << 8 | byte() if m != 0 else 0
            if m in (0xC0, 0xC1, 0xC2, 0xC9, 0xCA):
                if length != 8 + 3 * spp:
                    return None
                skip(7)
                hv = byte()
                skip(1)
                for _ in range(spp - 1):
                    skip(1)
                    if byte() != 0x11:
                        return None
                    skip(1)
                h, v = hv >> 4, hv & 15
                return (h, v) if {h, v} <= set(_YCBCR_FACTORS) else None
            if not (m in (0xFE, 0xDB, 0xDA, 0xC4, 0xDD) or 0xE0 <= m <= 0xEF
                    ) or length < 2:
                return None
            skip(length - 2)
    except EOFError:
        return None


def _tiff_band(mode: str, raw: str):
    """The band of ``mode`` that a planar layer's raw mode fills, or None
    for the whole pixel (a one-band mode, or interleaved samples)."""
    bands = _TIFF_BANDS.get(mode, "")
    return bands.index(raw) if len(raw) == 1 and raw in bands else None


def _tiff_canvas(t: _Tiff) -> np.ndarray:
    """The page's array, zeros: [h, w] or [h, w, bands] of its mode."""
    shape = (t.h, t.w) + ((_TIFF_NBANDS[t.mode],)
                          if t.mode in _TIFF_NBANDS else ())
    return np.zeros(shape, {"I;16": np.uint16, "I;16B": np.uint16,
                            "I": np.int32, "F": np.float32}.get(t.mode,
                                                                np.uint8))


def _tiff_raw_route(t: _Tiff) -> np.ndarray:
    """Compression 1, as Pillow's ImageFile.load decodes the tiles: in the
    order of their offsets, each run of tiles that differ in nothing but
    their offset decoded once (its last), each by the raw decoder: rows of
    (width x bits + 7) / 8 bytes, the stride's padding skipped between
    them; a tile that ends past the end of the file is refused ("image
    file is truncated")."""
    tiles = t.raw_tiles()
    if not tiles:
        raise ValueError("TIFF: no strips or tiles")
    tiles.sort(key=lambda tile: tile[0])
    tiles = [tile for i, tile in enumerate(tiles) if i + 1 == len(tiles)
             or tiles[i + 1][1:] != tile[1:]]
    data, img = t.data, _tiff_canvas(t)
    for offset, (x0, y0, x1, y1), raw, stride in tiles:
        xs, ys = x1 - x0, y1 - y0
        if xs <= 0 or ys <= 0:
            raise ValueError("TIFF: a tile outside the image")
        bits = _tiff_raw_bits(raw)
        band = _tiff_band(t.mode, raw)
        if bits is None or (len(raw) == 1 and raw != t.mode
                            and band is None):
            raise ValueError(f"TIFF: no unpacker {raw} for mode {t.mode}")
        nb = (xs * bits + 7) // 8
        skip = stride - nb if stride else 0
        if skip < 0:
            raise ValueError("TIFF: a tile's stride shorter than its rows")
        if offset < 0 or offset + ys * nb + (ys - 1) * skip > len(data):
            raise ValueError("TIFF: image file is truncated")
        rows = np.lib.stride_tricks.as_strided(
            np.frombuffer(data, np.uint8, len(data) - offset, offset),
            (ys, nb), (nb + skip, 1))
        v = _tiff_unpack(raw, t.mode, rows, xs)
        if band is None:
            img[y0:y1, x0:x1] = v
        else:
            img[y0:y1, x0:x1, band] = v
    return img


def _tiff_codec(t: _Tiff, chunk: bytes, size: int, old_lzw: bool) -> bytes:
    """A strip or tile's ``size`` bytes as libtiff decodes them from its
    stored bytes (their bits already reversed under fill order 2):
    PackBits (``isc_tiff_packbits``), LZW (``isc_tiff_lzw``, old-style
    codes where ``old_lzw``) or zlib, no more than ``size`` bytes taken
    from the stream (ZIPDecode stops there); too few is refused."""
    name = _TIFF_CODECS[t.compression]
    if name in ("PackBits", "LZW"):
        out = np.empty(size, np.uint8)
        if name == "LZW":
            _call(_lib().isc_tiff_lzw, chunk, len(chunk), out.ctypes.data,
                  size, int(old_lzw))
        else:
            _call(_lib().isc_tiff_packbits, chunk, len(chunk),
                  out.ctypes.data, size)
        return out.tobytes()
    try:
        out = zlib.decompressobj().decompress(chunk, size)
    except zlib.error as e:
        raise ValueError(f"TIFF: corrupt Deflate data ({e})") from None
    if len(out) < size:
        raise ValueError("TIFF: not enough Deflate data for the strip")
    return out


def _tiff_rows(t: _Tiff, chunk: bytes, n: int, rowbytes: int,
               predictor: int, separate: bool) -> np.ndarray:
    """A decoded strip or tile -> [n, rowbytes] rows as libtiff hands them
    over: horizontal differencing undone (predictor 2, each sample from
    the one a pixel, or under planar 2 a sample, before it, modulo its
    width), samples of 16, 32 and 64 bits in the host's byte order. The
    floating-point predictor (3, fpAcc) instead adds up each row's bytes
    modulo 256 from the one a pixel (or a sample) before, then gathers
    each sample's bytes from the row's byte planes, the most significant
    first, into the host's order whatever the file's."""
    rows = np.frombuffer(chunk, np.uint8).reshape(n, rowbytes)
    bits = t.bps[0]
    if predictor == 3:
        stride = 1 if separate else t.spp
        acc = rows.reshape(n, -1, stride).cumsum(1, dtype=np.uint8)
        planes = acc.reshape(n, bits // 8, -1).transpose(0, 2, 1)
        if sys.byteorder == "little":
            planes = planes[:, :, ::-1]
        return np.ascontiguousarray(planes).reshape(n, rowbytes)
    if bits not in (16, 32, 64) and predictor == 1:
        return rows
    dt = np.dtype(t.e + "u" + str(bits // 8)) if bits >= 8 else np.uint8
    usable = rowbytes // dt.itemsize * dt.itemsize
    v = rows[:, :usable].view(dt)
    if predictor == 2:
        stride = 1 if separate else t.spp
        v = v.reshape(n, -1, stride).cumsum(1, dtype=dt).reshape(n, -1)
    out = rows.copy()
    out[:, :usable] = v.astype(dt.newbyteorder("=")).view(np.uint8)
    return out


def _tiff_libtiff_route(t: _Tiff) -> np.ndarray:
    """PackBits (32773), LZW (5), Deflate (8, 32946), JPEG (7) and CCITT
    (2, 3, 4, 32771) as Pillow's libtiff decoder (TiffDecode.c) reads
    them: libtiff's checks of the header, its reading of the IFD
    (``_LibTiff``: a size other than Pillow's refused, as PIL refuses it;
    a photometric that Pillow and libtiff read otherwise by name). A YCbCr
    page but JPEG in one plane goes through libtiff's RGBA interface
    (``_tiff_rgba``); for the rest, other samples, bits or compression
    refused by name, libtiff's planar configuration, strips or tiles and
    fill order taken, its check of the predictor (LZW's and Deflate's:
    PackBits, JPEG and CCITT have none); each
    strip (TIFFReadEncodedStrip) or tile (TIFFReadTile) decoded whole,
    LZW's old-style codes as LZWPreDecode finds them in the first (which
    fixes the style of the rest), a JPEG one by ``_TiffJpeg``, a CCITT one
    by ``_TiffFax`` (a page of rows it leaves unwritten refused by name);
    then unpacked a row at a time with the raw mode of fill order 1, 16-bit
    samples in native order; planar 2 a plane a band of the pixel (8
    bits, or the high byte of 16), RGBa's premultiplied colours undone
    after."""
    name = _TIFF_CODECS[t.compression]
    if name not in ("PackBits", "LZW", "Deflate", "JPEG", *_TIFF_FAX):
        raise ValueError(f"unsupported: TIFF {name} compression (the "
                         "decoders read uncompressed, PackBits, LZW, "
                         "Deflate, JPEG and CCITT TIFF)")
    data, e = t.data, t.e
    if not (data[:4] in (b"II*\0", b"MM\0*") or (
            data[:4] in (b"II+\0", b"MM\0+")
            and struct.unpack(e + "HH", data[4:8]) == (8, 0))):
        raise ValueError("TIFF: a header that libtiff refuses")
    lt = _LibTiff(t)
    jpeg = name == "JPEG"
    if (t.photo == 6) != (lt.photo == 6):
        raise ValueError("unsupported: TIFF tags that libtiff reads "
                         "otherwise than Pillow (photometric)")
    if (lt.w, lt.h) != (t.w, t.h):
        raise ValueError("TIFF: libtiff's size is not Pillow's")
    if lt.photo == 6 and not (jpeg and lt.planar == 1):
        return _tiff_rgba(t, lt, name)
    theirs = (lt.spp, lt.bps, lt.compression)
    if theirs != (t.spp, t.bps[0], t.compression):
        raise ValueError("unsupported: TIFF tags that libtiff reads "
                         "otherwise than Pillow (samples, bits, compression "
                         f"{theirs})")
    bits = t.bps[0]
    ycbcr = jpeg and lt.photo == 6
    if jpeg:
        _tiff_jpeg_checks(t, lt, ycbcr)
    predictor = lt.predictor if name in ("LZW", "Deflate") else 1
    if predictor == 3 and (lt.fmt != 3 or bits not in (16, 24, 32, 64)):
        raise ValueError(f"TIFF: floating-point predictor at {bits} bits "
                         f"of sample format {lt.fmt}")
    if predictor not in (1, 2, 3) or (predictor == 2
                                      and bits not in (8, 16, 32, 64)):
        raise ValueError(f"TIFF: predictor {predictor} at {bits} bits")
    # libtiff reverses the bits itself (but not JPEG's): fill order 1's
    # raw mode; a YCbCr page under JPEG comes as RGB (JPEGCOLORMODE_RGB)
    raw = "RGB" if ycbcr else _TIFF_OPEN[t.key[:3] + (1,) + t.key[4:]][1]
    if raw == "I;16":
        raw = "I;16N"
    elif raw.endswith((";16B", ";16L")):
        raw = raw[:-1] + "N"
    ubits = _tiff_raw_bits(raw)
    if ubits is None:
        raise ValueError(f"TIFF: no unpacker {raw} for mode {t.mode}")
    separate = lt.planar == 2
    planes = _TIFF_NBANDS.get(t.mode, 1) if separate else 1
    tiled = lt.tiled
    # planes of more samples than the mode's bands: PIL refuses them in
    # strips, reads the mode's in tiles (past its rows for one band)
    if separate and t.spp > 1 and (bits not in (8, 16) or (
            t.spp != planes and not (tiled and planes > 1))):
        raise ValueError(f"TIFF: planar {t.spp} samples of {bits} bits "
                         f"in mode {t.mode}")
    spp = 1 if separate else t.spp
    w, h = t.w, t.h
    if tiled:
        tw, tl = lt.tw, lt.tl
        rowbytes = (tw * bits * spp + 7) // 8
        across, down = -(-w // tw), -(-h // tl)
        blocks = ((p * across * down + (y // tl) * across + x // tw, x, y,
                   tl, p) for y in range(0, h, tl) for p in range(planes)
                  for x in range(0, w, tw))
        whole = rowbytes * tl
        if whole >= _INT_MAX:
            raise ValueError("TIFF: a tile of 2 GiB or more")
        if whole > (tl * ubits // planes + 7) // 8 * tw:
            raise ValueError("TIFF: tiles larger than the unpacker's")
    else:
        tw, rowbytes = w, (w * bits * spp + 7) // 8
        rps = h if lt.rps in (None, 0xFFFFFFFF) else lt.rps
        if rps > _INT_MAX:
            raise ValueError(f"TIFF: {rps} rows a strip")
        rps = min(rps, h)
        down = -(-h // rps)
        blocks = ((p * down + y // rps, 0, y, min(rps, h - y), p)
                  for y in range(0, h, rps) for p in range(planes))
        if rowbytes > (w * ubits // planes + 7) // 8:
            raise ValueError("TIFF: rows longer than the unpacker's")
        whole = rowbytes * rps
    if planes == 1 and (tw * ubits + 7) // 8 > rowbytes:
        raise ValueError(f"TIFF: {raw} rows longer than the planes' (PIL "
                         "reads past them)")
    img, old_lzw = _tiff_canvas(t), None
    codec = _TiffJpeg(lt, ycbcr, spp) if jpeg else None
    fax = _TiffFax(lt, name, tw, tl if tiled else rps,
                   rowbytes) if name in _TIFF_FAX else None
    for index, x, y, n, plane in blocks:
        chunk = _tiff_fill(lt, index, whole)
        if chunk is None:
            raise ValueError(f"TIFF: strip or tile {index} past the end "
                             "of the file")
        rows = tl if tiled else n
        xs, ys = min(tw, w - x), min(n, h - y)
        if codec:
            rows = codec.decode(chunk, (tw, tl) if tiled else (w, n), rows,
                                not tiled and y + n == h, (xs, ys),
                                rowbytes)
        elif fax:
            rows = fax.decode(chunk, lt.offsets[index] & 1, rows,
                              (xs, ys))
        else:
            if old_lzw is None and name == "LZW":
                old_lzw = chunk[:1] == b"\0" and len(chunk) > 1 and (
                    chunk[1] & 1)
            chunk = _tiff_codec(t, chunk, rows * rowbytes, bool(old_lzw))
            rows = _tiff_rows(t, chunk, rows, rowbytes, predictor,
                              separate)
        if separate and planes > 1:
            v = rows[:ys, 1::2] if bits == 16 else rows[:ys]
            img[y:y + ys, x:x + xs, plane] = v[:, :xs]
        else:
            img[y:y + ys, x:x + xs] = _tiff_unpack(raw, t.mode, rows[:ys],
                                                   xs)
    if separate and planes > 3 and t.mode == "RGBA" and t.get(
            338, (0,))[:1] in ((0,), (1,)):
        img[:] = _tiff_unpremultiply(img)
    if fax and fax.unwritten:
        raise ValueError(_TIFF_FAX_UNWRITTEN)
    return img


def _tiff_jpeg_checks(t: _Tiff, lt: _LibTiff, ycbcr: bool) -> None:
    """What PIL refuses, or the port leaves to later work, of a JPEG page
    before its strips are read: samples of other than 8 bits (named; a
    stream's precision must equal them), a YCbCr page in one plane that
    Pillow and libtiff lay out otherwise, or whose libtiff sizes refuse
    its subsampling, or of other than three samples (Pillow has no raw
    mode "RGB" for its mode). YCbCr in separate planes goes to
    ``_tiff_rgba``."""
    if t.bps[0] != 8:
        raise ValueError(f"unsupported: TIFF JPEG at {t.bps[0]} bits")
    if not ycbcr or lt.planar != 1:
        return
    if t.planar != lt.planar:
        raise ValueError("unsupported: TIFF tags that libtiff reads "
                         "otherwise than Pillow (planar configuration)")
    if t.mode != "RGB":
        raise ValueError(f"TIFF: YCbCr in mode {t.mode} (no raw mode RGB)")


class _TiffJpeg:
    """A page's JPEG strips or tiles as libtiff's JPEG codec decodes them
    for Pillow (``isc_tiff_jpeg``): JPEGTables read once, first
    (``isc_tiff_jpeg_tables``), the tables then carried from each stream
    to the next; YCbCr converted to RGB (under planar 1, the only YCbCr
    layout taken), every other page's components handed over as stored;
    the stored bytes never reversed (TIFF_NOBITREV, whatever the fill
    order)."""

    def __init__(self, lt: _LibTiff, ycbcr: bool, comps: int):
        self.state = np.zeros(_TIFF_JPEG_STATE, np.uint8)
        tables, self.sampling = lt.jpeg()
        if ycbcr and not set(self.sampling) <= set(_YCBCR_FACTORS):
            raise ValueError(f"TIFF: YCbCr subsampling {self.sampling}")
        if not ycbcr:
            self.sampling = (1, 1)
        if tables is not None:
            _call(_lib().isc_tiff_jpeg_tables, tables, len(tables),
                  self.state.ctypes.data)
        self.ycbcr, self.comps = ycbcr, comps

    def decode(self, chunk, segment, rows, last, need, stride):
        """[rows, stride] uint8: the stream ``chunk`` of a strip or tile
        whose segment is ``segment`` = (width, height) (``last``: the
        image's last strip, which a taller stream of its width may
        overrun), of which the page reads ``need`` = (columns, rows). A
        fault in its markers raises ``_JpegHeaderError``."""
        out = np.zeros((rows, stride), np.uint8)
        err = ctypes.create_string_buffer(256)
        rc = _lib().isc_tiff_jpeg(
            chunk, len(chunk), self.state.ctypes.data, segment[0],
            segment[1], rows, int(last), self.comps, *self.sampling,
            int(self.ycbcr), need[0], need[1], out.ctypes.data, stride, err,
            len(err))
        if rc:
            msg = err.value.decode(errors="replace")
            raise (_JpegHeaderError if rc == 3 else ValueError)(msg)
        return out


class _TiffFax:
    """A page's CCITT strips or tiles as libtiff's fax codec (tif_fax3.c)
    decodes them for PIL (``isc_tiff_fax``). Fax3SetupState first: 1 bit
    a sample and one sample a pixel in one plane (PIL refuses the rest),
    the run arrays' size (nruns: ``width`` + 1 rounded up to 32, twice
    that where rows are coded against the row before, Group 3 with
    T4Options bit 0, as libtiff's directory reader reads T4Options, and
    Group 4), an overflow refused. The arrays and FAXMODE_NOEOL (set where
    Group 3 data ends while the EOL search skips zeros) then pass from
    strip to strip, as libtiff keeps one codec state a page. A strip that
    the codec fails is refused, as PIL refuses it; a tile is not
    (TIFFReadEncodedTile takes the codec's -1 for success). The rest are
    read into a buffer of ``rows`` rows kept from strip to strip, as
    Pillow reuses its own, so that rows or bits libtiff leaves unwritten
    (a Group 4 strip that ends early, a tile the codec fails) keep the
    strip or tile before's; where they are bits that none has written,
    PIL shows what its buffer held, and the page is marked
    ``unwritten``."""

    def __init__(self, lt: _LibTiff, name: str, width: int, rows: int,
                 rowbytes: int):
        self.tiled = lt.tiled
        if lt.bps != 1:
            raise ValueError(f"TIFF: {name} at {lt.bps} bits (libtiff's "
                             "fax codec takes 1)")
        if lt.spp != 1 and lt.planar == 1:
            raise ValueError(f"TIFF: {name} of {lt.spp} samples in one "
                             "plane")
        kind = _TIFF_FAX[name]
        if kind == 2 and lt.lenient(292, 0, 0xFFFFFFFF) & 1:
            kind = 3                    # Group 3 2D: rows against the last
        top = 0xFFFFFFFF
        nruns = -(-(width + 1) // 32) * 32 if width + 1 < top - 30 else 0
        if kind >= 3:
            nruns = nruns * 2 if nruns * 2 <= top else 0
        if not nruns or nruns * 2 > top:
            raise ValueError(f"TIFF: {name} rows of {width} pixels, too "
                             "wide for libtiff's run arrays")
        # an array's entries past 8 a byte of the file are never written
        cap = min(nruns, 8 * len(lt.t.data) + 256)
        self.runs = np.zeros(2 * cap, np.uint32)
        self.mode = np.zeros(1, np.int32)
        self.buf = np.zeros((rows, rowbytes), np.uint8)
        self.reach = np.zeros(rows, np.int64)
        self.kind, self.width, self.cap, self.nruns = kind, width, cap, nruns
        self.unwritten = False

    def decode(self, chunk, odd, rows, need):
        """[rows, rowbytes] uint8: the stored bytes ``chunk`` of a strip or
        tile (``odd``: at an odd offset in the file, which RLEW's word
        alignment reads), of which the page reads ``need`` = (columns,
        rows)."""
        err = ctypes.create_string_buffer(256)
        rc = _lib().isc_tiff_fax(
            chunk, len(chunk), self.buf.ctypes.data, rows,
            self.buf.shape[1], self.width, self.kind, odd,
            self.runs.ctypes.data, self.cap, self.nruns,
            self.mode.ctypes.data, self.reach.ctypes.data, err, len(err))
        if rc > 1 or (rc and not self.tiled):
            raise ValueError(err.value.decode(errors="replace"))
        if (self.reach[:need[1]] < need[0]).any():
            self.unwritten = True
        return self.buf[:rows]


class _JpegHeaderError(ValueError):
    """A JPEG strip or tile whose markers libtiff's JPEGPreDecode refuses,
    so that TIFFFillStrip fails before a row is decoded."""


@functools.lru_cache(maxsize=8)
def _ycbcr_tables(luma: tuple, refbw: tuple):
    """libtiff's TIFFYCbCrToRGBInit (tif_color.c) for YCbCrCoefficients
    ``luma`` and ReferenceBlackWhite ``refbw`` (float32 values), as the
    four tables of TIFFYCbCrtoRGB's sums: R[Y, Cr] and B[Y, Cb] (uint8),
    Y_tab[Y] and G[Cb, Cr] (int32, green's sum before Y_tab and the
    clamp). Float32 throughout: D1-D4 are FIX (x * 65536 + 0.5, cut to an
    integer) of each factor clamped to 0..2 (NaN to 0); Code2V is
    (c - int(RB)) * CR / (RW - RB), cut to an integer within +-4096."""
    f32 = np.float32
    lr, lg, lb = (f32(v) for v in luma)

    def fix(f):
        f = f32(0) if not f >= 0 else f32(2) if f > 2 else f
        return int(float(f * f32(65536)) + 0.5)
    with np.errstate(all="ignore"):
        f1, f3 = f32(2) - f32(2) * lr, f32(2) - f32(2) * lb
        d1, d2 = fix(f1), -fix(lr * f1 / lg)
        d3, d4 = fix(f3), -fix(lb * f3 / lg)

        def code2v(c, rb, rw, cr):
            den = rw - rb
            v = (c - np.int64(np.trunc(rb))).astype(f32) * f32(cr) / (
                den if den != 0 else f32(1))
            return np.clip(v, -4096, 4096).astype(np.int64)
        x = np.arange(-128, 128)
        rb = [f32(v) for v in refbw]
        cr = code2v(x, rb[4] - f32(128), rb[5] - f32(128), 127)
        cb = code2v(x, rb[2] - f32(128), rb[3] - f32(128), 127)
        ytab = code2v(x + 128, rb[0], rb[1], 255)
    half = 1 << 15
    red = np.clip(ytab[:, None] + ((d1 * cr + half) >> 16), 0, 255)
    blue = np.clip(ytab[:, None] + ((d3 * cb + half) >> 16), 0, 255)
    green = ((d4 * cb + half)[:, None] + (d2 * cr)[None, :]) >> 16
    return (red.astype(np.uint8), blue.astype(np.uint8),
            ytab.astype(np.int32), green.astype(np.int32))


def _ycbcr_to_rgb(y, cb, cr, tables, out) -> None:
    """TIFFYCbCrtoRGB of uint8 Y, Cb, Cr arrays into ``out`` [..., 3]
    uint8 RGB: a gather a channel from the tables over (Y, Cr), (Cb, Cr)
    and (Y, Cb) as 16-bit indices."""
    red, blue, ytab, green = tables
    y16, cr16 = y.astype(np.uint16) << 8, cr.astype(np.uint16)
    out[..., 0] = np.take(red.reshape(-1), y16 | cr16)
    g = np.take(green.reshape(-1), cb.astype(np.uint16) << 8 | cr16)
    g += np.take(ytab, y)
    out[..., 1] = np.clip(g, 0, 255, out=g)
    out[..., 2] = np.take(blue.reshape(-1), y16 | cb)


def _tiff_fill(lt: _LibTiff, index: int, whole: int):
    """TIFFFillStrip / TIFFFillTile of strip or tile ``index``: its stored
    bytes (their bits reversed under fill order 2, but not JPEG's), a byte
    count over 1 MiB cut to 10 x ``whole`` (the strip or tile size) +
    4096; None where libtiff fails it (no bytes, or past the end of the
    file)."""
    data = lt.t.data
    start, size = lt.offsets[index], lt.counts[index]
    if size > 1 << 20 and (size - 4096) // 10 > whole:
        size = whole * 10 + 4096
    if size <= 0 or start + size > len(data):
        return None
    chunk = data[start:start + size]
    if lt.fill == 2 and _TIFF_CODECS[lt.compression] != "JPEG":
        chunk = _BITREV[np.frombuffer(chunk, np.uint8)].tobytes()
    return chunk


def _tiff_decode_into(name: str, chunk: bytes, buf: np.ndarray, size: int,
                      old_lzw: bool) -> bool:
    """A strip or tile's codec (PackBits, LZW or Deflate) into buf[:size]
    as libtiff decodes it; whether it succeeded. A failure leaves buf as
    libtiff leaves its buffer: what was decoded, then zeros (PackBits,
    new-style LZW, Deflate) or the bytes buf held before (old-style LZW).
    Where Python's zlib finds a Deflate stream faulty (which may be just
    past a strip it filled: a bad checksum), ``isc_tiff_inflate`` writes
    what zlib's inflate wrote before the fault, which Python's zlib does
    not hand over."""
    if name in ("PackBits", "LZW"):
        out = buf[:size]
        fn = _lib().isc_tiff_lzw if name == "LZW" else _lib().isc_tiff_packbits
        err = ctypes.create_string_buffer(256)
        args = (int(old_lzw),) if name == "LZW" else ()
        return fn(chunk, len(chunk), out.ctypes.data, size, *args, err,
                  len(err)) == 0
    try:
        out = zlib.decompressobj().decompress(chunk, size)
    except zlib.error:
        wrote = ctypes.c_longlong()
        err = ctypes.create_string_buffer(256)
        if _lib().isc_tiff_inflate(chunk, len(chunk), buf.ctypes.data, size,
                                   ctypes.byref(wrote), err, len(err)) != 1:
            raise ValueError("unsupported: TIFF YCbCr under Deflate, a "
                             "stream zlib and isc_tiff_inflate judge "
                             "otherwise") from None
        buf[wrote.value:size] = 0
        return False
    buf[:len(out)] = np.frombuffer(out, np.uint8)
    buf[len(out):size] = 0
    return len(out) == size


def _hor_acc8(buf: np.ndarray, size: int, rowsize: int, stride: int):
    """libtiff's PredictorDecodeTile with horAcc8 over buf[:size]: rows of
    ``rowsize`` bytes, each byte plus the one ``stride`` before it; nothing
    where size is not a whole number of rows or a row not of whole
    strides (libtiff fails the strip there, its bytes as decoded)."""
    if size % rowsize or rowsize % stride or rowsize <= stride:
        return
    rows = buf[:size].reshape(-1, rowsize // stride, stride)
    rows[:] = rows.cumsum(1, dtype=np.uint8)


def _ycbcr_put(buf: np.ndarray, rows: int, width: int, skew: int, hs: int,
               vs: int):
    """What putcontig8bitYCbCr<hs><vs>tile reads of a strip or tile's
    buffer for ``rows`` x ``width`` pixels, ``skew`` pixels of each row of
    data units passed over after them: (Y, Cb, Cr), each [rows, width]
    uint8, a data unit's Y samples row by row, then its Cb and Cr, each
    pixel the Y of its place in its unit and the unit's Cb and Cr. A row
    of units is ceil(width / hs) units, then skew / hs units more (4 x 4
    counts those as units of 10 bytes, 4 x 2's, as libtiff does)."""
    unit = hs * vs + 2
    across, down = -(-width // hs), -(-rows // vs)
    step = across * unit + skew // hs * (10 if (hs, vs) == (4, 4) else unit)
    u = np.lib.stride_tricks.as_strided(buf, (down, across, unit),
                                        (step, unit, 1))
    y = u[:, :, :hs * vs].reshape(down, across, vs, hs).transpose(
        0, 2, 1, 3).reshape(down * vs, across * hs)[:rows, :width]
    chroma = [u[:, :, k] if hs == vs == 1 else np.repeat(np.repeat(
        u[:, :, k], vs, 0), hs, 1)[:rows, :width]
        for k in (hs * vs, hs * vs + 1)]
    return y, chroma[0], chroma[1]


def _tiff_rgba(t: _Tiff, lt: _LibTiff, name: str) -> np.ndarray:
    """A YCbCr page that Pillow reads through libtiff's RGBA interface
    (TiffDecode.c's _decodeAsRGBA: every YCbCr page but JPEG in one
    plane), as TIFFRGBAImageBegin and its get and put routines read it:
    8 bits, 3 samples, in one plane at a subsampling of
    ``_YCBCR_CONTIG`` or in separate planes at 1 x 1 (anything else PIL
    refuses); YCbCrCoefficients and ReferenceBlackWhite as
    initYCbCrConversion checks them (NaN coefficients, a green one of 0,
    or a reference out of range refused), into ``_ycbcr_tables``.

    Pillow reads a block of RowsPerStrip or TileLength rows at a time,
    each in a buffer of its own, zeroed, of TIFFStripSize (a subsampled
    strip: ceil(rows / vs) rows of ceil(width / hs) data units) or
    TIFFTileSize, three of them in separate planes; a strip is decoded
    to the bytes of ceil(rows / vs) x vs scanlines (a row of units over
    vs, rounded down), a tile whole, horizontal differencing (horAcc8,
    stride 3 in one plane) over those scanlines, or a tile's rows of
    width x 3 bytes. A strip or tile that fails is no error to PIL
    (``stoponerr`` is 0): the first of a block that libtiff cannot read
    at all is refused, as PIL refuses it; the rest of a block's that
    fail are read as libtiff leaves its buffer (``_tiff_decode_into``;
    zeros where it reads no bytes; no differencing undone after a codec
    fails). The put routines (``_ycbcr_put``) then convert each pixel
    (``_ycbcr_to_rgb``) to R, G, B and an alpha of 255, whose bytes
    Pillow unpacks with the raw mode of the layout it reads itself
    (OPEN_INFO's "RGBX" into "RGB"; "L", the first bytes of a row, where
    Pillow finds one sample and libtiff three)."""
    bits, spp = lt.bps, lt.spp
    if bits != 8 or spp != 3 or lt.fmt == 3:
        raise ValueError(f"TIFF: YCbCr of {spp} samples of {bits} bits "
                         f"(format {lt.fmt}) that libtiff's RGBA interface "
                         "refuses")
    predictor = lt.predictor if name in ("LZW", "Deflate") else 1
    if predictor not in (1, 2):
        raise ValueError(f"TIFF: predictor {predictor} at {bits} bits")
    hs, vs = lt.pair(530) or (2, 2)
    separate = lt.planar == 2
    if (hs, vs) not in (((1, 1),) if separate else _YCBCR_CONTIG):
        raise ValueError(f"TIFF: YCbCr subsampling {hs}x{vs} "
                         f"{'in separate planes ' if separate else ''}"
                         "(libtiff's RGBA interface refuses it)")
    luma = lt.floats(529, 3)
    refbw = lt.floats(532, 6)
    luma = tuple(np.float32(_YCBCR_LUMA) if luma is None else luma)
    refbw = tuple(np.float32(_YCBCR_REFBW) if refbw is None else refbw)
    if np.isnan(luma).any() or luma[1] == 0:
        raise ValueError(f"TIFF: YCbCrCoefficients {luma} that libtiff "
                         "refuses")
    lo, hi = np.float32(-0x7FFFFFFF + 128), np.float32(0x7FFFFFFF)
    if not all(lo < v < hi for v in refbw):
        raise ValueError(f"TIFF: ReferenceBlackWhite {refbw} that libtiff "
                         "refuses")
    tables = _ycbcr_tables(tuple(map(float, luma)), tuple(map(float, refbw)))
    w, h = t.w, t.h
    block = lt.tl if lt.tiled else lt.rps
    if block in (None, 0xFFFFFFFF):
        block = h
    if w > _INT_MAX // 4 or block > _INT_MAX // (4 * w):
        raise ValueError("TIFF: a block of rows larger than Pillow's "
                         "buffer")
    unit = hs * vs + 2
    if lt.tiled:
        tw, tl = lt.tw, lt.tl
        size = -(-tl // vs) * -(-tw // hs) * unit if not separate else (
            tw * tl)
        rowsize = tw * (1 if separate else 3)
        across, down = -(-w // tw), -(-h // tl)
    else:
        tw = w
        tl = min(h if lt.rps in (None, 0xFFFFFFFF) else lt.rps, h)
        line = w if separate else -(-w // hs) * unit // vs
        size = tl * w if separate else -(-tl // vs) * (-(-w // hs) * unit)
        across, down = 1, -(-h // tl)
    planes = 3 if separate else 1
    read = size
    codec = _TiffJpeg(lt, False, 1) if name == "JPEG" else None
    img = np.zeros((h, w, 3), np.uint8)
    old_lzw, raw = None, 0
    for by in range(down):
        y0 = by * tl
        nrow = min(tl, h - y0)
        if not lt.tiled:                # a scanline a row (of vs rows)
            read = -(-nrow // vs) * vs * line
        buf = None
        for bx in range(across):
            x0 = bx * tw
            for p in range(planes):
                index = p * across * down + by * across + bx
                chunk = _tiff_fill(lt, index, size)
                if codec and chunk is not None:
                    try:
                        out = codec.decode(
                            chunk, (tw, tl) if lt.tiled else (w, nrow),
                            tl if lt.tiled else nrow,
                            not lt.tiled and y0 + nrow == h,
                            (min(tw, w - x0), nrow), line if not lt.tiled
                            else rowsize)
                    except _JpegHeaderError as err:
                        if "unsupported" in str(err):
                            raise
                        chunk = None            # JPEGPreDecode failed
                    except ValueError as err:
                        raise ValueError(
                            "unsupported: TIFF YCbCr under JPEG in "
                            f"separate planes, a plane libjpeg stops in "
                            f"({err}; PIL keeps its buffer's bytes)"
                        ) from None
                if chunk is not None:   # libtiff's raw buffer's size
                    raw = len(chunk) if lt.fill == 1 or codec else max(
                        raw, -(-len(chunk) // 1024) * 1024)
                if buf is None:         # the block's first: a new buffer
                    if chunk is None:
                        raise ValueError(f"TIFF: strip or tile {index} "
                                         "past the end of the file")
                    if lt.tiled and planes * size > 100_000_000 and (
                            raw < size // 1000):
                        raise ValueError(f"TIFF: tile {index}'s byte count "
                                         "is too small for its size")
                    buf = np.zeros(planes * size, np.uint8)
                part = buf[p * size:(p + 1) * size]
                if chunk is None:
                    part[:read] = 0
                    continue
                if codec:
                    part[:read] = out.reshape(-1)[:read]
                    continue
                if old_lzw is None and name == "LZW":
                    old_lzw = bool(chunk[:1] == b"\0" and len(chunk) > 1
                                   and chunk[1] & 1)
                if _tiff_decode_into(name, chunk, part, read,
                                     bool(old_lzw)) and predictor == 2:
                    _hor_acc8(part, read, rowsize if lt.tiled else line,
                              1 if separate else 3)
            xs = min(tw, w - x0)
            if separate:
                y, cb, cr = (buf[p * size:(p + 1) * size].reshape(-1, tw)[
                    :nrow, :xs] for p in range(3))
            else:
                y, cb, cr = _ycbcr_put(buf, nrow, xs, tw - xs, hs, vs)
            _ycbcr_to_rgb(y, cb, cr, tables, img[y0:y0 + nrow, x0:x0 + xs])
    if (t.mode, t.raw) == ("RGB", "RGBX"):
        return img
    rgba = np.concatenate([img, np.full((h, w, 1), 255, np.uint8)], 2)
    return _tiff_unpack(t.raw, t.mode, rgba.reshape(h, 4 * w), w)


def _mat3_inverse(a):
    """LittleCMS's _cmsMAT3inverse (cofactors over the determinant)."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return [[c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det,
             (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det],
            [c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det,
             (-a[0][0] * a[1][2] + a[0][2] * a[1][0]) / det],
            [c2 / det, (-a[0][0] * a[2][1] + a[0][1] * a[2][0]) / det,
             (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det]]


def _mat3_eval(a, v):
    return [a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2]
            for i in range(3)]


def _mat3_mul(a, b):
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j]
             for j in range(3)] for i in range(3)]


def _srgb_to_xyz():
    """The colorants of LittleCMS's built-in sRGB profile
    (cmsCreate_sRGBProfile): Rec. 709 primaries under D65
    (_cmsBuildRGB2XYZtransferMatrix), adapted to D50 by Bradford
    (_cmsAdaptMatrixToD50), in its order of operations."""
    xn, yn = 0.3127, 0.3290
    (xr, yr), (xg, yg), (xb, yb) = (0.64, 0.33), (0.30, 0.60), (0.15, 0.06)
    prim = [[xr, xg, xb], [yr, yg, yb],
            [1 - xr - yr, 1 - xg - yg, 1 - xb - yb]]
    k = _mat3_eval(_mat3_inverse(prim), [xn / yn, 1.0, (1.0 - xn - yn) / yn])
    m = [[k[0] * xr, k[1] * xg, k[2] * xb], [k[0] * yr, k[1] * yg, k[2] * yb],
         [k[0] * (1.0 - xr - yr), k[1] * (1.0 - xg - yg),
          k[2] * (1.0 - xb - yb)]]
    bradford = [[0.8951, 0.2664, -0.1614], [-0.7502, 1.7135, 0.0367],
                [0.0389, -0.0685, 1.0296]]
    src = _mat3_eval(bradford, [xn / yn, 1.0, (1 - xn - yn) / yn])
    dst = _mat3_eval(bradford, [0.9642, 1.0, 0.8249])
    cone = [[dst[0] / src[0], 0.0, 0.0], [0.0, dst[1] / src[1], 0.0],
            [0.0, 0.0, dst[2] / src[2]]]
    adapt = _mat3_mul(_mat3_inverse(bradford), _mat3_mul(cone, bradford))
    return _mat3_mul(adapt, m)


def _lcms_word(d: np.ndarray) -> np.ndarray:
    """_cmsQuickSaturateWord: d + 0.5 saturated to 0..65535, floored by
    the 16.16 magic-number trick (_cmsQuickFloor)."""
    d = d + 0.5
    t = (d - 32767.0) + 68719476736.0 * 1.5
    low = (t.view(np.int64) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    v = (low.astype(np.int64) >> 16) + 32767
    return np.where(d <= 0, 0, np.where(d >= 65535.0, 65535, v))


@functools.cache
def _lab_clut() -> np.ndarray:
    """The 33 x 33 x 33 x 3 uint16 table of PIL's LAB -> RGB transform as
    LittleCMS 2.17 builds it (OptimizeByResampling of the pipeline left
    once PreOptimize drops the Lab profile's identity): each node's
    16-bit Lab, as float32 over 65535, through Lab -> XYZ (EvaluateLab2XYZ:
    D50, over 1 + 32767/32768), the inverse of the sRGB colorants (times
    that), the inverted sRGB curve (parametric type -4), each stage's
    result float32, then _cmsQuickSaturateWord of it times 65535."""
    f32, top = np.float32, 1.0 + 32767.0 / 32768.0
    nodes = _lcms_word(np.arange(33) * 65535.0 / 32)
    grid = np.stack(np.meshgrid(nodes, nodes, nodes, indexing="ij"),
                    -1).reshape(-1, 3)
    v = (grid / 65535.0).astype(f32).astype(np.float64)
    y = (v[:, 0] * 100.0 + 16.0) / 116.0
    t = np.stack([y + 0.002 * (v[:, 1] * 255.0 - 128.0), y,
                  y - 0.005 * (v[:, 2] * 255.0 - 128.0)], 1)
    t = np.where(t <= 24.0 / 116.0, (108.0 / 841.0) * (t - 16.0 / 116.0),
                 t * t * t)
    xyz = (t * np.array([0.9642, 1.0, 0.8249]) / top).astype(f32).astype(
        np.float64)
    inv = _mat3_inverse(_srgb_to_xyz())
    rgb = np.stack([((0.0 + xyz[:, 0] * (row[0] * top)) + xyz[:, 1] * (
        row[1] * top)) + xyz[:, 2] * (row[2] * top) for row in inv],
        1).astype(f32).astype(np.float64)
    g, a, b, c, d = 2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045
    with np.errstate(invalid="ignore"):
        hi = (np.power(rgb, 1.0 / g) - b) / a
    rgb = np.where(rgb >= (a * d + b) ** g, hi, rgb / c).astype(f32)
    clut = _lcms_word(rgb.astype(np.float64) * 65535.0).astype(np.uint16)
    return np.ascontiguousarray(clut.reshape(33, 33, 33, 3))


def _tiff_lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """PIL's "LAB" -> RGB (``isc_tiff_lab`` over ``_lab_clut``)."""
    lab = np.ascontiguousarray(lab)
    out = np.empty(lab.shape[:2] + (3,), np.uint8)
    clut = _lab_clut()
    _call(_lib().isc_tiff_lab, lab.ctypes.data, lab.size // 3, 3,
          clut.ctypes.data, out.ctypes.data)
    return out


def _tiff_to_rgb(t: _Tiff, img: np.ndarray) -> np.ndarray:
    """``_pil_to_array`` of a decoded page: "L" 2-D, "RGB" as it is, the
    alpha of "RGBA" dropped, every other mode through PIL's conversion to
    RGB ("I;16" and "I" clipped to 0..255, "F" truncated and clipped, the
    palette of "P" and "PA", CMYK by libImaging's cmyk2rgb, "LA" its L)."""
    mode = t.mode
    if mode == "L":
        return img
    if mode in ("RGB", "RGBA"):
        return np.ascontiguousarray(img[:, :, :3])
    if mode in ("P", "PA"):
        return t.palette[img if mode == "P" else img[:, :, 0]]
    if mode == "CMYK":
        c = img.astype(np.int32)
        nk = 255 - c[:, :, 3:]
        v = c[:, :, :3] * nk + 128
        return np.clip(nk - (((v >> 8) + v) >> 8), 0, 255).astype(np.uint8)
    if mode == "LAB":
        return _tiff_lab_to_rgb(img)
    if mode == "LA":
        grey = img[:, :, 0]
    elif mode == "F":
        with np.errstate(invalid="ignore"):   # NaN and below 0 to 0
            grey = np.where(img >= 255, 255, np.where(img > 0, img, 0))
        grey = grey.astype(np.uint8)
    else:                               # "1" (0 / 255), "I;16", "I"
        grey = np.clip(img, 0, 255).astype(np.uint8)
    return np.repeat(grey[:, :, None], 3, 2)


_TIFF_TRANSPOSE = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
                   4: lambda a: a[::-1], 5: lambda a: a.swapaxes(0, 1),
                   6: lambda a: a.swapaxes(0, 1)[:, ::-1],
                   7: lambda a: a.swapaxes(0, 1)[::-1, ::-1],
                   8: lambda a: a.swapaxes(0, 1)[::-1]}


def _tiff_mapped(t: _Tiff):
    """A page read from a path the way Pillow's ImageFile maps it: one
    tile, its raw mode the mode itself (``_TIFF_MAP``), at a stride of
    the tile's or the mode's width of the page's size, which is swapped
    for orientations 5-8 (so such a page is read as the other shape, then
    turned); None where Pillow decodes instead."""
    tiles = t.raw_tiles() if _TIFF_CODECS[t.compression] == "raw" else []
    if len(tiles) != 1 or tiles[0][2] != t.mode or t.mode not in _TIFF_MAP:
        return None
    offset, _, raw, stride = tiles[0]
    if offset > len(t.data):
        return None
    w, h = (t.h, t.w) if t.orientation in (5, 6, 7, 8) else (t.w, t.h)
    stride = stride or w * _TIFF_MAP[t.mode]
    if offset < 0 or offset + h * stride > len(t.data):
        raise ValueError("TIFF: buffer is not large enough")
    rows = np.lib.stride_tricks.as_strided(
        np.frombuffer(t.data, np.uint8, len(t.data) - offset, offset),
        (h, stride), (stride, 1))
    return _tiff_unpack(raw, t.mode, rows, w)


def _decode_tiff(data: bytes, mapped: bool = False) -> np.ndarray:
    """The first page of a TIFF as PIL opens it: Pillow's TiffImagePlugin
    (the header, the first IFD, the layout's mode and raw mode of
    OPEN_INFO, the strips or tiles) and, for PackBits, LZW, Deflate, JPEG
    and CCITT, libtiff's decoding; the Orientation tag applied (ImageOps.
    exif_transpose, as ``load_end`` does for TIFF), then PIL's conversion
    to RGB. ``mapped``: read as from a path (``_tiff_mapped``)."""
    t = _Tiff(data)
    _check_pixels(t.h, t.w)
    if t.w <= 0 or t.h <= 0:
        raise ValueError(f"TIFF: empty image ({t.w}x{t.h})")
    try:
        img = _tiff_mapped(t) if mapped else None
        if img is None:
            img = (_tiff_raw_route if _TIFF_CODECS[t.compression] == "raw"
                   else _tiff_libtiff_route)(t)
    except (TypeError, IndexError, KeyError, OverflowError) as err:
        raise ValueError(f"TIFF: bad strips or tiles ({err!r})") from None
    if t.orientation in _TIFF_TRANSPOSE:
        img = _TIFF_TRANSPOSE[t.orientation](img)
    return np.ascontiguousarray(_tiff_to_rgb(t, img))


def load_image_bytes(data: bytes) -> np.ndarray:
    """Encoded image bytes -> HWC uint8 RGB, or HW uint8 for a greyscale
    image (8-bit grey PNG, one-component JPEG, a GIF or BMP of grey
    indices, a grey TIFF), as the JAX package's PIL path gives them: every
    PNG (any colour type and depth, Adam7 or not), every 8-bit Huffman
    JPEG of 1, 3 or 4 components (YCbCr, RGB, CMYK, YCCK), baseline or
    progressive, every GIF (its first frame), every BMP and every WebP,
    lossless (VP8L) or lossy (VP8, with ALPH or not), simple, extended or
    the first frame of an animation, and the first page of every TIFF,
    uncompressed, PackBits, LZW, Deflate, JPEG or CCITT (RLE, RLEW, Group
    3 one- or two-dimensional, Group 4, damaged data read as libtiff
    recovers from it; strips or tiles, planar or not, either byte order,
    BigTIFF, horizontal or floating-point prediction, YCbCr under JPEG in
    one plane, and YCbCr under PackBits, LZW or Deflate at any subsampling
    libtiff's RGBA interface takes and in separate planes under those and
    JPEG, as that interface reads it for PIL; its orientation applied),
    that PIL opens. What PIL refuses, and what the decoders do not take
    (lossless, hierarchical, arithmetic, 12-bit or 2-component JPEG;
    TIFF's other compressions, old-style JPEG among them, JPEG at other
    than 8 bits, a JPEG strip with a bad Huffman code or short of its
    segment, a JPEG plane that libjpeg stops in, CCITT rows libtiff
    leaves unwritten, where PIL shows its buffer; PPM and the other
    formats of ``_REFUSED``, by name), raises ValueError."""
    data = bytes(data)
    if data[:2] == b"\xff\xd8":
        return _decode_jpeg(data)
    if data[:8] == _PNG_SIG:
        return _decode_png(data)
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return _decode_gif(data)
    if data[:2] == b"BM":
        return _decode_bmp(data)
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return _decode_webp(data)
    if data[:4] in _TIFF_SIGS:
        return _decode_tiff(data)
    for name, at, prefixes in _REFUSED:
        if data[at:].startswith(prefixes):
            raise ValueError(f"unsupported: {name} (the decoders read "
                             "JPEG, PNG, GIF, BMP, WebP and TIFF)")
    raise ValueError("not an image the decoders read (JPEG, PNG, GIF, BMP, "
                     "WebP, TIFF)")


def load_image(path: str) -> np.ndarray:
    """``load_image_bytes`` of a file; a TIFF as PIL reads it from a path
    (``_tiff_mapped``)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] in _TIFF_SIGS:
        return _decode_tiff(data, mapped=True)
    return load_image_bytes(data)


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


def _dump(obj, *path_parts):
    path = os.path.join(*path_parts)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def _load(*path_parts):
    with open(os.path.join(*path_parts)) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# Feature extraction (reference preprocess.py:23-50)
# ---------------------------------------------------------------------------

def check_store_format(store_format: str) -> None:
    """Refuse "h5" by name: the port writes no HDF5 (the card's machine has
    no h5py, and the port's data path reads only the native record
    format, ``.isc``)."""
    if store_format == "h5":
        raise ValueError(
            "store_format 'h5': the port writes no HDF5 (its data path "
            "reads only the native record format, .isc); use 'native'")


def extract_imgs_feat(imgs_dir: str, feats_dir: str, encoder_params,
                      att_size: int = 14, store_format: str = "native",
                      dtype: str = "float32", batch_size: int = 8,
                      bucket_mode: str = "exact",
                      bucket_shapes=DEFAULT_BUCKET_SHAPES, *,
                      device="cuda", use_kernels: bool = True) -> list:
    """fc/att features of every image in ``imgs_dir`` (sorted by name)
    into ``feats_dir``/feats_fc.isc and feats_att.isc, keyed by file name
    (the reference's keying), through the ResNet-101 of ``encoder_params``
    (moved to ``device``) in the params' own dtype.

    The JAX package's two shape policies:

    * ``bucket_mode="exact"``: images keep their sizes (the reference
      never resizes, preprocess.py:23-50), normalised on the host and
      batched by exact (H, W) into ``encoder.forward_batch``;
    * ``bucket_mode="resize"``: each image goes to its nearest bucket of
      ``bucket_shapes`` by log aspect (``bucket_for_shape``), is resized
      there on the host (``resize_to_bucket``, PIL's bilinear) and batched
      as raw uint8 into ``encoder.forward_raw_batch`` (the normalisation
      folded into conv1). An image already at a bucket's shape is not
      resized.

    A batch is flushed when it holds ``batch_size`` images of one shape,
    and the partial ones at the end, padded by repeating their last image
    (so every forward has ``batch_size`` rows, as in the JAX package): on
    the card the stem's max-pool kernel launches once a flushed batch.
    ``use_kernels=False`` runs the pool's plain version on the card too
    (the smoke check's reference run). ``store_format`` "h5" is refused
    with ValueError (the port writes and reads the native format only).
    Returns the [(name, fc, att)] rows written, as numpy float32."""
    from .models import encoder as enc

    check_store_format(store_format)
    if bucket_mode not in ("exact", "resize"):
        raise ValueError(f"bucket_mode must be exact|resize: {bucket_mode}")
    dev = resolve_device(device)
    params = to_device(encoder_params, dev)
    imgs = sorted(os.listdir(imgs_dir))
    os.makedirs(feats_dir, exist_ok=True)

    @torch.no_grad()
    def fwd(x: np.ndarray):
        x = torch.from_numpy(x).to(dev)
        if bucket_mode == "resize":
            fc, att = enc.forward_raw_batch(params, x, att_size,
                                            use_kernels=use_kernels)
        else:
            fc, att = enc.forward_batch(params, x, att_size,
                                        use_kernels=use_kernels)
        return (fc.float().cpu().numpy(), att.float().cpu().numpy())

    def feats():
        buckets: Dict[tuple, list] = {}

        def flush(shape):
            names, arrs = zip(*buckets.pop(shape))
            n = len(arrs)
            if n < batch_size:  # padded to the batch size
                arrs = arrs + (arrs[-1],) * (batch_size - n)
            fc, att = fwd(np.stack(arrs))
            for i, nm in enumerate(names):
                yield nm, fc[i], att[i]

        for img_nm in imgs:
            img = load_image(os.path.join(imgs_dir, img_nm))
            if bucket_mode == "resize":
                img = to_rgb_uint8(img)
                x = resize_to_bucket(
                    img, bucket_for_shape(img.shape[0], img.shape[1],
                                          bucket_shapes))
            else:
                x = enc.preprocess(img)
            buckets.setdefault(tuple(x.shape), []).append((img_nm, x))
            if len(buckets[tuple(x.shape)]) >= batch_size:
                yield from flush(tuple(x.shape))
        for shape in list(buckets):
            yield from flush(shape)

    items = list(feats())
    write_native_store(os.path.join(feats_dir, "feats_fc.isc"),
                       ((nm, fc) for nm, fc, _ in items),
                       shape=items[0][1].shape, dtype=dtype)
    write_native_store(os.path.join(feats_dir, "feats_att.isc"),
                       ((nm, att) for nm, _, att in items),
                       shape=items[0][2].shape, dtype=dtype)
    return items


# ---------------------------------------------------------------------------
# Caption datasets (reference preprocess.py:53-90)
# ---------------------------------------------------------------------------

def process_caption_datasets(caption_datasets_dir: str, captions_dir: str,
                             dataset_names: List[str]) -> None:
    for dataset_nm in dataset_names:
        print(f"===> process {dataset_nm} dataset")
        images = _load(caption_datasets_dir,
                       f"dataset_{dataset_nm}.json")["images"]
        img_captions = {"train": {}, "val": {}, "test": {}}
        img_captions_pos = {"train": {}, "val": {}, "test": {}}
        img_concepts = {"train": {}, "val": {}, "test": {}}
        for image in images:
            fn = image["filename"]
            split = image["split"]
            if split == "restval":
                split = "train"
            img_captions[split][fn] = []
            img_captions_pos[split][fn] = []
            concepts = set()
            sents = [text.tokenize(s["raw"].lower())
                     for s in image["sentences"]]
            for tagged in text.pos_tag_sents(sents):
                words, poses = [], []
                for w, p in tagged:
                    if p == ".":  # remove punctuation
                        continue
                    words.append(w)
                    poses.append(p)
                    if p in CONCEPT_POS:
                        concepts.add(w)
                img_captions[split][fn].append(words)
                img_captions_pos[split][fn].append(poses)
            img_concepts[split][fn] = sorted(concepts)

        _dump(img_captions, captions_dir, dataset_nm, "img_captions.json")
        _dump(img_captions_pos, captions_dir, dataset_nm,
              "img_captions_pos.json")
        _dump(img_concepts, captions_dir, dataset_nm, "img_concepts.json")


# ---------------------------------------------------------------------------
# Sentiment corpus mining (reference preprocess.py:93-213)
# ---------------------------------------------------------------------------

def process_senti_corpus(corpus_dir: str,
                         corpus_type: str = "part") -> None:
    senti_corpus = _load(corpus_dir, corpus_type, "senti_corpus.json")

    # artifact names (tmp_senti_corpus*.json, sentiment_detector.json)
    # and the tf·ratio algorithm are the reference compatibility
    # contract; internals below are this module's own
    tokens_by_label = defaultdict(list)
    tags_by_label = defaultdict(list)
    adj_counts_all: Counter = Counter()
    adj_counts: Dict[str, Counter] = defaultdict(Counter)
    noun_to_adjs: Dict[str, Counter] = defaultdict(Counter)

    for senti_label, sents in senti_corpus.items():
        toks = [text.tokenize(s.strip().lower()) for s in sents]
        for tagged in text.pos_tag_sents(toks):
            kept = [(w, p) for w, p in tagged if p != "."]
            sent_adjs = [w for w, p in kept if p == "ADJ"]
            tokens_by_label[senti_label].append([w for w, _ in kept])
            tags_by_label[senti_label].append([p for _, p in kept])
            if sent_adjs:
                adj_counts_all.update(sent_adjs)
                adj_counts[senti_label].update(sent_adjs)
                for noun in (w for w, p in kept if p == "NOUN"):
                    noun_to_adjs[noun].update(sent_adjs)

    _dump(tokens_by_label, corpus_dir, corpus_type,
          "tmp_senti_corpus.json")
    _dump(tags_by_label, corpus_dir, corpus_type,
          "tmp_senti_corpus_pos.json")

    # tf·ratio scoring of adjectives (reference :135-158)
    frequent_adjs = {w: n for w, n in adj_counts_all.most_common()
                     if n >= 3}
    label_totals = {k: sum(v.values()) for k, v in adj_counts.items()}
    tf_ratio: Dict[str, Dict[str, float]] = defaultdict(dict)
    for k, cnt in adj_counts.items():
        for w, n in cnt.items():
            if w in frequent_adjs:
                tf = n / label_totals[k]
                tf_ratio[k][w] = tf * (n / frequent_adjs[w])

    sentiment_words = {
        k: [w for w, _ in sorted(v.items(), key=lambda p: p[1],
                                 reverse=True)]
        for k, v in tf_ratio.items()}

    # pos/neg disjointification (reference :166-184): a word ranked in
    # both polarity lists is dropped from both when the ranks are close
    # (< 5 apart), otherwise kept only where it ranks higher
    drop_both, drop_from_pos, drop_from_neg = [], [], []
    neg_ranked = sentiment_words.get("negative", [])
    for pos_rank, w in enumerate(sentiment_words.get("positive", [])):
        if w in neg_ranked:
            neg_rank = neg_ranked.index(w)
            if abs(pos_rank - neg_rank) < 5:
                drop_both.append(w)
            elif pos_rank > neg_rank:
                drop_from_pos.append(w)
            else:
                drop_from_neg.append(w)
    for w in drop_both:
        sentiment_words["positive"].remove(w)
        sentiment_words["negative"].remove(w)
    for w in drop_from_pos:
        sentiment_words["positive"].remove(w)
    for w in drop_from_neg:
        sentiment_words["negative"].remove(w)

    sentiment_words = {senti: {w: tf_ratio[senti][w] for w in ws}
                       for senti, ws in sentiment_words.items()}
    _dump(sentiment_words, corpus_dir, corpus_type, "sentiment_words.json")

    # noun -> weighted senti-word table (reference :196-213)
    flat_words: Dict[str, float] = {}
    flat_words.update(sentiment_words.get("positive", {}))
    flat_words.update(sentiment_words.get("negative", {}))
    table: Dict[str, List] = {}
    for noun, senti_cnt in noun_to_adjs.items():
        total = sum(senti_cnt.values())
        entries = [(w, n / total * flat_words[w])
                   for w, n in senti_cnt.most_common() if w in flat_words]
        if entries and len(entries) <= 50:
            table[noun] = entries
    _dump(table, corpus_dir, corpus_type, "sentiment_detector.json")


# ---------------------------------------------------------------------------
# Vocabularies (reference preprocess.py:216-225, 250-277)
# ---------------------------------------------------------------------------

def build_idx2concept(captions_dir: str, dataset_names: List[str],
                      top_k: int = 2000) -> None:
    for dataset_nm in dataset_names:
        img_concepts = _load(captions_dir, dataset_nm, "img_concepts.json")
        tc: Counter = Counter()
        for concepts in img_concepts.values():
            for cs in concepts.values():
                tc.update(cs)
        idx2concept = [w for w, _ in tc.most_common()[:top_k]]
        _dump(idx2concept, captions_dir, dataset_nm, "idx2concept.json")


def build_idx2word(captions_dir: str, corpus_dir: str,
                   dataset_names: List[str],
                   corpus_type: str = "part") -> None:
    senti_corpus = _load(corpus_dir, corpus_type, "tmp_senti_corpus.json")
    sentiment_words = _load(corpus_dir, corpus_type, "sentiment_words.json")
    idx2sentiment = [w for v in sentiment_words.values() for w in v]

    for dataset_nm in dataset_names:
        img_captions = _load(captions_dir, dataset_nm, "img_captions.json")
        idx2concept = _load(captions_dir, dataset_nm, "idx2concept.json")

        tc: Counter = Counter()
        for captions in img_captions.values():
            for caps in captions.values():
                for cap in caps:
                    tc.update(cap)
        for captions in senti_corpus.values():
            for cap in captions:
                tc.update(cap)
        idx2word = [w for w, n in tc.most_common() if n > 5]
        idx2word.extend(idx2sentiment)
        idx2word.extend(idx2concept)
        # sorted() where the reference uses raw set order (hash-dependent)
        idx2word = sorted(set(idx2word))
        idx2word = ["<PAD>", "<SOS>", "<EOS>", "<UNK>"] + idx2word
        _dump(idx2word, captions_dir, dataset_nm, corpus_type,
              "idx2word.json")


# ---------------------------------------------------------------------------
# Sentiment-image labels (reference preprocess.py:228-247)
# ---------------------------------------------------------------------------

def get_img_senti_labels(senti_imgs_dir: str, out_file: str,
                         seed: Optional[int] = 0) -> None:
    """Split sentiment-labeled images (label = filename prefix before '_')
    into val(100/100/50)/test(100/100/50)/train(rest). Seeded for
    determinism (the reference uses the global random state)."""
    rng = random.Random(seed)
    senti_imgs = defaultdict(list)
    for fn in sorted(os.listdir(senti_imgs_dir)):
        senti = fn.split("_")[0]
        senti_imgs[senti].append((fn, senti))
    for senti in ("positive", "negative", "neutral"):
        rng.shuffle(senti_imgs[senti])
    out = {"train": [], "val": [], "test": []}
    out["val"] += senti_imgs["positive"][:100]
    out["val"] += senti_imgs["negative"][:100]
    out["val"] += senti_imgs["neutral"][:50]
    out["test"] += senti_imgs["positive"][100:200]
    out["test"] += senti_imgs["negative"][100:200]
    out["test"] += senti_imgs["neutral"][50:100]
    out["train"] += senti_imgs["positive"][200:]
    out["train"] += senti_imgs["negative"][200:]
    out["train"] += senti_imgs["neutral"][100:]
    _dump({k: [list(p) for p in v] for k, v in out.items()}, out_file)


# ---------------------------------------------------------------------------
# Detected sentiment words per image (reference preprocess.py:280-302)
# ---------------------------------------------------------------------------

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


def get_img_det_sentiments(captions_dir: str, corpus_dir: str,
                           dataset_names: List[str],
                           corpus_type: str = "part") -> None:
    detector = _load(corpus_dir, corpus_type, "sentiment_detector.json")
    for dataset_nm in dataset_names:
        det_concepts = _load(captions_dir, dataset_nm,
                             "img_det_concepts.json")
        det_sentiments = {fn: _rank_sentis(cpts, detector)[:20]
                          for fn, cpts in det_concepts.items()}
        _dump(det_sentiments, captions_dir, dataset_nm, corpus_type,
              "img_det_sentiments.json")


# ---------------------------------------------------------------------------
# senti_captions (reference preprocess.py:305-390)
# ---------------------------------------------------------------------------

def get_senti_captions(captions_dir: str, corpus_dir: str,
                       dataset_names: List[str],
                       corpus_type: str = "part") -> None:
    detector = _load(corpus_dir, corpus_type, "sentiment_detector.json")
    senti_corpus = _load(corpus_dir, corpus_type, "tmp_senti_corpus.json")
    senti_corpus_pos = _load(corpus_dir, corpus_type,
                             "tmp_senti_corpus_pos.json")
    sentiment_words = _load(corpus_dir, corpus_type, "sentiment_words.json")
    idx2sentiment = {w for v in sentiment_words.values() for w in v}

    senti_captions = defaultdict(list)
    for senti in senti_corpus:
        for cap, pos in zip(senti_corpus[senti], senti_corpus_pos[senti]):
            cpts = sorted({cap[j] for j, p in enumerate(pos)
                           if p in CONCEPT_POS})
            sentis = _rank_sentis(cpts, detector)
            if sentis:
                senti_captions[senti].append([cap, cpts[:20], sentis[:20]])

    for dataset_nm in dataset_names:
        img_captions = _load(captions_dir, dataset_nm,
                             "img_captions.json")["train"]
        img_captions_pos = _load(captions_dir, dataset_nm,
                                 "img_captions_pos.json")["train"]
        fact_caps = []
        for fn, caps in img_captions.items():
            for cap, pos in zip(caps, img_captions_pos[fn]):
                if any(w in idx2sentiment for w in cap):
                    continue  # factual captions only (reference :356-361)
                cpts = sorted({cap[j] for j, p in enumerate(pos)
                               if p in CONCEPT_POS})
                sentis = _rank_sentis(cpts, detector)
                if sentis:
                    fact_caps.append([cap, cpts[:20], sentis[:20]])
        out = deepcopy(dict(senti_captions))
        out["neutral"] = fact_caps
        _dump(out, captions_dir, dataset_nm, corpus_type,
              "senti_captions.json")


def get_anno_captions(caption_datasets_dir: str, captions_dir: str,
                      dataset_names: List[str]) -> None:
    for dataset_nm in dataset_names:
        images = _load(caption_datasets_dir,
                       f"dataset_{dataset_nm}.json")["images"]
        anno = {img["filename"]: [s["raw"].strip().lower()
                                  for s in img["sentences"]]
                for img in images if img["split"] == "test"}
        _dump(anno, captions_dir, dataset_nm, "anno_captions.json")


# ---------------------------------------------------------------------------
# Per-sentiment LMs (reference preprocess.py:408-466)
# ---------------------------------------------------------------------------

def _isclm_binary() -> Optional[str]:
    here = os.path.dirname(os.path.abspath(__file__))
    for cand in (os.path.join(here, "..", "native", "build", "isclm"),
                 shutil.which("isclm")):
        if cand and os.path.exists(cand):
            return cand
    return None


def get_lm_sents(captions_dir: str, dataset_names: List[str],
                 corpus_type: str = "part") -> None:
    """Write per-sentiment sentence files and train trigram LMs (.sri,
    ARPA format). Backend: SRILM ngram-count when present, else the
    in-tree C++ isclm trainer (same interpolated modified-KN estimator
    family, same ARPA output). KenLM arpa files additionally when lmplz
    exists."""
    for dataset_nm in dataset_names:
        senti_captions = _load(captions_dir, dataset_nm, corpus_type,
                               "senti_captions.json")
        lm_dir = os.path.join(captions_dir, dataset_nm, corpus_type, "lm")
        os.makedirs(lm_dir, exist_ok=True)
        for senti, caps in senti_captions.items():
            with open(os.path.join(lm_dir, f"{senti}_w.txt"), "w") as f:
                f.write("".join(" ".join(c[0]) + "\n" for c in caps))

        use_srilm = shutil.which("ngram-count") is not None
        isclm = None if use_srilm else _isclm_binary()
        for fn in sorted(os.listdir(lm_dir)):
            if not fn.endswith("_w.txt"):
                continue
            stem = fn.split(".")[0]
            txt = os.path.join(lm_dir, fn)
            sri = os.path.join(lm_dir, f"{stem}.sri")
            if use_srilm:
                cnt = os.path.join(lm_dir, f"{stem}.count")
                subprocess.run(["ngram-count", "-text", txt, "-order", "3",
                                "-write", cnt], check=True)
                subprocess.run(["ngram-count", "-read", cnt, "-order", "3",
                                "-lm", sri, "-interpolate", "-kndiscount"],
                               check=True)
            elif isclm:
                subprocess.run([isclm, "train", txt, sri], check=True)
            else:
                raise RuntimeError(
                    "no LM trainer: install SRILM or build the in-tree "
                    "isclm (`make -C native`)")

        # id-form sentences + KenLM arpa (reference :441-466; optional)
        idx2word = _load(captions_dir, dataset_nm, corpus_type,
                         "idx2word.json")
        word2idx = {w: i for i, w in enumerate(idx2word)}
        unk, eos = word2idx["<UNK>"], word2idx["<EOS>"]
        have_kenlm = shutil.which("lmplz") is not None
        for senti, caps in senti_captions.items():
            lines = []
            for c in caps:
                ids = [word2idx.get(w, None) or unk for w in c[0]] + [eos]
                lines.append(" ".join(map(str, ids)))
            id_txt = os.path.join(lm_dir, f"{senti}_id.txt")
            with open(id_txt, "w") as f:
                f.write("\n".join(lines))
            if have_kenlm:
                arpa = os.path.join(lm_dir, f"{senti}_id.kenlm.arpa")
                with open(id_txt) as fin, open(arpa, "w") as fout:
                    subprocess.run(["lmplz", "-o", "3"], stdin=fin,
                                   stdout=fout, check=True)
            # id-form ARPA (.sri) — input of the RL LM reward
            # (--rl_lm_flag; reference wires kenlm arpa here,
            # train_rl.py:212-216, default-off)
            id_sri = os.path.join(lm_dir, f"{senti}_id.sri")
            if use_srilm:
                cnt = os.path.join(lm_dir, f"{senti}_id.count")
                subprocess.run(["ngram-count", "-text", id_txt, "-order",
                                "3", "-write", cnt], check=True)
                subprocess.run(["ngram-count", "-read", cnt, "-order", "3",
                                "-lm", id_sri, "-interpolate",
                                "-kndiscount"], check=True)
            elif isclm:
                subprocess.run([isclm, "train", id_txt, id_sri], check=True)
        if not have_kenlm:
            print("note: lmplz not found — KenLM arpa files skipped "
                  "(unused by the runtime, SURVEY.md §2.5)")
