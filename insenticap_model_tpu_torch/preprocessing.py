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
  Huffman JPEG of 1, 3 or 4 components; libjpeg's integer IDCT, fancy
  upsampling, colour space choice and colour tables, and libjpeg-turbo's
  block smoothing of an incomplete progression; YCbCr, RGB (Adobe
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
  decoded only as far as libwebp refuses it; RGB always. The other
  formats that Pillow's plugins recognise by signature (TIFF, PPM, ...)
  are refused by name.
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
import json
import math
import os
import random
import shutil
import struct
import subprocess
import zlib
from collections import Counter, defaultdict
from copy import deepcopy
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
         "isc_vp8l_alpha_check": [_P, _LL, _LL, _LL, _P, _I]}
_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# formats that Pillow's plugins recognise (by their ``_accept``
# signatures) and the decoders do not read: a refusal names them. Each
# entry: (name, offset, prefixes)
_REFUSED = (("TIFF", 0, (b"MM\0*", b"II*\0", b"MM*\0", b"II\0*",
                         b"MM\0+", b"II+\0")),
            ("XV thumbnail", 0, (b"P7 332",)),
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


def load_image_bytes(data: bytes) -> np.ndarray:
    """Encoded image bytes -> HWC uint8 RGB, or HW uint8 for a greyscale
    image (8-bit grey PNG, one-component JPEG, a GIF or BMP of grey
    indices), as the JAX package's PIL path gives them: every PNG (any
    colour type and depth, Adam7 or not), every 8-bit Huffman JPEG of 1, 3
    or 4 components (YCbCr, RGB, CMYK, YCCK), baseline or progressive,
    every GIF (its first frame), every BMP and every WebP, lossless (VP8L)
    or lossy (VP8, with ALPH or not), simple, extended or the first frame
    of an animation, that PIL opens. What PIL refuses, and what the
    decoders do not take (lossless, hierarchical, arithmetic, 12-bit or
    2-component JPEG; TIFF, PPM and the other formats of ``_REFUSED``, by
    name), raises ValueError."""
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
    for name, at, prefixes in _REFUSED:
        if data[at:].startswith(prefixes):
            raise ValueError(f"unsupported: {name} (the decoders read "
                             "JPEG, PNG, GIF, BMP and WebP)")
    raise ValueError("not an image the decoders read (JPEG, PNG, GIF, BMP, "
                     "WebP)")


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
