"""The committed image fixtures of the port's decoders
(``tests/data/torch_images/``) and the small writers of the files PIL
cannot write.

The fixtures: JPEGs, PNGs, GIFs, BMPs, lossless and lossy WebPs and TIFFs
written by PIL, or by the writers here (``write_jpeg``: YCCK;
``make_png``: Adam7-interlaced and 16-bit RGB; ``write_gif``,
``write_bmp``: what PIL does not write; ``vp8l``: an animation whose
first frame lies at an offset; ``vp8_frame``: a key frame with the simple
filter, four token partitions and filter deltas; ``write_tiff``: an
oriented RGBA Deflate strip, planar tiles, BigTIFF), and ``expected.npz``
holding PIL's decoded arrays (the JAX package's ``load_image_bytes``), for
the card's machine, which has no PIL. The
arrays are stored as differences along each row (uint8, wrapping), which
zlib packs to half the size, and an array two fixtures share once
(``SAME_PIXELS``); ``decode_expected`` undoes both.

    python tests/torch_images.py      # rewrites the directory

``tests/test_torch_imgdec.py`` rebuilds them and requires them equal to
what is committed, so that they cannot drift from PIL. The fixtures'
names, their directory and ``decode_expected`` live in ``chip_smoke.py``,
which reads them on the card without this file's PIL and JAX imports.

The writers: ``write_jpeg`` writes baseline or progressive JPEGs of random
quantised coefficients at any sampling factors, of 1 to 4 components,
with or without JFIF and Adobe markers; ``make_png`` writes PNGs of any
colour type and depth, each of the five row filters, Adam7 or not;
``write_gif`` writes GIFs of any colour tables, minimum code size and
frame placement, with graphic control and other extensions and more
frames (its LZW coder, ``chip_smoke.gif_lzw``, clears a full table or goes
on at 12 bits); ``write_bmp`` (``chip_smoke.write_bmp``, which also
writes the BMPs the smoke run times) writes BMPs of every header size,
depth, palette, bitfield layout and row order, or of RLE data given byte
for byte; ``vp8l`` (``chip_smoke.vp8l``) writes VP8L bitstreams of given
coded pixels: any of the four transforms in any order, a colour cache,
meta prefix codes, simple and normal prefix codes (repeat codes and
``max_symbol`` or not), literals, cache hits and backward references by
the distance map or plain distances; ``webp_file``, ``webp_chunk``,
``webp_vp8x``, ``webp_anim`` and ``webp_anmf`` wrap them in RIFF, VP8X and
ANIM/ANMF containers; ``vp8_frame`` writes VP8 key frames (lossy WebP)
through an RFC 6386 boolean encoder (``BoolEncoder``), every header
option (filter type, level, sharpness and deltas, segments, 1-8 token
partitions, the skip probability, probability updates, profile and the
scale bits) and each macroblock's modes and levels (``random_mb`` draws
them) by argument, with the decoder's tables (``vp8_tables``, read from
``csrc/imgdec.cc``)."""
import io
import os
import struct
import sys
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from chip_smoke import (FIXTURE_DIR as DIR, FIXTURES, SAME_PIXELS,  # noqa: E402,F401
                        VP8LBitWriter, decode_expected, gif_blocks, vp8l,
                        webp_anim, webp_anmf, webp_chunk, webp_file,
                        webp_vp8x)


def _photo(h, w, seed, noise=6.0):
    """A smooth image with some texture: what a camera gives, compressing
    to a few KB."""
    g = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(x / (w / 5.0)),
                    128 + 100 * np.cos(y / (h / 4.0)),
                    (x + y) * 255.0 / (h + w)], -1)
    img += g.normal(0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


# -- a small JPEG writer: what PIL cannot write ------------------------------

_ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19,
           26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49,
           56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52,
           45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
JFIF = b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"


def seg(marker, body):
    """A JPEG marker segment."""
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def adobe(transform):
    """An Adobe APP14 segment (version 100) with ``transform``."""
    return seg(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([transform]))


def _category(v):
    return int(abs(v)).bit_length()


def _band_syms(zz, i, ss, se, eob):
    """The AC symbols of zigzag coefficients ``ss..se`` of one block:
    runs of zeros (ZRL for 16), and at the band's end an EOB where ``eob``,
    else (a progressive scan's EOB run) the count of trailing zeros."""
    last = max([k for k in range(ss, se + 1) if zz[k]] or [ss - 1])
    syms, run = [], 0
    for k in range(ss, last + 1):
        if zz[k] == 0:
            run += 1
            continue
        while run > 15:
            syms.append(((1, i), 0xF0, 0, 0))
            run -= 16
        s = _category(zz[k])
        syms.append(((1, i), (run << 4) | s, zz[k], s))
        run = 0
    if last < se and eob:
        syms.append(((1, i), 0x00, 0, 0))
    return syms, last < se


def write_jpeg(width, height, factors, g, *, separate=False, dri=0,
               progressive=False, markers=seg(0xE0, JFIF), ids=None):
    """A JPEG of random sparse quantised coefficients (any block content
    is a valid image): ``factors`` [(h, v)] a component (1 to 4), one
    interleaved scan or one scan a component, restart interval ``dri``
    MCUs, Huffman tables of one code length fitted to the symbols used.
    ``markers`` follow SOI (a JFIF APP0 by default; ``adobe(t)`` for an
    Adobe one, ``b""`` for none); ``ids`` are the component ids (1, 2, ...
    by default). ``progressive``: SOF2 with spectral selection only (Al 0):
    the DC scan (interleaved unless ``separate``), then bands 1-5 and 6-63
    of each component, all-zero bands coded as EOB runs."""
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    ids = ids or list(range(1, len(factors) + 1))
    comps = []
    for ci, (h, v) in enumerate(factors):
        bh, bw = mcuy * v, mcux * h
        coef = np.zeros((bh, bw, 64), np.int64)
        coef[..., 0] = g.integers(-60, 60, (bh, bw))
        for k in range(1, 20):
            coef[..., k] = np.where(g.random((bh, bw)) < 0.3,
                                    g.integers(-30, 31, (bh, bw)), 0)
        comps.append({"id": ids[ci], "h": h, "v": v, "coef": coef,
                      "nbx": -(-(-(-width * h // hmax)) // 8),
                      "nby": -(-(-(-height * v // vmax)) // 8)})
    out = b"\xff\xd8" + markers
    for t in range(2):
        out += seg(0xDB, bytes([t]) + bytes(g.integers(1, 9, 64).tolist()))
    out += seg(0xC2 if progressive else 0xC0,
               struct.pack(">BHHB", 8, height, width, len(comps))
               + b"".join(bytes([c["id"], (c["h"] << 4) | c["v"], ci % 2])
                          for ci, c in enumerate(comps)))
    if dri:
        out += seg(0xDD, struct.pack(">H", dri))
    groups = [[c] for c in comps] if separate else [comps]
    if progressive:
        scans = [(grp, 0, 0) for grp in groups] + [
            ([c], ss, se) for c in comps for ss, se in ((1, 5), (6, 63))]
    else:
        scans = [(grp, 0, 63) for grp in groups]
    for group, ss, se in scans:
        if len(group) > 1:
            units = [[(i, my * c["v"] + yy, mx * c["h"] + xx)
                      for i, c in enumerate(group)
                      for yy in range(c["v"]) for xx in range(c["h"])]
                     for my in range(mcuy) for mx in range(mcux)]
        else:
            units = [[(0, by, bx)] for by in range(group[0]["nby"])
                     for bx in range(group[0]["nbx"])]
        syms, pred, eobrun = [], [0] * len(group), 0

        def end_run():
            nonlocal eobrun
            if eobrun:
                r = eobrun.bit_length() - 1
                syms.append(((1, 0), r << 4, eobrun - (1 << r), r))
                eobrun = 0

        for u, unit in enumerate(units):
            if dri and u and u % dri == 0:
                end_run()
                pred = [0] * len(group)
                syms.append(None)                      # a restart marker
            for i, by, bx in unit:
                blk = group[i]["coef"][by, bx]
                zz = [int(blk[_ZIGZAG[k]]) for k in range(64)]
                if ss == 0:
                    diff = zz[0] - pred[i]
                    pred[i] = zz[0]
                    s = _category(diff)
                    syms.append(((0, i), s, diff, s))
                if se == 0:
                    continue
                band, open_end = _band_syms(zz, i, max(ss, 1), se,
                                            not progressive)
                if band:
                    end_run()
                syms.extend(band)
                if progressive and open_end:
                    eobrun += 1
                    if eobrun == 0x7FFF:
                        end_run()
        end_run()
        tables, body = {}, b""
        for i in range(len(group)):
            for tc in (0, 1):
                used = sorted({x[1] for x in syms
                               if x is not None and x[0] == (tc, i)})
                if not used:
                    continue
                L = max(1, len(used).bit_length())
                tables[(tc, i)] = (L, {s: j for j, s in enumerate(used)})
                counts = [0] * 16
                counts[L - 1] = len(used)
                body += bytes([(tc << 4) | i]) + bytes(counts) + bytes(used)
        out += seg(0xC4, body)
        out += seg(0xDA, bytes([len(group)]) + b"".join(
            bytes([c["id"], (i << 4) | i]) for i, c in enumerate(group))
            + bytes([ss, se, 0]))
        bits, data, rst = [], bytearray(), 0

        def flush():
            bits.extend([1] * (-len(bits) % 8))
            for j in range(0, len(bits), 8):
                b = int("".join(map(str, bits[j:j + 8])), 2)
                data.extend([b, 0] if b == 0xFF else [b])
            bits.clear()

        for x in syms:
            if x is None:
                flush()
                data.extend([0xFF, 0xD0 + rst])
                rst = (rst + 1) & 7
                continue
            key, sym, val, nb = x
            L, codes = tables[key]
            bits.extend(int(b) for b in format(codes[sym], f"0{L}b"))
            if nb:
                v = val if val >= 0 else val + (1 << nb) - 1
                bits.extend(int(b) for b in format(v, f"0{nb}b"))
        flush()
        out += bytes(data)
    return out + b"\xff\xd9"


def write_lossless_jpeg(img):
    """A lossless JPEG (SOF3) of a uint8 grey image [h, w]: predictor 1
    (the left neighbour; the row above in the first column, 128 first),
    no point transform, one Huffman table of all 17 difference categories
    at 5 bits. PIL 12.1 (libjpeg-turbo 3) decodes it."""
    h, w = img.shape
    x = img.astype(np.int64)
    pred = np.empty_like(x)
    pred[:, 1:] = x[:, :-1]
    pred[1:, 0] = x[:-1, 0]
    pred[0, 0] = 128
    bits = []
    for d in (x - pred).ravel().tolist():
        s = abs(d).bit_length()
        bits += [int(c) for c in format(s, "05b")]
        if s:
            v = d if d >= 0 else d + (1 << s) - 1
            bits += [int(c) for c in format(v, f"0{s}b")]
    bits += [1] * (-len(bits) % 8)
    data = bytearray()
    for j in range(0, len(bits), 8):
        b = int("".join(map(str, bits[j:j + 8])), 2)
        data.extend([b, 0] if b == 0xFF else [b])
    counts = [0] * 16
    counts[4] = 17
    return (b"\xff\xd8"
            + seg(0xC3, struct.pack(">BHHB", 8, h, w, 1) + b"\x01\x11\x00")
            + seg(0xC4, b"\x00" + bytes(counts) + bytes(range(17)))
            + seg(0xDA, b"\x01\x01\x00\x01\x00\x00") + bytes(data)
            + b"\xff\xd9")


# -- a small PNG writer: interlaced and 16-bit, each row filter -----------

# Adam7's passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def chunk(kind, body):
    """A PNG chunk with its CRC."""
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filtered(rows, bpp, ft):
    """[h, rowbytes] uint8 rows under filter ``ft`` (-1: each row its own,
    in turn), each with its filter byte."""
    rows = np.asarray(rows, np.int64).reshape(len(rows), -1)
    out = []
    for y, r in enumerate(rows):
        f = ft if ft >= 0 else y % 5
        up = rows[y - 1] if y else np.zeros_like(r)
        if f in (0, 2):           # no left neighbour: vectorised
            enc = r - (up if f == 2 else 0)
        else:                     # Sub, Average, Paeth: from the raw row
            a = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])[:len(r)]
            c = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])[:len(r)]
            pred = {1: a, 3: (a + up) // 2, 4: _paeth(a, up, c)}[f]
            enc = r - pred
        out.append(bytes([f]) + (enc % 256).astype(np.uint8).tobytes())
    return b"".join(out)


def _pack(samples, depth):
    """[h, w, c] sample values -> [h, rowbytes] uint8 rows (big-endian
    within a byte below 8 bits, and at 16)."""
    h, w, c = samples.shape
    if depth == 16:
        return samples.astype(">u2").reshape(h, -1).view(np.uint8)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    per = 8 // depth
    v = np.zeros((h, -(-w // per) * per), np.uint8)
    v[:, :w] = samples[:, :, 0]
    v = v.reshape(h, -1, per) << np.arange(8 - depth, -1, -depth,
                                           dtype=np.uint8)
    return np.bitwise_or.reduce(v, axis=2).astype(np.uint8)


def png_file(w, h, depth, ctype, idat, *, interlace=0, plte=None,
             chunks=b""):
    """A PNG of the (filtered) image data ``idat``, deflated; ``chunks``
    go between IHDR (and PLTE) and IDAT."""
    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if plte is not None:
        data += chunk(b"PLTE", plte)
    return (data + chunks + chunk(b"IDAT", zlib.compress(idat))
            + chunk(b"IEND", b""))


def image_data(samples, depth, ft=-1, interlace=0):
    """PNG image data (before deflate) of ``samples`` [h, w, channels] at
    ``depth`` bits, each row under filter ``ft`` (-1: each of the five in
    turn); ``interlace`` 1: Adam7, each pass filtered as an image of its
    own, empty passes left out."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[:, :, None]
    subs = ([samples] if not interlace else
            [samples[y0::dy, x0::dx] for x0, y0, dx, dy in ADAM7])
    bpp = max(1, samples.shape[2] * depth // 8)
    return b"".join(filtered(_pack(s, depth), bpp, ft) for s in subs
                    if s.size)


def make_png(samples, depth, ctype, ft=-1, *, interlace=0, plte=None,
             chunks=b""):
    """A PNG of ``samples`` [h, w, channels] (the colour type's channels;
    palette indices for type 3): ``image_data``, deflated."""
    h, w = np.shape(samples)[:2]
    return png_file(w, h, depth, ctype,
                    image_data(samples, depth, ft, interlace),
                    interlace=interlace, plte=plte, chunks=chunks)


# -- a small GIF writer: what PIL cannot write ------------------------------

def _table_bits(table):
    """A colour table's size field: 3 << (bits + 1) bytes."""
    return max(0, (len(table) // 3 - 1).bit_length() - 1)


def gif_frame(idx, pos=(0, 0), *, local_table=None, transparency=None,
              interlace=False, min_size=8, **lzw):
    """One GIF image: a graphic control block where ``transparency`` is an
    index, the image descriptor of [h, w] indices ``idx`` at ``pos`` (x,
    y), its ``local_table`` (RGB bytes, 2^k entries) if any, the
    LZW data of its rows (in the interlaced order 0::8, 4::8, 2::4, 1::2
    where ``interlace``) at ``min_size``; ``lzw``: ``gif_lzw``'s
    options."""
    idx = np.asarray(idx)
    h, w = idx.shape
    out = b""
    if transparency is not None:
        out += b"!\xf9\x04\x01\x00\x00" + bytes([transparency]) + b"\x00"
    flags = (0x40 if interlace else 0) | (
        0x80 | _table_bits(local_table) if local_table is not None else 0)
    out += b"," + struct.pack("<HHHHB", pos[0], pos[1], w, h, flags)
    if local_table is not None:
        out += local_table
    if interlace:
        idx = np.concatenate([idx[0::8], idx[4::8], idx[2::4], idx[1::2]])
    return out + bytes([min_size]) + gif_blocks(
        chip_smoke.gif_lzw(np, idx, min_size, **lzw))


def write_gif(idx, *, screen=None, table=None, background=0, version=b"89a",
              extensions=b"", frames=(), **frame):
    """A GIF of frame ``idx`` (``gif_frame``'s arguments in ``frame``) on
    a logical ``screen`` (w, h; the frame's size by default) with global
    colour ``table`` (RGB bytes, 2^k entries) if any; ``extensions`` (raw
    blocks) before the first frame, ``frames`` (keyword dicts of
    ``gif_frame``) after it."""
    h, w = np.shape(idx)
    sw, sh = screen or (w, h)
    flags = 0x80 | _table_bits(table) if table is not None else 0
    out = (b"GIF" + version + struct.pack("<HHBBB", sw, sh, flags,
                                          background, 0)
           + (table or b"") + extensions + gif_frame(idx, **frame))
    for f in frames:
        out += gif_frame(**f)
    return out + b";"


# -- the BMP writer (every header, depth and layout) is chip_smoke's -------

def write_bmp(px, bits, **kw):
    """``chip_smoke.write_bmp`` with numpy."""
    return chip_smoke.write_bmp(np, px, bits, **kw)


def _bitrev(data: bytes) -> bytes:
    table = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))
    return bytes(data).translate(table)


def _tiff_rows(samples, bits, order, fmt):
    """[n, w, k] samples -> [n, rowbytes] uint8 rows: MSB-first bit
    packing below 8 bits and at 12, else each sample in the byte order
    (unsigned, signed or IEEE float by ``fmt``, the SampleFormat)."""
    n, w, k = samples.shape
    if bits in (8, 16, 32, 64):
        kind = {1: "u", 2: "i", 3: "f"}[fmt]
        dt = np.dtype(order + kind + str(bits // 8))
        return samples.astype(dt).reshape(n, -1).view(np.uint8)
    vals = samples.reshape(n, w * k).astype(np.uint64)
    shifts = np.arange(bits - 1, -1, -1, dtype=np.uint64)
    bitrows = ((vals[:, :, None] >> shifts) & 1).reshape(n, -1)
    pad = -bitrows.shape[1] % 8
    bitrows = np.concatenate([bitrows, np.zeros((n, pad), np.uint64)], 1)
    return np.packbits(bitrows.astype(np.uint8), axis=1)


def _tiff_predict(samples, bits):
    """Horizontal differencing (predictor 2) of [n, w, k] samples."""
    mod = 1 << bits
    s = samples.astype(np.int64)
    d = s.copy()
    d[:, 1:] -= s[:, :-1]
    return d % mod


def tiff_page(samples, bits=8, photometric=None, *, order="<",
              sample_format=1, extra_samples=(), planar=1,
              rows_per_strip=None, tile=None, compression=1, predictor=1,
              fill_order=1, colormap=None, orientation=None, tags=(),
              offset_type=4):
    """(entries, blocks) of one TIFF page of ``samples`` ([h, w] or [h, w,
    k], each sample ``bits`` wide): strips of ``rows_per_strip`` rows (all
    by default) or ``tile`` = (width, length) tiles, padded at the edges;
    ``planar`` 2: a plane of strips or tiles a sample; ``compression`` 1
    (none), 32773 (PackBits, each row on its own) or 8 / 32946 (zlib, with
    ``predictor`` 2's differencing first where asked); ``fill_order`` 2
    reverses the bits of every stored byte. Photometric 1 (grey) for one
    or two samples and 2 (RGB) for more, by default. ``tags``: entries
    (tag, type, values) that replace the page's own of that tag, or add
    one (type None drops it); the entries are sorted by tag."""
    import zlib as _zlib
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[:, :, None]
    h, w, k = samples.shape
    if photometric is None:
        photometric = 1 if k <= 2 else 2

    def encode(part):                 # [n, pw, pk] samples -> stored bytes
        if predictor == 2:
            part = _tiff_predict(part, bits)
        rows = _tiff_rows(part, bits, order, sample_format)
        if compression in (8, 32946):
            data = _zlib.compress(rows.tobytes())
        elif compression == 32773:
            data = b"".join(chip_smoke.packbits(r.tobytes()) for r in rows)
        else:
            data = rows.tobytes()
        return _bitrev(data) if fill_order == 2 else data
    planes = [samples] if planar == 1 else [samples[:, :, i:i + 1]
                                            for i in range(k)]
    blocks = []
    for plane in planes:
        if tile is None:
            rps = rows_per_strip or h
            blocks += [encode(plane[y:y + rps]) for y in range(0, h, rps)]
        else:
            tw, tl = tile
            for y in range(0, h, tl):
                for x in range(0, w, tw):
                    part = np.zeros((tl, tw, plane.shape[2]), plane.dtype)
                    sub = plane[y:y + tl, x:x + tw]
                    part[:sub.shape[0], :sub.shape[1]] = sub
                    blocks.append(encode(part))
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * k),
               259: (3, [compression]), 262: (3, [photometric]),
               277: (3, [k])}
    if tile is None:
        entries.update({273: (offset_type, "offsets"),
                        278: (4, [rows_per_strip or h]),
                        279: (offset_type, "counts")})
    else:
        entries.update({322: (4, [tile[0]]), 323: (4, [tile[1]]),
                        324: (offset_type, "offsets"),
                        325: (offset_type, "counts")})
    if planar != 1:
        entries[284] = (3, [planar])
    if predictor != 1:
        entries[317] = (3, [predictor])
    if fill_order != 1:
        entries[266] = (3, [fill_order])
    if sample_format != 1:
        entries[339] = (3, [sample_format] * k)
    if extra_samples:
        entries[338] = (3, list(extra_samples))
    if colormap is not None:
        entries[320] = (3, list(colormap))
    if orientation is not None:
        entries[274] = (3, [orientation])
    for tag, typ, vals in tags:
        if typ is None:
            entries.pop(tag, None)
        else:
            entries[tag] = (typ, vals)
    return [(t, typ, v) for t, (typ, v) in sorted(entries.items())], blocks


def write_tiff(samples, bits=8, photometric=None, *, order="<",
               bigtiff=False, magic=None, loop=False, pages=(), **kw):
    """A TIFF of ``tiff_page(samples, ...)`` (``chip_smoke.tiff_file``),
    then the pages ``pages`` ([(entries, blocks)]) chained after it."""
    page = tiff_page(samples, bits, photometric, order=order, **kw)
    return chip_smoke.tiff_file([page, *pages], order=order,
                                bigtiff=bigtiff, magic=magic, loop=loop)


# -- a VP8 key-frame writer (lossy WebP): every header option by argument ---

# the 4x4 intra modes in libwebp's order; the 16x16 and chroma modes are
# DC, TM, V (VE) and H (HE)
B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU = range(10)
_VP8_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_VP8_CATS = ((173, 148, 140), (176, 155, 140, 135),
             (180, 157, 141, 134, 130),
             (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# the 4x4 mode tree (a leaf is minus its mode, a node its pair's index)
_VP8_TREE = (-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5, -B_RD, -B_VR,
             -B_LD, 7, -B_VL, 8, -B_HD, -B_HU)
_IMGDEC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "insenticap_model_tpu_torch", "csrc", "imgdec.cc")


def vp8_tables():
    """The decoder's RFC 6386 tables, read from ``csrc/imgdec.cc`` (one
    copy for the decoder and this writer): {name: int array}."""
    import re
    src = open(_IMGDEC).read()
    out = {}
    for name, shape in (("kCoeffsProba0", (4, 8, 3, 11)),
                        ("kCoeffsUpdateProba", (4, 8, 3, 11)),
                        ("kBModesProba", (10, 10, 9)), ("kDcTable", (128,)),
                        ("kAcTable", (128,))):
        body = re.search(r"\b%s\[[^=]*=\s*\{(.*?)\};" % name, src, re.S)
        out[name] = np.array(re.findall(r"\d+", body.group(1)),
                             int).reshape(shape)
    return out


def _tree_paths(tree):
    """{leaf: [(node, bit), ...]} of a tree coded as ``_VP8_TREE``."""
    paths, todo = {}, [(0, [])]
    while todo:
        node, path = todo.pop()
        for bit in (0, 1):
            nxt = tree[2 * node + bit]
            step = path + [(node, bit)]
            if nxt > 0:
                todo.append((nxt, step))
            else:
                paths[-nxt] = step
    return paths


_BMODE_PATHS = _tree_paths(_VP8_TREE)


class BoolEncoder:
    """RFC 6386's boolean encoder (section 7.3) on an unbounded integer:
    the interval's low end, shifted as the range is renormalised; the
    bytes are that end, its last byte filled with zeros (the fewest the
    decoder reads without reaching past them)."""

    def __init__(self):
        self.low, self.range, self.shifts = 0, 255, 0

    def put(self, bit, prob):
        split = 1 + (((self.range - 1) * int(prob)) >> 8)
        if bit:
            self.low += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            self.low <<= 1
            self.shifts += 1

    def value(self, v, bits):
        for i in reversed(range(bits)):
            self.put(v >> i & 1, 128)

    def signed(self, v, bits):
        self.value(abs(v), bits)
        self.put(v < 0, 128)

    def flagged(self, v, bits, signed=True):
        """A flag, then the value where it is not None."""
        self.put(v is not None, 128)
        if v is not None:
            (self.signed if signed else self.value)(v, bits)

    def bytes(self, pad=0):
        n = (self.shifts + 15) // 8
        return (self.low << (8 * n - 8 - self.shifts)).to_bytes(n, "big") \
            + bytes(pad)


def _put_large(enc, v, p):
    """GetLargeValue's tree: a magnitude of 2 to 2114."""
    if v <= 4:
        enc.put(0, p[3])
        enc.put(v > 2, p[4])
        if v > 2:
            enc.put(v - 3, p[5])
    elif v <= 10:
        enc.put(1, p[3])
        enc.put(0, p[6])
        enc.put(v > 6, p[7])
        if v <= 6:
            enc.put(v - 5, 159)
        else:
            enc.put((v - 7) >> 1, 165)
            enc.put((v - 7) & 1, 145)
    else:
        cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
        assert v <= 2114, v
        enc.put(1, p[3])
        enc.put(1, p[6])
        enc.put(cat >> 1, p[8])
        enc.put(cat & 1, p[9 + (cat >> 1)])
        tab, extra = _VP8_CATS[cat], v - 3 - (8 << cat)
        for i, pr in enumerate(tab):
            enc.put(extra >> (len(tab) - 1 - i) & 1, pr)


def _put_tokens(enc, prob, ctx, levels, first):
    """A block's levels (zigzag order) from index ``first``: EOB after the
    last non-zero one; True where one is non-zero."""
    nz = [i for i in range(first, 16) if levels[i]]
    last = nz[-1] if nz else -1
    n, p = first, prob[_VP8_BANDS[first]][ctx]
    while n < 16:
        enc.put(n <= last, p[0])
        if n > last:
            break
        while not levels[n]:
            enc.put(0, p[1])
            n += 1
            p = prob[_VP8_BANDS[n]][0]
        enc.put(1, p[1])
        v, nxt = abs(int(levels[n])), prob[_VP8_BANDS[n + 1]]
        enc.put(v > 1, p[2])
        if v > 1:
            _put_large(enc, v, p)
        p = nxt[2 if v > 1 else 1]
        enc.put(levels[n] < 0, 128)
        n += 1
    return bool(nz)


def random_mb(g, p4=0.5, density=0.3, big=0.05, large=2114):
    """A macroblock of ``vp8_frame``: 4x4 modes (share ``p4``) or a 16x16
    mode with Y2 levels, a chroma mode, and levels in -3..3 (a ``density``
    share non-zero), a block in ``big`` with one level up to ``large``
    (DCT_CAT6); segment and skip flag random."""
    def levels():
        v = g.integers(-3, 4, 16) * (g.random(16) < density)
        if g.random() < big:
            v[g.integers(0, 16)] = int(g.integers(-large, large + 1))
        return v.tolist()
    mb = {"uvmode": int(g.integers(0, 4)), "segment": int(g.integers(0, 4)),
          "skip": bool(g.random() < 0.2)}
    if g.random() < p4:
        mb["bmodes"] = g.integers(0, 10, 16).tolist()
    else:
        mb.update(ymode=int(g.integers(0, 4)), y2=levels())
    mb.update(y=[levels() for _ in range(16)], u=[levels() for _ in range(4)],
              v=[levels() for _ in range(4)])
    return mb


def webp_chunks(data):
    """The chunks of a WebP file, each with its header and pad byte."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        n = int.from_bytes(data[pos + 4:pos + 8], "little")
        out.append(data[pos:pos + 8 + n + (n & 1)])
        pos += 8 + n + (n & 1)
    return out


def vp8_frame(w, h, mbs, *, q=40, dq=(None,) * 5, simple=0, level=0,
              sharpness=0, lf_delta=None, segments=None, partitions=1,
              skip_prob=None, updates=None, profile=0, scale=(0, 0),
              colour_space=0, clamp_type=0, refresh=0, pad=0):
    """A VP8 key frame of w x h (a VP8 chunk's payload).

    ``mbs``: a dict a macroblock, in raster order: ``ymode`` (a 16x16
    mode: B_DC, B_TM, B_VE, B_HE) or ``bmodes`` (16 4x4 modes, raster
    order), ``uvmode``, ``segment``, ``skip`` (coded where ``skip_prob``
    is given: then no tokens), and levels in zigzag order, each a list of
    16: ``y2`` (a 16x16 macroblock's), ``y`` (16 blocks; a 16x16 one's DCs
    ignored), ``u`` and ``v`` (4 each); absent ones are zeros.

    The header: quantiser ``q`` and the five deltas ``dq`` (y1 DC, y2 DC,
    y2 AC, uv DC, uv AC; None uncoded); the filter (``simple``, ``level``,
    ``sharpness``); ``lf_delta``: None, or {"update": bool, "ref": 4,
    "mode": 4} (None entries uncoded); ``segments``: None, or {"map": 3
    probabilities (None entries uncoded: 255) or None for no map, "data":
    None or {"absolute": bool, "quant": 4, "filter": 4}}; 1, 2, 4 or 8
    token ``partitions`` (macroblock row r in partition r mod the count);
    ``updates``: {(t, b, c, p): probability}; ``profile``, the two
    ``scale`` fields, the colour space, clamping type and refresh bits
    (read and ignored); ``pad`` zero bytes after each partition."""
    mbw, mbh = (w + 15) >> 4, (h + 15) >> 4
    assert len(mbs) == mbw * mbh
    tabs = vp8_tables()
    proba = tabs["kCoeffsProba0"].copy()
    for k, v in (updates or {}).items():
        proba[k] = v
    hdr = BoolEncoder()
    hdr.put(colour_space, 128)
    hdr.put(clamp_type, 128)
    seg = segments or {}
    hdr.put(segments is not None, 128)
    if segments is not None:
        hdr.put(seg.get("map") is not None, 128)
        data = seg.get("data")
        hdr.put(data is not None, 128)
        if data is not None:
            hdr.put(data["absolute"], 128)
            for v in data["quant"]:
                hdr.flagged(v, 7)
            for v in data["filter"]:
                hdr.flagged(v, 6)
        for v in seg.get("map") or ():
            hdr.flagged(v, 8, signed=False)
    hdr.put(simple, 128)
    hdr.value(level, 6)
    hdr.value(sharpness, 3)
    hdr.put(lf_delta is not None, 128)
    if lf_delta is not None:
        hdr.put(lf_delta["update"], 128)
        if lf_delta["update"]:
            for v in list(lf_delta["ref"]) + list(lf_delta["mode"]):
                hdr.flagged(v, 6)
    hdr.value({1: 0, 2: 1, 4: 2, 8: 3}[partitions], 2)
    hdr.value(q, 7)
    for v in dq:
        hdr.flagged(v, 4)
    hdr.put(refresh, 128)
    upd = tabs["kCoeffsUpdateProba"]
    for k in np.ndindex(4, 8, 3, 11):
        hdr.put(k in (updates or {}), upd[k])
        if k in (updates or {}):
            hdr.value(updates[k], 8)
    hdr.put(skip_prob is not None, 128)
    if skip_prob is not None:
        hdr.value(skip_prob, 8)
    parts = [BoolEncoder() for _ in range(partitions)]
    seg_map = seg.get("map")
    intra_t = [B_DC] * (4 * mbw)
    top = {"y": [0] * (4 * mbw), "u": [0] * (2 * mbw), "v": [0] * (2 * mbw),
           "dc": [0] * mbw}
    for mb_y in range(mbh):
        intra_l = [B_DC] * 4
        left = {"y": [0] * 4, "u": [0] * 2, "v": [0] * 2, "dc": [0]}
        tok = parts[mb_y % partitions]
        for mb_x in range(mbw):
            mb = mbs[mb_y * mbw + mb_x]
            if seg_map is not None:
                s = mb.get("segment", 0)
                probs = [255 if p is None else p for p in seg_map]
                hdr.put(s >= 2, probs[0])
                hdr.put(s & 1, probs[1 + (s >= 2)])
            skip = skip_prob is not None and mb.get("skip", False)
            if skip_prob is not None:
                hdr.put(skip, skip_prob)
            i4x4 = "bmodes" in mb
            hdr.put(not i4x4, 145)
            if not i4x4:
                m = mb["ymode"]
                hdr.put(m in (B_TM, B_HE), 156)
                if m in (B_TM, B_HE):
                    hdr.put(m == B_TM, 128)
                else:
                    hdr.put(m == B_VE, 163)
                intra_t[4 * mb_x:4 * mb_x + 4] = [m] * 4
                intra_l = [m] * 4
            else:
                for y in range(4):
                    for x in range(4):
                        m = mb["bmodes"][4 * y + x]
                        prob = tabs["kBModesProba"][intra_t[4 * mb_x + x],
                                                    intra_l[y]]
                        for node, bit in _BMODE_PATHS[m]:
                            hdr.put(bit, prob[node])
                        intra_t[4 * mb_x + x] = intra_l[y] = m
            uv = mb.get("uvmode", B_DC)
            hdr.put(uv != B_DC, 142)
            if uv != B_DC:
                hdr.put(uv != B_VE, 114)
                if uv != B_VE:
                    hdr.put(uv == B_TM, 183)
            if skip:
                for k, n in (("y", 4), ("u", 2), ("v", 2)):
                    top[k][n * mb_x:n * mb_x + n] = [0] * n
                    left[k] = [0] * n
                if not i4x4:
                    top["dc"][mb_x] = left["dc"][0] = 0
                continue
            zero = [0] * 16
            if not i4x4:
                t = top["dc"][mb_x]
                nz = _put_tokens(tok, proba[1], t + left["dc"][0],
                                 mb.get("y2", zero), 0)
                top["dc"][mb_x] = left["dc"][0] = int(nz)
            first, t_y = (0, 3) if i4x4 else (1, 0)
            ys = mb.get("y", [zero] * 16)
            for y in range(4):
                for x in range(4):
                    i = 4 * mb_x + x
                    nz = _put_tokens(tok, proba[t_y], top["y"][i]
                                     + left["y"][y], ys[4 * y + x], first)
                    top["y"][i] = left["y"][y] = int(nz)
            for k in ("u", "v"):
                bl = mb.get(k, [zero] * 4)
                for y in range(2):
                    for x in range(2):
                        i = 2 * mb_x + x
                        nz = _put_tokens(tok, proba[2], top[k][i]
                                         + left[k][y], bl[2 * y + x], 0)
                        top[k][i] = left[k][y] = int(nz)
    first = hdr.bytes(pad)
    rest = [p.bytes(pad) for p in parts]
    bits = profile << 1 | 1 << 4 | len(first) << 5
    return (bits.to_bytes(3, "little") + b"\x9d\x01\x2a"
            + struct.pack("<HH", w | scale[0] << 14, h | scale[1] << 14)
            + first + b"".join(len(p).to_bytes(3, "little")
                               for p in rest[:-1]) + b"".join(rest))


def build():
    """{file name: bytes} of every fixture, written by PIL or, where PIL
    cannot, by the writers here."""
    from PIL import Image
    out = {}

    def save(name, im, fmt, **kw):
        buf = io.BytesIO()
        im.save(buf, fmt, **kw)
        out[name] = buf.getvalue()

    small = Image.fromarray(_photo(45, 61, 0))
    save("j444.jpg", small, "JPEG", quality=90, subsampling=0)
    save("j422.jpg", small, "JPEG", quality=75, subsampling=1)
    photo448 = Image.fromarray(_photo(448, 448, 1, 1.0))
    save("j420_448.jpg", photo448, "JPEG", quality=75, subsampling=2)
    save("grey.jpg", small.convert("L"), "JPEG", quality=80)
    save("rst.jpg", Image.fromarray(_photo(37, 53, 2)), "JPEG", quality=85,
         subsampling=2, restart_marker_blocks=3)
    save("prog.jpg", small, "JPEG", quality=75, progressive=True)
    save("prog420_448.jpg", photo448, "JPEG", quality=75, subsampling=2,
         progressive=True)
    save("prog_rst.jpg", Image.fromarray(_photo(37, 53, 8)), "JPEG",
         quality=85, subsampling=2, progressive=True,
         restart_marker_blocks=2)
    save("cmyk.jpg", small.convert("CMYK"), "JPEG", quality=75)
    # j420_448's photo as CMYK: PIL's 4:2:0 samples C at 2x2, M, Y, K 1x1
    save("cmyk420_448.jpg", photo448.convert("CMYK"), "JPEG", quality=75,
         subsampling=2)
    save("adobe_rgb.jpg", small, "JPEG", quality=75, subsampling=0,
         keep_rgb=True)                 # Adobe transform 0, no JFIF
    out["ycck.jpg"] = write_jpeg(37, 29, [(2, 2), (1, 1), (1, 1), (2, 2)],
                                 np.random.default_rng(12),
                                 markers=adobe(2))
    # a 12-bit frame header: PIL and the port both refuse it
    j12 = bytearray(out["j444.jpg"])
    j12[j12.index(b"\xff\xc0") + 4] = 12
    out["j12bit.jpg"] = bytes(j12)
    rgb = _photo(33, 47, 3)
    save("rgb.png", Image.fromarray(rgb), "PNG")
    out["adam7.png"] = make_png(rgb, 8, 2, interlace=1)
    g = np.random.default_rng(13)
    out["rgb16.png"] = make_png((rgb.astype(np.uint16) << 8)
                                | g.integers(0, 256, rgb.shape), 16, 2)
    save("grey16.png", Image.fromarray(
        g.integers(0, 600, (23, 29)).astype(np.uint16)), "PNG")
    pal = Image.fromarray(_photo(31, 39, 14)).quantize(16)
    out["adam7_p4.png"] = make_png(np.asarray(pal), 4, 3, interlace=1,
                                   plte=bytes(pal.getpalette()[:48]))
    rgba = np.concatenate([_photo(29, 41, 4),
                           _photo(29, 41, 5)[:, :, :1]], -1)
    save("rgba.png", Image.fromarray(rgba), "PNG")
    save("p.png", Image.fromarray(_photo(31, 39, 6)).quantize(37), "PNG")
    # GIF: PIL's interlaced palette GIF (both sides 16 or more) and its
    # grey ramp (written from mode "1", read as "L"); the writer's frame
    # at an offset in a larger screen, with a transparency index
    save("interlaced.gif", Image.fromarray(_photo(31, 39, 15)).quantize(64),
         "GIF")
    save("ramp.gif", Image.fromarray(_photo(23, 29, 16)).convert("1"), "GIF")
    g = np.random.default_rng(17)
    out["offset.gif"] = write_gif(
        g.integers(0, 6, (9, 11)), screen=(15, 13), pos=(3, 2),
        table=bytes(g.integers(0, 256, 24, dtype=np.uint8).tolist()),
        transparency=5, min_size=3)
    # BMP: PIL's 8-bit palette and 24-bit files (rgb.png's pixels); the
    # writer's RLE8 with a delta and 5-6-5 bitfields
    save("p8.bmp", Image.fromarray(_photo(31, 39, 6)).quantize(37), "BMP")
    save("rgb24.bmp", Image.fromarray(rgb), "BMP")
    # 6x4, bottom-up: an encoded run, end of line, an absolute run (word
    # aligned), a delta (Pillow reads the two bytes after its escape as
    # padding, then right 2 and up 1), an encoded run cut at the row's
    # end that fills the image before the end of line and of bitmap
    rle = bytes([4, 7, 0, 0, 0, 5, 1, 2, 3, 4, 5, 0, 0, 2, 9, 9, 2, 1,
                 6, 3, 0, 0, 3, 6, 0, 1])
    out["rle8.bmp"] = write_bmp(np.zeros((4, 6)), 8, rle=rle, compression=1,
                                palette=g.integers(0, 256, (8, 3)))
    out["bf565.bmp"] = write_bmp(g.integers(0, 1 << 16, (13, 17)), 16,
                                 header=124, compression=3,
                                 masks=(0xF800, 0x7E0, 0x1F))
    # lossless WebP: PIL's of rgb.png's, p.png's and rgba.png's pixels (the
    # RGB under alpha kept exactly), a VP8X file with an ICC profile, and
    # j420_448.jpg's decoded pixels at PIL's default method; the writer's
    # animation, its first frame at an offset on a larger canvas
    save("lossless_rgb.webp", Image.fromarray(rgb), "WEBP", lossless=True)
    save("lossless_p.webp", Image.fromarray(_photo(31, 39, 6)).quantize(37),
         "WEBP", lossless=True)
    save("lossless_rgba.webp", Image.fromarray(rgba), "WEBP", lossless=True,
         exact=True)
    save("lossless_icc.webp", Image.fromarray(_photo(27, 35, 18)), "WEBP",
         lossless=True, icc_profile=bytes(range(64)))
    save("lossless_448.webp", Image.open(io.BytesIO(out["j420_448.jpg"])),
         "WEBP", lossless=True)
    g = np.random.default_rng(19)
    frames = [vp8l(np, 0xFF000000 | g.integers(0, 1 << 24, s).astype(
        np.uint32), cache_bits=3) for s in ((7, 10), (15, 19))]
    out["lossless_anim.webp"] = webp_file(
        webp_vp8x(19, 15, 0x02), webp_anim(),
        webp_anmf(6, 4, 10, 7, webp_chunk(b"VP8L", frames[0])),
        webp_anmf(0, 0, 19, 15, webp_chunk(b"VP8L", frames[1])))
    # lossy WebP: PIL's (quality 80 unless named) of rgb.png's pixels (odd
    # sizes), of a grey image (which opens as RGB), of rgba.png's (VP8X,
    # ALPH, VP8), and of j420_448.jpg's decoded pixels at quality 80 and
    # 100; a lossy RGBA frame of PIL's (its ALPH and VP8 chunks) at an
    # offset as an animation's first frame; the writer's frame with the
    # simple filter, sharpness 3, four token partitions and filter deltas
    save("lossy_rgb.webp", Image.fromarray(rgb), "WEBP")
    save("lossy_grey.webp", small.convert("L"), "WEBP", quality=70)
    save("lossy_rgba.webp", Image.fromarray(rgba), "WEBP")
    save("lossy_448.webp", Image.open(io.BytesIO(out["j420_448.jpg"])),
         "WEBP")
    save("lossy_448_q100.webp", Image.open(io.BytesIO(out["j420_448.jpg"])),
         "WEBP", quality=100)
    frames = []
    for px in (rgba[:13, :17], rgb[:21, :25]):
        buf = io.BytesIO()
        Image.fromarray(px).save(buf, "WEBP", quality=60)
        frames.append(webp_chunks(buf.getvalue()))
    out["lossy_anim.webp"] = webp_file(
        webp_vp8x(25, 21, 0x12), webp_anim(),
        webp_anmf(6, 4, 17, 13, *frames[0][1:]),    # ALPH, VP8
        webp_anmf(0, 0, 25, 21, *frames[1]))
    g = np.random.default_rng(20)
    out["lossy_hand.webp"] = webp_file(webp_chunk(b"VP8 ", vp8_frame(
        37, 29, [random_mb(g) for _ in range(6)], q=30, simple=1, level=24,
        sharpness=3, partitions=4, lf_delta={"update": True,
                                             "ref": [-6, None, 4, None],
                                             "mode": [9, None, None, -3]})))
    # TIFF: PIL's uncompressed RGB of rgb.png's pixels and PackBits of
    # p.png's palette image; the writer's CIELAB (a photo's bytes as L, a*,
    # b*; PIL's own LAB file holds a profile stamped with its time), RGBA
    # of rgba.png's pixels under Deflate with predictor 2 and orientation
    # 6, a big-endian CMYK in planar 16x16 PackBits tiles (the edges
    # cropped), a 16-bit grey BigTIFF in Deflate strips
    save("rgb.tif", Image.fromarray(rgb), "TIFF")
    save("p_packbits.tif", Image.fromarray(_photo(31, 39, 6)).quantize(37),
         "TIFF", compression="packbits")
    out["lab.tif"] = write_tiff(_photo(23, 29, 21), 8, 8)
    out["rgba_o6.tif"] = write_tiff(rgba, 8, extra_samples=(2,),
                                    compression=8, predictor=2,
                                    orientation=6, rows_per_strip=8)
    g = np.random.default_rng(22)
    out["cmyk_tiles.tif"] = write_tiff(
        g.integers(0, 256, (29, 41, 4)), 8, 5, order=">", planar=2,
        tile=(16, 16), compression=32773)
    out["grey16_big.tif"] = write_tiff(
        g.integers(0, 700, (27, 33)), 16, bigtiff=True, offset_type=16,
        compression=8, rows_per_strip=5)
    return out


def expected(files):
    """PIL's arrays of the decodable fixtures, as the JAX package gives
    them."""
    from insenticap_model_tpu.preprocessing import load_image_bytes
    return {name: load_image_bytes(data) for name, data in files.items()
            if FIXTURES[name] == "decode"}


def npz_bytes(arrays) -> bytes:
    """expected.npz's bytes: each array as its row differences, keyed by
    the file name; a name in ``SAME_PIXELS`` is left to its twin's."""
    for k, v in SAME_PIXELS.items():
        assert np.array_equal(arrays[k], arrays[v]), k
    buf = io.BytesIO()
    np.savez_compressed(buf, **{
        k: np.diff(v.astype(np.int16), axis=1, prepend=0).astype(np.uint8)
        for k, v in sorted(arrays.items()) if k not in SAME_PIXELS})
    return buf.getvalue()


if __name__ == "__main__":
    files = build()
    os.makedirs(DIR, exist_ok=True)
    files["expected.npz"] = npz_bytes(expected(files))
    for name, data in files.items():
        with open(os.path.join(DIR, name), "wb") as f:
            f.write(data)
    print({n: len(d) for n, d in files.items()})
