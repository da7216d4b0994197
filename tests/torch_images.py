"""The committed image fixtures of the port's decoders
(``tests/data/torch_images/``) and the small writers of the files PIL
cannot write.

The fixtures: JPEGs, PNGs, GIFs, BMPs and lossless WebPs written by PIL,
or by the writers here (``write_jpeg``: YCCK; ``make_png``:
Adam7-interlaced and 16-bit RGB; ``write_gif``, ``write_bmp``: what PIL
does not write; ``vp8l``: an animation whose first frame lies at an
offset), and ``expected.npz`` holding PIL's decoded arrays (the JAX package's
``load_image_bytes``), for the card's machine, which has no PIL. The
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
ANIM/ANMF containers."""
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
