"""The port's image decoders (``preprocessing.load_image_bytes``: JPEG in
``csrc/imgdec.cc``, PNG in Python and the same library) bit for bit
against PIL 12.1 (the JAX package's ``load_image_bytes``), on the CPU.

JPEG: subsampling 4:4:4, 4:2:2 and 4:2:0 and grey at qualities 50, 75 and
95, ``optimize=True`` tables, restart markers by blocks and by rows, sizes
1x1 to 448x448, smooth and random pixels, baseline and progressive (PIL's
scan script: spectral selection and successive approximation); every cut
of a progressive file at a scan boundary (an incomplete progression,
which libjpeg-turbo decodes with block smoothing); and, from a small
writer here (PIL writes none of them), the sampling ratios 4:4:0 (h1v2),
4:1:1, 3x1 and 1x4 (libjpeg's integral replication), sizes whose
downsampled width is 1 or 2 (no fancy upsampling), one scan a component
and restart intervals, baseline and progressive by spectral selection.
PNG: L, LA, RGB, RGBA, P (and P at 1/2/4 bits, with tRNS), mode "1", and
PNGs built here with each of the five row filters and greyscale and
palette at 1, 2, 4 and 8 bits. What the decoders refuse raises
ValueError: lossless, hierarchical and arithmetic-coded JPEG, a
progression libjpeg refuses, CMYK, 16-bit PNG, interlaced PNG, truncated
and CRC-corrupt files. The committed fixtures under
``tests/data/torch_images`` are rebuilt with PIL and must equal what is
committed."""
import io
import os
import struct
import zlib

import numpy as np
import pytest

from insenticap_model_tpu import preprocessing as jpre
from insenticap_model_tpu_torch import preprocessing as tpre

import torch_images

Image = pytest.importorskip("PIL.Image")
ImageFile = pytest.importorskip("PIL.ImageFile")

SIZES = [(1, 1), (7, 9), (9, 7), (17, 33), (37, 53), (3, 4), (448, 448)]


def _smooth(h, w, seed):
    g = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255.0 / max(w - 1, 1), y * 255.0 / max(h - 1, 1),
                     (x + y) * 127.0 / max(h + w - 2, 1)], -1)
    return np.clip(base + g.normal(0, 8, base.shape), 0, 255).astype(
        np.uint8)


def _image(h, w, kind, seed=0):
    if kind == "smooth":
        return _smooth(h, w, seed)
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


def _same(data):
    want = jpre.load_image_bytes(data)
    got = tpre.load_image_bytes(data)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _jpeg(arr, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("subsampling", [0, 1, 2],
                         ids=["444", "422", "420"])
@pytest.mark.parametrize("kind", ["smooth", "random"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_jpeg_matches_pil(size, kind, subsampling):
    img = _image(*size, kind)
    for quality in (50, 75, 95):
        for extra in ({}, {"optimize": True}, {"restart_marker_blocks": 2},
                      {"restart_marker_rows": 1}):
            if extra.get("optimize") and kind == "random" and \
                    size == (448, 448):
                continue      # PIL cannot write these to a BytesIO
            _same(_jpeg(img, quality=quality, subsampling=subsampling,
                        **extra))


@pytest.fixture
def whole_image_buffer(monkeypatch):
    """PIL writes a progressive JPEG (as an optimised one) in one piece,
    through a buffer it sizes at a guess that a random 448x448 image
    outgrows: a larger one."""
    monkeypatch.setattr(ImageFile, "MAXBLOCK", 1 << 23)


@pytest.mark.parametrize("subsampling", [0, 1, 2],
                         ids=["444", "422", "420"])
@pytest.mark.parametrize("kind", ["smooth", "random"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_progressive_jpeg_matches_pil(size, kind, subsampling,
                                      whole_image_buffer):
    img = _image(*size, kind)
    for quality in (50, 75, 95):
        for extra in ({}, {"restart_marker_blocks": 2},
                      {"restart_marker_rows": 1}):
            _same(_jpeg(img, quality=quality, subsampling=subsampling,
                        progressive=True, **extra))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_grey_progressive_jpeg_matches_pil(size, whole_image_buffer):
    for kind in ("smooth", "random"):
        for quality in (50, 75, 95):
            for extra in ({}, {"restart_marker_blocks": 3}):
                data = _jpeg(_image(*size, kind)[:, :, 0], quality=quality,
                             progressive=True, **extra)
                assert tpre.load_image_bytes(data).ndim == 2
                _same(data)


def _scans(data):
    """(start, end) of each scan of a JPEG: its SOS marker, and the marker
    that follows its entropy-coded data."""
    out, pos = [], 2
    while data[pos + 1] != 0xD9:
        nxt = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] == 0xDA:
            while not (data[nxt] == 0xFF and data[nxt + 1] != 0
                       and not 0xD0 <= data[nxt + 1] <= 0xD7):
                nxt += 1
            out.append((pos, nxt))
        pos = nxt
    return out


# PIL's progressions (libjpeg's jpeg_simple_progression): 10 scans for
# YCbCr (DC at Al 1; Y 1-5 and 6-63 at Al 2, Cb and Cr 1-63 at Al 1; then
# the refinements), 6 for grey
_N_SCANS = {"rgb": 10, "grey": 6}


@pytest.mark.parametrize("what,n", [(w, n) for w, k in _N_SCANS.items()
                                    for n in range(k)],
                         ids=lambda x: str(x))
def test_progressive_scan_cuts_match_pil(what, n):
    """The file cut before scan ``n`` with EOI appended: after DC's first
    scan alone libjpeg-turbo smooths DC and estimates AC 1-9 from a 5x5 of
    DC values, after later ones it estimates the AC coefficients 1-5 that
    are still inexact; with no scan at all both refuse it. 37 rows at 4:2:0
    leave luma's last iMCU row one block row high."""
    for size in [(37, 53), (9, 7), (100, 36), (64, 48)]:
        for kind in ("smooth", "random"):
            img = _image(*size, kind)
            for sub in ((0, 1, 2) if what == "rgb" else (0,)):
                data = _jpeg(img if what == "rgb" else img[:, :, 0],
                             quality=75, subsampling=sub, progressive=True)
                scans = _scans(data)
                assert len(scans) == _N_SCANS[what]
                cut = data[:scans[n][0]] + b"\xff\xd9"
                if n == 0:
                    with pytest.raises(OSError):
                        jpre.load_image_bytes(cut)
                    _refused(cut, "truncated")
                else:
                    _same(cut)


def test_progressive_truncated_or_bad_refused():
    """A file cut inside a scan is refused as truncated (PIL: "image file
    is truncated"); a scan whose parameters libjpeg refuses (its
    JERR_BAD_PROGRESSION) is refused by name; a progression libjpeg only
    warns of (a scan repeated, a refinement missing) decodes as PIL's."""
    data = _jpeg(_image(40, 50, "smooth"), quality=75, progressive=True)
    scans = _scans(data)
    for start, end in scans:
        for cut in ((start + end) // 2, end - 1):
            with pytest.raises(OSError):
                jpre.load_image_bytes(data[:cut])
            _refused(data[:cut], "truncated")

    def edit(n, **kw):
        d = bytearray(data)
        q = scans[n][0] + 2 + int.from_bytes(d[scans[n][0] + 2:
                                               scans[n][0] + 4], "big") - 3
        for i, key in enumerate(("ss", "se", "ahal")):
            if key in kw:
                d[q + i] = kw[key]
        return bytes(d)

    for bad in (edit(1, ss=6, se=5), edit(1, se=64), edit(1, ahal=14),
                edit(5, ahal=0x20), edit(0, se=1), edit(0, ss=1, se=5)):
        with pytest.raises(OSError):
            jpre.load_image_bytes(bad)
        _refused(bad, "bad progressive scan")
    _same(data[:scans[2][0]] + data[scans[1][0]:])      # scan 2 twice
    _same(data[:scans[6][0]] + data[scans[6][1]:])      # no DC refinement


@pytest.mark.parametrize("marker,name", [
    (0xC3, "lossless"), (0xC5, "hierarchical"), (0xC6, "hierarchical"),
    (0xC9, "arithmetic coding"), (0xCA, "arithmetic coding"),
    (0xCE, "arithmetic coding")], ids=lambda x: f"{x:x}"
    if isinstance(x, int) else x.split()[0])
def test_other_frame_types_refused(marker, name):
    data = bytearray(_jpeg(_image(16, 24, "smooth"), quality=75))
    sof = data.index(b"\xff\xc0")
    data[sof + 1] = marker
    _refused(bytes(data), "unsupported: " + name)
    with pytest.raises(ValueError, match="unsupported: " + name):
        tpre._decode_jpeg(bytes(data[:sof + 20]))      # the header alone


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_grey_jpeg_matches_pil(size):
    for kind in ("smooth", "random"):
        for quality in (50, 75, 95):
            data = _jpeg(_image(*size, kind)[:, :, 0], quality=quality)
            assert tpre.load_image_bytes(data).ndim == 2
            _same(data)


# -- a small baseline JPEG writer: sampling ratios PIL cannot write ----------

_ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19,
           26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49,
           56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52,
           45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]


def _seg(marker, body):
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


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
               progressive=False):
    """A JFIF JPEG of random sparse quantised coefficients (any block
    content is a valid image): ``factors`` [(h, v)] a component, one
    interleaved scan or one scan a component, restart interval ``dri``
    MCUs, Huffman tables of one code length fitted to the symbols used.
    ``progressive``: SOF2 with spectral selection only (Al 0): the DC scan
    (interleaved unless ``separate``), then bands 1-5 and 6-63 of each
    component, all-zero bands coded as EOB runs."""
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    comps = []
    for ci, (h, v) in enumerate(factors):
        bh, bw = mcuy * v, mcux * h
        coef = np.zeros((bh, bw, 64), np.int64)
        coef[..., 0] = g.integers(-60, 60, (bh, bw))
        for k in range(1, 20):
            coef[..., k] = np.where(g.random((bh, bw)) < 0.3,
                                    g.integers(-30, 31, (bh, bw)), 0)
        comps.append({"id": ci + 1, "h": h, "v": v, "coef": coef,
                      "nbx": -(-(-(-width * h // hmax)) // 8),
                      "nby": -(-(-(-height * v // vmax)) // 8)})
    out = b"\xff\xd8" + _seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01"
                             b"\x00\x00")
    for t in range(2):
        out += _seg(0xDB, bytes([t]) + bytes(g.integers(1, 9, 64).tolist()))
    out += _seg(0xC2 if progressive else 0xC0,
                struct.pack(">BHHB", 8, height, width, len(comps))
                + b"".join(bytes([c["id"], (c["h"] << 4) | c["v"], ci % 2])
                           for ci, c in enumerate(comps)))
    if dri:
        out += _seg(0xDD, struct.pack(">H", dri))
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
        out += _seg(0xC4, body)
        out += _seg(0xDA, bytes([len(group)]) + b"".join(
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


RATIOS = [
    [(1, 2), (1, 1), (1, 1)], [(4, 1), (1, 1), (1, 1)],
    [(2, 1), (1, 1), (1, 1)], [(2, 2), (1, 1), (1, 1)],
    [(1, 1), (1, 1), (1, 1)], [(2, 2), (1, 2), (2, 1)],
    [(1, 4), (1, 1), (1, 1)], [(3, 1), (1, 1), (1, 1)], [(1, 1)], [(2, 2)]]


def _ratios_match_pil(factors, progressive):
    g = np.random.default_rng(len(factors) * 10 + factors[0][0])
    for size in [(1, 1), (7, 9), (9, 7), (2, 5), (5, 2), (3, 4), (40, 44)]:
        for separate in (False, True):
            for dri in (0, 1, 3):
                _same(write_jpeg(size[1], size[0], factors, g,
                                 separate=separate, dri=dri,
                                 progressive=progressive))


@pytest.mark.parametrize("factors", RATIOS,
                         ids=lambda f: "_".join(f"{h}{v}" for h, v in f))
def test_sampling_ratios_match_pil(factors):
    _ratios_match_pil(factors, False)


@pytest.mark.parametrize("factors", RATIOS,
                         ids=lambda f: "_".join(f"{h}{v}" for h, v in f))
def test_progressive_sampling_ratios_match_pil(factors):
    _ratios_match_pil(factors, True)


def test_mcu_over_libjpeg_limit_refused():
    """11 blocks an MCU: libjpeg (and PIL) refuse it, so does the port."""
    data = write_jpeg(16, 16, [(4, 2), (1, 1), (2, 1)],
                      np.random.default_rng(0))
    with pytest.raises(OSError):
        jpre.load_image_bytes(data)
    with pytest.raises(ValueError, match="sampling factors too large"):
        tpre.load_image_bytes(data)


# -- PNG --------------------------------------------------------------------

def _png_pil(im, **kw):
    buf = io.BytesIO()
    im.save(buf, "PNG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("size", [(1, 1), (7, 9), (17, 33), (64, 64)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_png_matches_pil(size):
    rgb = _image(*size, "random", seed=1)
    for mode in ("L", "LA", "RGB", "RGBA"):
        _same(_png_pil(Image.fromarray(rgb).convert(mode)))
    _same(_png_pil(Image.fromarray(rgb[:, :, 0] > 127)))          # "1"
    _same(_png_pil(Image.fromarray(rgb), transparency=(1, 2, 3)))
    _same(_png_pil(Image.fromarray(rgb[:, :, 0]), transparency=5))
    for colors in (2, 4, 7, 16, 100, 256):
        im = Image.fromarray(rgb).quantize(colors)
        for bits in (None, 1, 2, 4):
            if bits and (1 << bits) < colors:
                continue
            _same(_png_pil(im, **({"bits": bits} if bits else {})))
        _same(_png_pil(im, transparency=0))


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered(rows, bpp, ft):
    """The rows under filter ``ft`` (-1: each row its own, in turn)."""
    out, prev = [], np.zeros_like(rows[0])
    for y, row in enumerate(rows):
        f = ft if ft >= 0 else y % 5
        r, p = row.astype(int), prev.astype(int)
        enc = np.zeros_like(r)
        for i in range(len(r)):
            a = r[i - bpp] if i >= bpp else 0
            c = p[i - bpp] if i >= bpp else 0
            pred = [0, a, p[i], (a + p[i]) // 2, _paeth(a, p[i], c)][f]
            enc[i] = (r[i] - pred) % 256
        out.append(bytes([f]) + bytes(enc.astype(np.uint8)))
        prev = row
    return b"".join(out)


def make_png(w, h, depth, ctype, rows, bpp, ft, plte=None, interlace=0):
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if plte is not None:
        data += _chunk(b"PLTE", plte)
    return (data + _chunk(b"IDAT", zlib.compress(_filtered(rows, bpp, ft)))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("ft", [0, 1, 2, 3, 4, -1],
                         ids=["none", "sub", "up", "avg", "paeth", "mixed"])
def test_png_filters_and_depths_match_pil(ft):
    g = np.random.default_rng(ft + 10)
    h, w = 9, 13
    rgb = g.integers(0, 256, (h, w, 3), dtype=np.uint8)
    _same(make_png(w, h, 8, 2, list(rgb.reshape(h, -1)), 3, ft))
    rgba = g.integers(0, 256, (h, w, 4), dtype=np.uint8)
    _same(make_png(w, h, 8, 6, list(rgba.reshape(h, -1)), 4, ft))
    la = g.integers(0, 256, (h, w, 2), dtype=np.uint8)
    _same(make_png(w, h, 8, 4, list(la.reshape(h, -1)), 2, ft))
    for depth in (1, 2, 4, 8):
        vals = g.integers(0, 1 << depth, (h, w), dtype=np.uint8)
        per = 8 // depth
        packed = np.zeros((h, (w * depth + 7) // 8), np.uint8)
        for x in range(w):
            packed[:, x // per] |= (vals[:, x] << (8 - depth - (x % per)
                                                   * depth)).astype(np.uint8)
        _same(make_png(w, h, depth, 0, list(packed), 1, ft))     # grey
        plte = g.integers(0, 256, 3 * (1 << depth), dtype=np.uint8)
        _same(make_png(w, h, depth, 3, list(packed), 1, ft, plte.tobytes()))
    # a palette shorter than the indices reach
    vals = g.integers(0, 16, (5, 6), dtype=np.uint8)
    _same(make_png(6, 5, 8, 3, list(vals), 1, ft,
                   g.integers(0, 256, 15, dtype=np.uint8).tobytes()))


# -- refusals -----------------------------------------------------------------

def _refused(data, match):
    with pytest.raises(ValueError, match=match):
        tpre.load_image_bytes(data)


def test_refusals():
    img = _image(40, 50, "smooth")
    cmyk = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(cmyk, "JPEG")
    _refused(cmyk.getvalue(), "CMYK")
    _refused(_png_pil(Image.fromarray(img[:, :, 0].astype(np.uint16) * 200)),
             "16-bit")
    rows = list(img.reshape(40, -1))
    _refused(make_png(50, 40, 8, 2, rows, 3, 0, interlace=1), "interlaced")
    data = _jpeg(img, quality=75)
    for cut in (len(data) // 2, len(data) - 2, 300, 30):
        _refused(data[:cut], "truncated")
    png = _png_pil(Image.fromarray(img))
    _refused(png[:len(png) // 2], "truncated")
    bad = bytearray(png)
    bad[40] ^= 1
    _refused(bytes(bad), "CRC")
    _refused(b"nonsense", "not a JPEG or PNG")
    # an Adobe marker with transform 0 and no JFIF marker (which would
    # win): libjpeg takes the samples as RGB
    adobe = _seg(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x00")
    assert data[2:4] == b"\xff\xe0"
    no_jfif = data[4 + int.from_bytes(data[4:6], "big"):]
    rgb = data[:2] + adobe + no_jfif
    assert jpre.load_image_bytes(rgb).shape == (40, 50, 3)
    _refused(rgb, "RGB colour transform")
    _same(data[:2] + no_jfif)                   # ids 1, 2, 3: YCbCr


def test_decompression_bombs_refused():
    """Headers that declare more pixels than PIL allows are refused before
    anything is allocated; a PNG whose zlib stream inflates past the image
    is read only as far as the image."""
    data = bytearray(_jpeg(_image(16, 16, "smooth")))
    sof = data.index(b"\xff\xc0")
    data[sof + 5:sof + 9] = struct.pack(">HH", 60000, 60000)
    _refused(bytes(data), "exceeds the limit")
    rows = [np.zeros(3 * 50000, np.uint8)] * 2
    _refused(make_png(50000, 50000, 8, 2, rows, 3, 0), "exceeds the limit")
    img = _image(5, 6, "random")
    raw = b"".join(b"\x00" + r.tobytes() for r in img.reshape(5, -1))
    body = zlib.compress(raw + bytes(10_000_000))     # 10 MB past the image
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", 6, 5, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", body) + _chunk(b"IEND", b""))
    np.testing.assert_array_equal(tpre.load_image_bytes(data), img)
    _same(data)


@pytest.mark.parametrize("seed", range(4))
def test_mutated_files_raise_value_error_or_decode(seed):
    """Corrupted files (bytes changed, cut, inserted or removed) from a
    client: each decodes or raises ValueError, never anything else (the
    daemon answers the latter with 500, or the library would crash it)."""
    g = np.random.default_rng(seed)
    seeds = [_jpeg(_image(37, 53, "random", seed=s_), subsampling=s_,
                   **kw) for s_ in range(3)
             for kw in ({}, {"restart_marker_blocks": 1})]
    seeds.append(_jpeg(_image(20, 21, "random")[:, :, 0]))
    seeds += [_jpeg(_image(37, 53, "random", seed=s_), subsampling=s_,
                    progressive=True, **kw) for s_ in range(3)
              for kw in ({}, {"restart_marker_blocks": 1})]
    seeds.append(_jpeg(_image(20, 21, "random")[:, :, 0], progressive=True))
    seeds.append(write_jpeg(21, 19, [(2, 2), (1, 1), (1, 1)],
                            np.random.default_rng(100), dri=2,
                            progressive=True))
    for mode in ("RGB", "P", "L", "RGBA"):
        seeds.append(_png_pil(Image.fromarray(
            _image(19, 23, "random")).convert(mode)))
    for i in range(600):
        d = bytearray(seeds[i % len(seeds)])
        kind = i % 4
        if kind == 0:
            for _ in range(int(g.integers(1, 8))):
                d[int(g.integers(0, len(d)))] = int(g.integers(0, 256))
        elif kind == 1:
            d = d[:int(g.integers(1, len(d)))]
        elif kind == 2:
            p = int(g.integers(0, len(d)))
            d = d[:p] + bytes(g.integers(0, 256, int(g.integers(1, 50)),
                                         dtype=np.uint8)) + d[p:]
        else:
            p = int(g.integers(2, len(d)))
            d = d[:p] + d[p + int(g.integers(1, 40)):]
        try:
            out = tpre.load_image_bytes(bytes(d))
        except ValueError:
            continue
        assert out.dtype == np.uint8 and out.ndim in (2, 3)


def test_load_image_reads_files(tmp_path):
    img = _image(17, 33, "smooth")
    Image.fromarray(img).save(tmp_path / "x.jpg")
    Image.fromarray(img).save(tmp_path / "x.png")
    for name in ("x.jpg", "x.png"):
        np.testing.assert_array_equal(tpre.load_image(str(tmp_path / name)),
                                      jpre.load_image(str(tmp_path / name)))
    np.testing.assert_array_equal(tpre.load_image(str(tmp_path / "x.png")),
                                  img)


def test_host_library_name_keys_the_host(monkeypatch):
    """The decoders' library is named by its host as well as its source, so
    a build made on another machine, C library or compiler is rebuilt,
    never loaded."""
    from insenticap_model_tpu_torch.ops import _build
    here = _build._host_target("imgdec")
    assert here != _build._target("imgdec", ".cc", _build.CXX_FLAGS)
    assert _build._host_target("imgdec") == here
    for key in (_build._host_key.replace(b"x86_64", b"aarch64", 1) + b"-",
                _build._host_key + b" another compiler"):
        monkeypatch.setattr(_build, "_host_key", key)
        assert _build._host_target("imgdec") != here


def test_loaded_library_touches_no_file(monkeypatch):
    """Every launch asks ``_build`` for its library: once loaded, the
    library is returned without reading or hashing its source again (that
    cost some 0.4 ms of the host's time a kernel launch)."""
    from insenticap_model_tpu_torch.ops import _build
    lib = tpre._lib()

    def refuse(*a, **k):
        raise AssertionError("source read after the library was loaded")
    monkeypatch.setattr(_build, "_target", refuse)
    monkeypatch.setattr(_build, "_host_target", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    assert tpre._lib() is lib
    # a CUDA library's entry: the same path through load()
    monkeypatch.setitem(_build._libs, "loaded_cuda_lib", lib)
    assert _build.load("loaded_cuda_lib", {}) is lib


# -- the committed fixtures ---------------------------------------------------

def test_fixtures_match_pil():
    """Rebuilt with PIL, the fixtures equal what is committed: the files
    byte for byte, the expected arrays value for value; and the port
    decodes each as expected.npz says, or refuses it."""
    files = torch_images.build()
    assert set(files) == set(torch_images.FIXTURES)
    committed = sorted(os.listdir(torch_images.DIR))
    assert committed == sorted(list(files) + ["expected.npz"])
    for name, data in files.items():
        with open(os.path.join(torch_images.DIR, name), "rb") as f:
            assert f.read() == data, name
    sizes = sum(os.path.getsize(os.path.join(torch_images.DIR, n))
                for n in committed)
    assert len(committed) <= 14 and sizes < 200_000
    with np.load(os.path.join(torch_images.DIR, "expected.npz")) as npz:
        want = torch_images.decode_expected(npz)
    pil = torch_images.expected(files)
    assert set(want) == set(pil)
    for name, arr in pil.items():
        np.testing.assert_array_equal(want[name], arr)
        np.testing.assert_array_equal(tpre.load_image_bytes(files[name]),
                                      arr)
    for name, what in torch_images.FIXTURES.items():
        if what == "refuse":
            _refused(files[name], "unsupported")
