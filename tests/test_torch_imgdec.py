"""The port's image decoders (``preprocessing.load_image_bytes``: JPEG in
``csrc/imgdec.cc``, PNG in Python and the same library) bit for bit
against PIL 12.1 (the JAX package's ``load_image_bytes``), on the CPU.

JPEG: subsampling 4:4:4, 4:2:2 and 4:2:0 and grey at qualities 50, 75 and
95, ``optimize=True`` tables, restart markers by blocks and by rows, sizes
1x1 to 448x448, smooth and random pixels, baseline and progressive (PIL's
scan script: spectral selection and successive approximation); every cut
of a progressive file at a scan boundary (an incomplete progression,
which libjpeg-turbo decodes with block smoothing); CMYK from PIL (4:4:4
and its 4:2:0, baseline and progressive, restart markers, every scan cut)
and RGB kept by PIL (an Adobe marker with transform 0); and, from the
writer in ``torch_images.py`` (PIL writes none of them), the sampling
ratios 4:4:0 (h1v2), 4:1:1, 3x1 and 1x4 (libjpeg's integral replication),
sizes whose downsampled width is 1 or 2 (no fancy upsampling), one scan a
component and restart intervals, baseline and progressive by spectral
selection, and the colour spaces libjpeg reads from the markers: YCCK,
CMYK without an Adobe marker, RGB by Adobe transform or by component ids.
PNG: L, LA, RGB, RGBA, P (and P at 1/2/4 bits, with tRNS), mode "1",
16-bit grey from PIL, and PNGs from the writer with each of the five row
filters, every colour type at every depth (1, 2, 4, 8 and 16 bits), plain
and Adam7-interlaced at sizes that leave passes empty or partial, 16-bit
with and without tRNS. What the decoders refuse raises ValueError naming
it: lossless, hierarchical and arithmetic-coded JPEG, 12-bit and
2-component JPEG, a progression libjpeg refuses, a Huffman code no table
holds, truncated and CRC-corrupt files; each such case also records
whether PIL decodes it. What libjpeg only warns of decodes as PIL decodes
it: no DHT, a sequential scan's Ss/Se, a restart marker resynced, an AC
run past 63, coefficients past 16 bits (libjpeg-turbo's SIMD IDCT), a
marker inside entropy-coded data. Corrupted files of every format (GIF and BMP
among them: ``test_torch_imgdec_gifbmp.py`` holds their matrix) decode or
raise ValueError, and headers past PIL's pixel limit are refused. The
committed fixtures under ``tests/data/torch_images`` are rebuilt and must
equal what is committed."""
import io
import os
import struct
import zlib

import numpy as np
import pytest

from insenticap_model_tpu import preprocessing as jpre
from insenticap_model_tpu_torch import preprocessing as tpre

import torch_images
from torch_images import (JFIF, adobe, chunk, filtered, image_data,
                          make_png, png_file, seg, write_bmp, write_gif,
                          write_jpeg, write_lossless_jpeg)

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


def _pil(im, fmt, **kw):
    """PIL's file of an image, in ``fmt``."""
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _jpeg(img, **kw):
    """PIL's JPEG of an array or an image."""
    buf = io.BytesIO()
    (img if isinstance(img, Image.Image) else Image.fromarray(img)).save(
        buf, "JPEG", **kw)
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
# the refinements), 6 for grey, 18 for CMYK (its all-purpose script: DC
# of the four interleaved, then 1-5, 6-63 and 1-63 of each, DC's
# refinement and 1-63 of each again)
_N_SCANS = {"rgb": 10, "grey": 6, "cmyk": 18}


def _cut_source(what, img, sub):
    """The progressive file of ``what`` whose scans are cut."""
    if what == "grey":
        return _jpeg(img[:, :, 0], quality=75, progressive=True)
    im = Image.fromarray(img)
    return _jpeg(im.convert("CMYK") if what == "cmyk" else im, quality=75,
                 subsampling=sub, progressive=True)


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
            for sub in {"rgb": (0, 1, 2), "cmyk": (0, 2)}.get(what, (0,)):
                data = _cut_source(what, img, sub)
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


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_cmyk_jpeg_matches_pil(size, whole_image_buffer):
    """PIL's CMYK JPEG (an Adobe marker, transform 0; its 4:2:0 samples C
    at 2x2 and M, Y, K at 1x1): baseline and progressive, restart markers
    by blocks and by rows; PIL reads it inverted ("CMYK;I") and converts
    with its cmyk2rgb."""
    for kind in ("smooth", "random"):
        im = Image.fromarray(_image(*size, kind)).convert("CMYK")
        for sub in (0, 2):
            for quality in (50, 75, 95):
                for prog in (False, True):
                    _same(_jpeg(im, quality=quality, subsampling=sub,
                                progressive=prog))
            for extra in ({"restart_marker_blocks": 2},
                          {"restart_marker_rows": 1}):
                for prog in (False, True):
                    _same(_jpeg(im, quality=75, subsampling=sub,
                                progressive=prog, **extra))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_rgb_jpeg_matches_pil(size, whole_image_buffer):
    """PIL's ``keep_rgb`` JPEG: ids 'R' 'G' 'B', an Adobe marker with
    transform 0, no JFIF: libjpeg leaves the samples as they are."""
    for kind in ("smooth", "random"):
        for prog in (False, True):
            _same(_jpeg(_image(*size, kind), quality=75, subsampling=0,
                        keep_rgb=True, progressive=prog))


# colour space -> (markers after SOI, component ids, sampling factors):
# what libjpeg's default_decompress_parms reads from them
COLOURS = {
    "ycck": (adobe(2), None, [(2, 2), (1, 1), (1, 1), (2, 2)]),
    "ycck_transform1": (adobe(1), None, [(1, 1)] * 4),   # not 0: YCCK
    "cmyk_no_adobe": (b"", None, [(1, 2), (1, 1), (1, 1), (1, 1)]),
    "cmyk_adobe0": (adobe(0), None, [(2, 1), (1, 1), (2, 1), (1, 1)]),
    "cmyk_with_jfif": (seg(0xE0, JFIF), None, [(1, 1)] * 4),
    "rgb_adobe0": (adobe(0), None, [(2, 2), (1, 1), (1, 1)]),
    "rgb_ids": (b"", [82, 71, 66], [(1, 1), (1, 1), (2, 1)]),
    "rgb_short_jfif": (seg(0xE0, JFIF[:13]) + adobe(0), None,
                       [(1, 1)] * 3),           # a JFIF under 14 bytes
    "ycc_jfif_adobe0": (seg(0xE0, JFIF) + adobe(0), None, [(1, 1)] * 3),
    "ycc_adobe1": (adobe(1), [82, 71, 66], [(2, 2), (1, 1), (1, 1)]),
    "ycc_adobe2": (adobe(2), None, [(1, 1)] * 3),
    "ycc_no_markers": (b"", [5, 6, 7], [(2, 1), (1, 1), (1, 1)]),
}


@pytest.mark.parametrize("colour", list(COLOURS))
def test_colour_spaces_match_pil(colour):
    """The writer's files in each colour space, 3 and 4 components: one
    interleaved scan (four components in it, up to libjpeg's 10 blocks an
    MCU) or one a component, restart intervals, baseline and progressive
    (the DC scan interleaving all components)."""
    markers, ids, factors = COLOURS[colour]
    g = np.random.default_rng(len(colour))
    for size in [(1, 1), (7, 9), (9, 7), (3, 4), (23, 37)]:
        for separate in (False, True):
            for dri in (0, 2):
                for prog in (False, True):
                    _same(write_jpeg(size[1], size[0], factors, g,
                                     separate=separate, dri=dri,
                                     progressive=prog, markers=markers,
                                     ids=ids))


# -- the writer's sampling ratios: what PIL cannot write ----------------

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


@pytest.mark.parametrize("ft", [0, 1, 2, 3, 4, -1],
                         ids=["none", "sub", "up", "avg", "paeth", "mixed"])
def test_png_filters_and_depths_match_pil(ft):
    g = np.random.default_rng(ft + 10)
    h, w = 9, 13
    for ctype, channels, depths in _PNG_DEPTHS:
        for depth in depths:
            vals = g.integers(0, 1 << depth, (h, w, channels))
            plte = (g.integers(0, 256, 3 * (1 << depth), dtype=np.uint8)
                    .tobytes() if ctype == 3 else None)
            _same(make_png(vals, depth, ctype, ft, plte=plte))
    # a palette shorter than the indices reach
    vals = g.integers(0, 16, (5, 6), dtype=np.uint8)
    _same(make_png(vals, 8, 3, ft,
                   plte=g.integers(0, 256, 15, dtype=np.uint8).tobytes()))


# (colour type, channels, bit depths)
_PNG_DEPTHS = [(0, 1, (1, 2, 4, 8, 16)), (2, 3, (8, 16)),
               (3, 1, (1, 2, 4, 8)), (4, 2, (8, 16)), (6, 4, (8, 16))]


@pytest.mark.parametrize("size", [(1, 1), (1, 7), (7, 1), (4, 4), (5, 5),
                                  (8, 8), (9, 13), (33, 47)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_interlaced_png_matches_pil(size):
    """Adam7 at every colour type and depth, each row filter in every pass
    and each in turn: images narrower or shorter than 5 leave passes
    empty (no bytes at all), odd sizes leave them partial."""
    h, w = size
    g = np.random.default_rng(h * 100 + w)
    for ctype, channels, depths in _PNG_DEPTHS:
        for depth in depths:
            vals = g.integers(0, 1 << depth, (h, w, channels))
            plte = (g.integers(0, 256, 3 * (1 << depth), dtype=np.uint8)
                    .tobytes() if ctype == 3 else None)
            for ft in (0, 1, 2, 3, 4, -1):
                _same(make_png(vals, depth, ctype, ft, interlace=1,
                               plte=plte))
    # PIL takes any nonzero interlace method as Adam7
    _same(make_png(g.integers(0, 256, (h, w, 3)), 8, 2, interlace=2))


@pytest.mark.parametrize("ctype", [0, 2, 4, 6])
def test_png16_matches_pil(ctype):
    """16-bit samples: grey is PIL's "I;16" clamped at 255 into RGB (values
    below and above 255), grey+alpha "RGBA" from "LA;16B" (the grey's high
    byte), RGB and RGBA the high byte; a tRNS chunk changes no mode;
    plain and Adam7."""
    g = np.random.default_rng(ctype)
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    for h, w in ((1, 1), (6, 5), (17, 23)):
        vals = g.integers(0, 1 << 16, (h, w, channels))
        vals[::2] = g.integers(0, 300, vals[::2].shape)   # below 256 too
        trns = (struct.pack(">H", 100) if ctype == 0 else
                struct.pack(">HHH", *vals[0, 0]) if ctype == 2 else None)
        for interlace in (0, 1):
            _same(make_png(vals, 16, ctype, interlace=interlace))
            if trns is not None:
                data = make_png(vals, 16, ctype, interlace=interlace,
                                chunks=chunk(b"tRNS", trns))
                assert "transparency" in Image.open(io.BytesIO(data)).info
                _same(data)
    if ctype == 0:      # PIL's own 16-bit grey PNG
        _same(_png_pil(Image.fromarray(
            g.integers(0, 1000, (9, 7)).astype(np.uint16))))


# -- refusals -----------------------------------------------------------------

def _refused(data, match):
    with pytest.raises(ValueError, match=match):
        tpre.load_image_bytes(data)


def test_refusals():
    img = _image(40, 50, "smooth")
    data = _jpeg(img, quality=75)
    for cut in (len(data) // 2, len(data) - 2, 300, 30):
        _refused(data[:cut], "truncated")
    png = _png_pil(Image.fromarray(img))
    _refused(png[:len(png) // 2], "truncated")
    bad = bytearray(png)
    bad[40] ^= 1
    _refused(bytes(bad), "CRC")
    _refused(b"nonsense", "not an image the decoders read")
    # an Adobe marker with transform 0 and no JFIF marker (which would
    # win): libjpeg takes the samples as RGB, and so does the port
    assert data[2:4] == b"\xff\xe0"
    no_jfif = data[4 + int.from_bytes(data[4:6], "big"):]
    rgb = data[:2] + adobe(0) + no_jfif
    assert jpre.load_image_bytes(rgb).shape == (40, 50, 3)
    _same(rgb)
    _same(data[:2] + no_jfif)                   # ids 1, 2, 3: YCbCr


def _bad_huffman_code(data):
    """A JPEG whose entropy data starts with 16 one bits: a code longer
    than any that PIL's tables hold."""
    sos = data.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    return data[:start] + b"\xff\x00" * 4 + data[start:]


def _still_refused(kind):
    """(file, what the port's refusal names, whether PIL 12.1 decodes it)
    for each JPEG the port still refuses."""
    base = _jpeg(_image(16, 24, "random"), quality=75)
    sof = base.index(b"\xff\xc0")
    if kind == "lossless":
        return (write_lossless_jpeg(_image(9, 13, "random")[:, :, 0]),
                "unsupported: lossless", True)
    if kind == "hierarchical":
        return (base[:sof + 1] + b"\xc5" + base[sof + 2:],
                "unsupported: hierarchical", False)
    if kind == "12-bit":
        return (base[:sof + 4] + b"\x0c" + base[sof + 5:],
                "unsupported: 12-bit", False)
    if kind == "2 components":
        return (write_jpeg(16, 16, [(1, 1), (1, 1)],
                           np.random.default_rng(0)),
                "unsupported: 2 components", False)
    if kind == "truncated":
        return base[:len(base) // 2], "truncated", False
    return _bad_huffman_code(base), "bad Huffman code", True


@pytest.mark.parametrize("kind", ["lossless", "hierarchical", "12-bit",
                                  "2 components", "truncated",
                                  "bad Huffman code"])
def test_still_refused(kind):
    """What the port still refuses, by name, and what PIL does with the
    same file (ROADMAP records both): PIL decodes a lossless JPEG and one
    with a Huffman code no table holds (libjpeg warns and goes on with
    zeros), and refuses the others."""
    data, name, pil_decodes = _still_refused(kind)
    _refused(data, name)
    if pil_decodes:
        assert jpre.load_image_bytes(data).ndim in (2, 3)
    else:
        with pytest.raises(OSError):
            jpre.load_image_bytes(data)



def _lenient(kind):
    """A JPEG that libjpeg decodes, warning at most, where a stricter
    reader would refuse it."""
    base = _jpeg(_image(24, 40, "smooth"), quality=80,
                 restart_marker_blocks=1)
    segs = torch_images.jpeg_segments(base)
    if kind == "no DHT":               # libjpeg-turbo's standard tables
        return b"".join(b for m, b in segs if m != 0xC4)
    if kind == "sequential Ss Se":     # only warned of
        sos = bytearray(segs[-2][1])
        sos[-3:] = b"\x07\x05\x11"
        return b"".join(b if m != 0xDA else bytes(sos) for m, b in segs)
    if kind in ("marker in the data", "marker in a progressive scan"):
        # an EOI inside the first scan's data: zero bits for the MCU where
        # the bits end, no later MCU of the scan (128s), then the end
        data = _jpeg(_image(24, 40, "smooth"), quality=80,
                     progressive=kind != "marker in the data")
        sos = data.index(b"\xff\xda")
        at = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big") + 10
        return data[:at] + b"\xff\xd9" + data[at:]
    if kind == "restart resync":       # RST4 where RST0 is due: dropped
        at = base.index(b"\xff\xd0")
        return base[:at + 1] + b"\xd4" + base[at + 2:]
    if kind == "run past 63":
        # an 8x8 grey block: DC category 0 (code 0), then four times AC
        # (15, 1) (code 00) and a one bit; the last lands on coefficient
        # 64, which libjpeg writes to 63
        return (b"\xff\xd8" + seg(0xDB, bytes(65)[:1] + bytes([1] * 64))
                + seg(0xC0, struct.pack(">BHHB", 8, 8, 8, 1) + b"\x01\x11\x00")
                + seg(0xC4, b"\x00\x01" + bytes(15) + b"\x00")
                + seg(0xC4, b"\x10\x00\x02" + bytes(14) + b"\xf1\x00")
                + seg(0xDA, b"\x01\x01\x00\x00\x3f\x00")
                + b"\x12\x4f\xff\xd9")
    # quantisers raised past 16 bits of dequantised coefficients:
    # libjpeg-turbo's x86 SIMD IDCT (16-bit wraps, saturation)
    j = bytearray(write_jpeg(32, 24, [(2, 2), (1, 1), (1, 1)],
                             np.random.default_rng(11)))
    g = np.random.default_rng(12)
    for at in [i for i in range(len(j) - 1) if j[i:i + 2] == b"\xff\xdb"]:
        j[at + 5:at + 69] = bytes(g.integers(100, 256, 64).tolist())
    return bytes(j)


@pytest.mark.parametrize("kind", ["no DHT", "sequential Ss Se",
                                  "restart resync", "run past 63",
                                  "SIMD IDCT", "marker in the data",
                                  "marker in a progressive scan"])
def test_libjpeg_leniencies(kind):
    """What libjpeg reads on where a stricter reader would refuse, as
    PIL's own JPEG plugin reads it (the rules JPEG in TIFF shares): no
    DHT (libjpeg-turbo's standard tables), a sequential scan's Ss, Se, Ah
    and Al, a restart marker of a far-off number (resynced by dropping
    it), an AC run past coefficient 63, coefficients whose dequantised
    values leave 16 bits (libjpeg-turbo's SIMD IDCT), and a marker inside
    a scan's entropy-coded data (libjpeg's insufficient data; a
    progressive file's smoothing past the last good row)."""
    data = _lenient(kind)
    assert jpre.load_image_bytes(data).ndim in (2, 3)
    _same(data)


def test_decompression_bombs_refused():
    """Headers that declare more pixels than PIL allows are refused before
    anything is allocated, interlaced or not (a JPEG frame, a PNG header,
    a GIF screen and a GIF frame that grows it, a BMP header, bottom-up
    and top-down), as PIL refuses each; a PNG whose zlib stream inflates
    past the image (or past the sum of its Adam7 passes) is read only as
    far as the image."""
    data = bytearray(_jpeg(_image(16, 16, "smooth")))
    sof = data.index(b"\xff\xc0")
    data[sof + 5:sof + 9] = struct.pack(">HH", 60000, 60000)
    _refused(bytes(data), "exceeds the limit")
    idx = np.zeros((4, 4), np.int64)
    bombs = [write_gif(idx, screen=(60000, 60000), table=bytes(12),
                     min_size=2),
             write_gif(idx, screen=(4, 4), pos=(59990, 59990),
                       table=bytes(12), min_size=2)]
    for top_down in (False, True):
        bmp = bytearray(write_bmp(_image(2, 3, "random"), 24,
                                  top_down=top_down))
        bmp[18:26] = struct.pack("<ii", 50000, -50000 if top_down else 50000)
        bombs.append(bytes(bmp))
    for data in bombs:
        _refused(data, "exceeds the limit")
        with pytest.raises(Image.DecompressionBombError):
            jpre.load_image_bytes(data)
    raw = filtered(np.zeros((2, 3 * 50000), np.uint8), 3, 0)
    for interlace in (0, 1):
        _refused(png_file(50000, 50000, 8, 2, raw, interlace=interlace),
                 "exceeds the limit")
    img = _image(5, 6, "random")
    for interlace in (0, 1):
        data = png_file(6, 5, 8, 2, image_data(img, 8, 0, interlace)
                        + bytes(10_000_000),        # 10 MB past the image
                        interlace=interlace)
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
    cmyk = Image.fromarray(_image(37, 53, "random", seed=3)).convert("CMYK")
    seeds += [_jpeg(cmyk, subsampling=2, progressive=p_,
                    restart_marker_blocks=1) for p_ in (False, True)]
    seeds.append(write_jpeg(21, 19, [(2, 2), (1, 1), (1, 1), (2, 2)],
                            np.random.default_rng(101), dri=2,
                            progressive=True, markers=adobe(2)))
    for mode in ("RGB", "P", "L", "RGBA"):
        seeds.append(_png_pil(Image.fromarray(
            _image(19, 23, "random")).convert(mode)))
    g16 = np.random.default_rng(102)
    seeds.append(make_png(_image(19, 23, "random"), 8, 2, interlace=1))
    seeds.append(make_png(g16.integers(0, 16, (19, 23)), 4, 3, interlace=1,
                          plte=bytes(range(48))))
    seeds.append(make_png(g16.integers(0, 1 << 16, (19, 23, 4)), 16, 6,
                          interlace=1))
    # GIF and BMP: PIL's palette GIF (interlaced) and grey ramp, the
    # writer's offset frame with a transparency index; PIL's 8-bit, 1-bit
    # and 24-bit BMPs, the writer's RLE8, RLE4 and 5-6-5 bitfields
    photo = Image.fromarray(_image(19, 23, "random"))
    seeds += [_pil(photo.quantize(40), "GIF"),
              _pil(photo.convert("1"), "GIF"),
              write_gif(g16.integers(0, 6, (9, 11)), screen=(15, 13),
                        pos=(3, 2), table=bytes(range(24)), transparency=5,
                        min_size=3),
              _pil(photo.quantize(40), "BMP"), _pil(photo.convert("1"), "BMP"),
              _pil(photo, "BMP"),
              write_bmp(np.zeros((4, 6)), 8, compression=1,
                        palette=g16.integers(0, 256, (8, 3)),
                        rle=bytes([4, 7, 0, 0, 0, 5, 1, 2, 3, 4, 5, 0, 0, 2,
                                   9, 9, 2, 1, 6, 3, 0, 0, 3, 6, 0, 1])),
              write_bmp(np.zeros((3, 5)), 4, compression=2,
                        palette=g16.integers(0, 256, (16, 3)),
                        rle=bytes([5, 0x12, 0, 0, 0, 4, 0x34, 0x56, 0, 0,
                                   3, 0x78, 0, 0, 0, 1])),
              write_bmp(g16.integers(0, 1 << 16, (7, 9)), 16, header=124,
                        compression=3, masks=(0xF800, 0x7E0, 0x1F))]
    for i in range(24 * len(seeds)):    # each seed 6 times each kind
        d = bytearray(seeds[i % len(seeds)])
        kind = i // len(seeds) % 4
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
    """Rebuilt, the fixtures equal what is committed: the files byte for
    byte, the expected arrays value for value; and the port decodes each as
    expected.npz says, or refuses it as PIL does."""
    files = torch_images.build()
    assert set(files) == set(torch_images.FIXTURES)
    committed = sorted(os.listdir(torch_images.DIR))
    assert committed == sorted(list(files) + ["expected.npz"])
    for name, data in files.items():
        with open(os.path.join(torch_images.DIR, name), "rb") as f:
            assert f.read() == data, name
    sizes = sum(os.path.getsize(os.path.join(torch_images.DIR, n))
                for n in committed)
    assert len(committed) <= 53 and sizes < 650_000
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
            with pytest.raises(OSError):
                jpre.load_image_bytes(files[name])
