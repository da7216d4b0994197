"""The port's TIFF decoder (``preprocessing._decode_tiff``, with PackBits
and the CIELAB transform's interpolation in ``csrc/imgdec.cc``) bit for
bit against PIL 12.1 with libtiff 4.7 (the JAX package's
``load_image_bytes``), on the CPU: the same dtype, the same shape (2-D for
PIL's "L") and the same values, or, where PIL refuses a file, a
ValueError.

Every layout of Pillow's OPEN_INFO in both byte orders, uncompressed (its
raw decoders), PackBits and Deflate (libtiff), in one strip, in strips of
two rows and in 16x16 tiles with cropped edges, planar 1 and 2; BigTIFF;
fill order 2; orientations 1-8 (and a page read from a path, which PIL
maps); a second page, an IFD chain that loops; code 32946; predictor 2 at
8, 16 and 32 bits. Exhaustive conversions: every CIELAB triple, every
(value, alpha) of premultiplied RGBa, every (C, K) of CMYK, every "I;16"
value, floats with their halves, negatives, infinities and NaN. PIL's own
files. Refusals as PIL refuses: truncated strips, PackBits runs past the
strip and streams that end early, damaged Deflate streams, offsets past
the end, layouts outside OPEN_INFO, raw YCbCr, headers PIL or libtiff
refuse. What PIL decodes and the port refuses by name (LZW, JPEG, YCbCr
under PackBits or Deflate, predictor 3) is recorded, and queued in
ROADMAP."""
import io
import zlib

import numpy as np
import pytest

from insenticap_model_tpu import preprocessing as jpre
from insenticap_model_tpu_torch import preprocessing as tpre

import chip_smoke
from torch_images import tiff_page, write_tiff

Image = pytest.importorskip("PIL.Image")
TiffImagePlugin = pytest.importorskip("PIL.TiffImagePlugin")
OPEN_INFO = TiffImagePlugin.OPEN_INFO

_G = np.random.default_rng(27)
CMAP = _G.integers(0, 1 << 16, 3 * 256).tolist()
COMPRESSIONS = {"raw": 1, "packbits": 32773, "deflate": 8}


def _same(data):
    want = jpre.load_image_bytes(data)
    got = tpre.load_image_bytes(data)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


def _both_refuse(data):
    """PIL refuses the file (with whatever it raises), the port with
    ValueError."""
    with pytest.raises(Exception):
        jpre.load_image_bytes(data)
    with pytest.raises(ValueError):
        tpre.load_image_bytes(data)


def _agree(data):
    """The port decodes as PIL does, or refuses where PIL refuses; whether
    PIL decoded the file."""
    try:
        jpre.load_image_bytes(data)
    except Exception:
        with pytest.raises(ValueError):
            tpre.load_image_bytes(data)
        return False
    _same(data)
    return True


def _named(data, what):
    """PIL decodes the file; the port refuses it by name (queued)."""
    assert jpre.load_image_bytes(data).ndim in (2, 3)
    with pytest.raises(ValueError, match="unsupported: TIFF " + what):
        tpre.load_image_bytes(data)


def _agree_or_named(data, what):
    """``_agree``, but where PIL decodes the file the port refuses it by
    name."""
    try:
        jpre.load_image_bytes(data)
    except Exception:
        _both_refuse(data)
        return False
    _named(data, what)
    return True


def _pil(im, **kw):
    buf = io.BytesIO()
    im.save(buf, "TIFF", **kw)
    return buf.getvalue()


def _samples(key, h, w, seed):
    """Random samples of a layout: its bits and sample format."""
    _, _, fmt, _, bps, _ = key
    g = np.random.default_rng(seed)
    if fmt[0] == 3:
        return (g.standard_normal((h, w, len(bps))) * 150).astype(np.float32)
    lo, hi = (-(1 << bps[0] - 1), 1 << bps[0] - 1) if fmt[0] == 2 else (
        0, 1 << bps[0])
    return g.integers(lo, hi, (h, w, len(bps)))


def test_open_info_is_pillows():
    """The port's copy of OPEN_INFO is Pillow's, entry for entry."""
    assert tpre._TIFF_OPEN == dict(OPEN_INFO)


KEYS = sorted(OPEN_INFO, key=repr)


def _key_id(key):
    order, photo, fmt, fill, bps, extra = key
    mode, raw = OPEN_INFO[key]
    return (f"{order.decode()}-{photo}-{fmt[0]}-{fill}-"
            f"{'.'.join(map(str, bps))}-{'.'.join(map(str, extra))}-{raw}")


# Pillow's unpackers of one character, by mode: the raw route's planar
# layers (a layer's raw mode is the raw mode's character at its index)
LAYER_UNPACKERS = {"1": "1", "L": "L", "P": "P", "I": "I", "F": "F",
                   "RGB": "RGB", "RGBA": "RGBA", "CMYK": "CMYK", "LAB": "LAB"}
BANDS = {"LA": 2, "PA": 2, "RGB": 3, "LAB": 3, "RGBA": 4, "CMYK": 4}


def _pil_refuses(key, comp, tiled, planar):
    """Whether PIL refuses the writer's file of a layout, and why: on the
    raw route a raw mode Pillow has no unpacker for (fill order 2's
    "L;IR", "P;1R", "P;2R", "P;4R"; planar 2 reads its layers with "P"),
    a planar layer's character that has none for the mode ("X" padding,
    "a", "A" of "LA" and "PA", "I" of "I;16" and "I;12"), a 1-bit
    palette's planar edge tile (its stride of 2 bytes is shorter than the
    3 pixels the "P" unpacker reads); on libtiff's, planar strips of more
    samples than the mode's bands, and YCbCr grey, or planar YCbCr (which
    libtiff's RGBA interface refuses)."""
    mode, raw = OPEN_INFO[key]
    photo, spp = key[1], len(key[4])
    if comp == "raw":
        if raw in ("L;IR", "P;1R", "P;2R", "P;4R"):
            return planar == 1 or (tiled and raw == "P;1R")
        if planar == 2:
            return (tiled and raw == "P;1") or not all(
                raw[i] in LAYER_UNPACKERS.get(mode, "") for i in range(spp))
        return False
    if photo == 6:
        return mode == "L" or planar == 2
    return planar == 2 and not tiled and spp != BANDS.get(mode, 1)


@pytest.mark.parametrize("comp", list(COMPRESSIONS))
@pytest.mark.parametrize("key", KEYS, ids=[_key_id(k) for k in KEYS])
def test_layout_matches_pil(key, comp):
    """A layout of OPEN_INFO on its route: one strip, strips of two rows,
    16x16 tiles of a 20x35 image (the edge tiles cropped), planar 1 and 2.
    PIL decodes each file but those ``_pil_refuses`` names. YCbCr under
    PackBits or Deflate is refused by name where PIL decodes it (through
    libtiff's RGBA interface); planar "PX" tiles are not compared (PIL's
    unpacker reads past the tile's rows there)."""
    order, photo, fmt, fill, bps, extra = key
    code = COMPRESSIONS[comp]
    for layout in ({}, {"rows_per_strip": 2}, {"tile": (16, 16)}):
        shape = (20, 35) if layout.get("tile") else (6, 9)
        s = _samples(key, *shape, seed=len(KEYS) * code + KEYS.index(key))
        for planar in (1, 2):
            if (planar == 2 and layout.get("tile") and code != 1
                    and OPEN_INFO[key][1] == "PX"):
                continue
            data = write_tiff(
                s, bps[0], photo, order="<" if order == b"II" else ">",
                sample_format=fmt[0], extra_samples=extra, fill_order=fill,
                compression=code, planar=planar,
                colormap=CMAP[:3 << bps[0]] if photo == 3 else None,
                **layout)
            if photo == 6 and code != 1:
                decoded = _agree_or_named(data, "YCbCr")
            else:
                decoded = _agree(data)
            assert decoded != _pil_refuses(key, comp, "tile" in layout,
                                           planar), (layout, planar)


@pytest.mark.parametrize("comp", list(COMPRESSIONS))
@pytest.mark.parametrize("order", ["<", ">"])
def test_byte_orders_and_strip_counts(order, comp):
    """RGB and 16-bit grey in either byte order, one strip and strips of
    1, 3 and 7 rows of a 20-row image (the last short), tiles of 16x32."""
    g = np.random.default_rng(1)
    rgb = g.integers(0, 256, (20, 37, 3))
    grey = g.integers(0, 1 << 16, (20, 37))
    for rps in (None, 1, 3, 7):
        _same(write_tiff(rgb, 8, order=order, rows_per_strip=rps,
                         compression=COMPRESSIONS[comp]))
    _same(write_tiff(rgb, 8, order=order, tile=(16, 32),
                     compression=COMPRESSIONS[comp]))
    if order == "<" or comp != "raw":       # I;16 is little-endian's
        _same(write_tiff(grey, 16, order=order, rows_per_strip=3,
                         compression=COMPRESSIONS[comp]))


@pytest.mark.parametrize("comp", list(COMPRESSIONS))
def test_bigtiff(comp):
    """BigTIFF (little-endian: Pillow takes byte 2 of the header for the
    version, so it reads no big-endian BigTIFF), LONG8 and LONG offsets,
    strips and tiles."""
    g = np.random.default_rng(2)
    rgb = g.integers(0, 256, (19, 21, 3))
    code = COMPRESSIONS[comp]
    for kw in ({"offset_type": 16}, {"offset_type": 4},
               {"offset_type": 16, "tile": (16, 16)},
               {"offset_type": 16, "rows_per_strip": 4, "planar": 2}):
        _same(write_tiff(rgb, 8, bigtiff=True, compression=code, **kw))
    _both_refuse(write_tiff(rgb, 8, bigtiff=True, order=">",
                            compression=code, offset_type=16))


@pytest.mark.parametrize("comp", list(COMPRESSIONS))
@pytest.mark.parametrize("orientation", range(1, 10))
def test_orientation(orientation, comp):
    """Pillow applies the Orientation tag to a TIFF (exif_transpose in
    load_end): 2-8 flip and turn a non-square image, 1 and 9 leave it."""
    g = np.random.default_rng(3)
    code = COMPRESSIONS[comp]
    _same(write_tiff(g.integers(0, 256, (7, 12, 3)), 8, compression=code,
                     orientation=orientation))
    _same(write_tiff(g.integers(0, 256, (7, 12)), 8, compression=code,
                     orientation=orientation, rows_per_strip=3))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation_from_a_path(orientation, tmp_path):
    """From a path, PIL maps a page of one strip whose raw mode is its
    mode (L, P, I;16, RGBA, CMYK) at the page's size, which orientations
    5-8 swap: such a page reads as the other shape, then turns. The port's
    ``load_image`` does the same; its ``load_image_bytes`` decodes as PIL
    does from bytes."""
    g = np.random.default_rng(4)
    files = {"l.tif": write_tiff(g.integers(0, 256, (6, 10)), 8,
                                 orientation=orientation),
             "i16.tif": write_tiff(g.integers(0, 1 << 16, (6, 10)), 16,
                                   orientation=orientation),
             "rgba.tif": write_tiff(g.integers(0, 256, (6, 10, 4)), 8,
                                    extra_samples=(2,),
                                    orientation=orientation),
             "rgb.tif": write_tiff(g.integers(0, 256, (6, 10, 3)), 8,
                                   orientation=orientation),
             "strips.tif": write_tiff(g.integers(0, 256, (6, 10)), 8,
                                      orientation=orientation,
                                      rows_per_strip=2)}
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
        want = jpre.load_image(str(tmp_path / name))
        got = tpre.load_image(str(tmp_path / name))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        _same(data)


@pytest.mark.parametrize("comp", list(COMPRESSIONS))
def test_pages_and_chains(comp):
    """Only the first page is read: a second page is ignored, and a chain
    whose next pointer loops back (to the first IFD, or from the second)
    ends there."""
    g = np.random.default_rng(5)
    code = COMPRESSIONS[comp]
    rgb = g.integers(0, 256, (9, 11, 3))
    second = tiff_page(g.integers(0, 256, (4, 5)), 8)
    for kw in ({"pages": [second]}, {"loop": True},
               {"pages": [second], "loop": True}):
        _same(write_tiff(rgb, 8, compression=code, **kw))


def test_adobe_and_plain_deflate_codes():
    """Deflate under code 8 (PIL's writer's) and 32946."""
    rgb = np.random.default_rng(6).integers(0, 256, (13, 17, 3))
    for code in (8, 32946):
        np.testing.assert_array_equal(
            _same(write_tiff(rgb, 8, compression=code)), rgb)


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("bits", [8, 16, 32])
def test_predictor_2(bits, order):
    """Horizontal differencing under Deflate, undone a row at a time on
    the samples in native order (libtiff swaps them first), interleaved
    and planar, strips and tiles; on the raw route the tag is ignored."""
    g = np.random.default_rng(7)
    k, fmt = (3, 1) if bits < 32 else (1, 2 if order == ">" else 1)
    s = g.integers(0, 1 << min(bits, 31), (11, 19, k))
    if bits == 32 and fmt == 2:
        s = s - (1 << 30)
    for kw in ({}, {"planar": 2}, {"tile": (16, 16)},
               {"rows_per_strip": 4}):
        _same(write_tiff(s, bits, order=order, compression=8, predictor=2,
                         sample_format=fmt, **kw))
    _same(write_tiff(s, bits, order=order, compression=1, predictor=2,
                     sample_format=fmt))


def test_predictor_refusals():
    """libtiff refuses horizontal differencing below 8 bits and unknown
    predictors; the floating-point predictor (3), which it decodes, is
    refused by name."""
    g = np.random.default_rng(8)
    _both_refuse(write_tiff(g.integers(0, 16, (5, 9)), 4, compression=8,
                            predictor=2))
    _both_refuse(write_tiff(g.integers(0, 256, (5, 9, 3)), 8, compression=8,
                            predictor=5))
    _named(write_tiff(g.standard_normal((5, 9)).astype(np.float32), 32,
                      sample_format=3, compression=8, predictor=3),
           "floating-point predictor")


def test_predictor_ignored_under_packbits():
    """libtiff's PackBits codec has no predictor: the tag, whatever its
    value, leaves the samples as they are stored."""
    s = np.random.default_rng(24).integers(0, 256, (6, 11, 3))
    for predictor in (2, 3, 5):
        for kw in ({}, {"planar": 2}, {"tile": (16, 16)}):
            _same(write_tiff(s, 8, compression=32773,
                             tags=[(317, 3, [predictor])], **kw))


def test_fill_order_2_on_both_routes():
    """Fill order 2: the raw route's bit-reversed raw modes, and libtiff
    reversing the stored bytes before it decodes them."""
    g = np.random.default_rng(9)
    for bits, k in ((1, 1), (2, 1), (4, 1), (8, 1), (8, 3), (16, 1)):
        s = g.integers(0, 1 << bits, (7, 13, k))
        for code in COMPRESSIONS.values():
            _same(write_tiff(s, bits, compression=code, fill_order=2))


def test_every_lab_triple():
    """All 2^24 CIELAB triples in one 4096x4096 image, each route's
    unpacking aside: PIL converts through LittleCMS (its Lab v2 and sRGB
    profiles), the port through ``isc_tiff_lab`` over the same 33^3
    table."""
    v = np.arange(1 << 24, dtype=np.uint32)
    lab = np.stack([v >> 16, v >> 8 & 255, v & 255], -1).astype(
        np.uint8).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(
        _same(write_tiff(lab, 8, 8)),
        np.asarray(Image.frombytes("LAB", (4096, 4096),
                                   lab.tobytes()).convert("RGB")))


def test_every_premultiplied_pair():
    """RGBa: every (value, alpha) pair, the colour over the alpha undone
    (transparent black, opaque as stored), interleaved and (libtiff's
    route, which undoes it after the planes) planar."""
    c, a = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    s = np.stack([c, 255 - c, c // 2, a], -1)
    for code in COMPRESSIONS.values():
        for planar in (1, 2):
            data = write_tiff(s, 8, extra_samples=(1,), compression=code,
                              planar=planar)
            if code == 1 and planar == 2:   # Pillow has no "a" unpacker
                _both_refuse(data)
            else:
                _same(data)
    s16 = (s * 257 + np.random.default_rng(10).integers(0, 256, s.shape))
    for order in "<>":
        _same(write_tiff(s16, 16, extra_samples=(1,), order=order))


def test_every_cmyk_pair():
    """CMYK: every (C, K) pair, with M and Y swept too (libImaging's
    cmyk2rgb on samples that are not inverted), 8 and 16 bits."""
    c, k = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    s = np.stack([c, (c * 7) % 256, 255 - c, k], -1)
    for code in COMPRESSIONS.values():
        _same(write_tiff(s, 8, 5, compression=code))
    _same(write_tiff(s * 257, 16, 5, order=">"))


def test_every_uint16_value():
    """I;16 (little-endian, big-endian, 12-bit): every value, clamped at
    255 by PIL's RGB; signed 16 and 32 bits clipped to 0..255."""
    v = np.arange(1 << 16).reshape(256, 256)
    _same(write_tiff(v, 16))
    _same(write_tiff(v, 16, order=">"))
    _same(write_tiff(v, 16, fill_order=2))
    _same(write_tiff(v % 4096, 12))
    _same(write_tiff(v - 32768, 16, sample_format=2))
    _same(write_tiff(v - 32768, 16, sample_format=2, order=">"))
    _same(write_tiff((v - 32768) * 40503, 32, sample_format=2))
    _same(write_tiff(v * 65537, 32))


def test_float_sweep():
    """F: truncated, not rounded; below 0 and NaN to 0, 255 and above to
    255; both byte orders, both photometrics."""
    f = np.concatenate([np.arange(-3, 260, 0.25), np.arange(-1, 1, 1 / 64),
                        [np.nan, np.inf, -np.inf, -0.0, 254.9999, 1e30,
                         -1e30, 2.0 ** -149]]).astype(np.float32)
    f = f[:len(f) // 8 * 8].reshape(8, -1)
    for order in "<>":
        for photo in (0, 1):
            _same(write_tiff(f, 32, photo, order=order, sample_format=3))


@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "PA", "I;16",
                                  "I;16B", "I", "F", "RGB", "RGBA", "RGBX",
                                  "CMYK", "LAB"])
@pytest.mark.parametrize("comp", ["raw", "packbits", "tiff_deflate",
                                  "tiff_adobe_deflate"])
def test_pil_files(mode, comp):
    """The files PIL writes (through libtiff for a compression), of each
    mode it saves as TIFF; an RGB over 64 KiB (several strips)."""
    g = np.random.default_rng(11)
    arr = g.integers(0, 256, (29, 37, 4), dtype=np.uint8)
    im = Image.fromarray(arr, "RGBA")
    if mode in ("I;16", "I;16B", "I", "F"):
        im = Image.fromarray(g.integers(0, 600, (29, 37)).astype(np.int32))
    if mode in ("P", "PA"):
        im = im.convert("RGB").quantize(40)
    im = im.convert(mode) if mode not in ("P", "I;16", "I;16B") else im
    if mode in ("I;16", "I;16B"):
        im = Image.fromarray(g.integers(0, 600, (29, 37)).astype(np.uint16))
        im = im.convert(mode) if mode == "I;16B" else im
    _same(_pil(im, compression=comp))
    if mode == "RGB":
        big = Image.fromarray(g.integers(0, 256, (120, 300, 3),
                                         dtype=np.uint8))
        _same(_pil(big, compression=comp))


def test_pil_ycbcr_file():
    """PIL writes YCbCr (photometric 6): uncompressed, its raw mode reads
    four bytes a pixel from three, so PIL refuses it as truncated; under
    Deflate PIL decodes it through libtiff's RGBA interface and the port
    refuses it by name."""
    im = Image.fromarray(np.random.default_rng(12).integers(
        0, 256, (9, 11, 3), dtype=np.uint8)).convert("YCbCr")
    _both_refuse(_pil(im))
    _named(_pil(im, compression="tiff_deflate"), "YCbCr")


def test_smoke_writer_matches_pil():
    """``chip_smoke._tiff_bytes``, which writes the 448x448 TIFFs that
    phase 3e times without PIL: uncompressed, PackBits and Deflate with
    predictor 2 decode to its pixels in PIL and in the port."""
    img = np.random.default_rng(13).integers(0, 256, (96, 240, 3),
                                              dtype=np.uint8)
    img[:, ::3] = 7                                # runs for PackBits
    for code in (1, 32773, 8):
        data, want = chip_smoke._tiff_bytes(np, zlib, img, code)
        np.testing.assert_array_equal(_same(data), want)


@pytest.mark.parametrize("comp", list(COMPRESSIONS))
def test_truncated_and_misplaced_strips(comp):
    """A file cut inside its strip, or before its IFD's values, a strip
    offset past the end, a tile offset past the end: refused as PIL
    refuses them."""
    g = np.random.default_rng(14)
    rgb = g.integers(0, 256, (12, 15, 3))
    code = COMPRESSIONS[comp]
    whole = write_tiff(rgb, 8, compression=code)
    for cut in (9, 20, 40, 100, len(whole) - 30):
        _agree(whole[:cut])
    for tag, kw in ((273, {}), (324, {"tile": (16, 16)})):
        entries, blocks = tiff_page(rgb, 8, compression=code,
                                    tags=[(tag, 4, [10 ** 6])], **kw)
        _both_refuse(chip_smoke.tiff_file([(entries, blocks)]))
    # the strip's data past the end, its offset inside the file
    data = bytearray(write_tiff(rgb, 8, compression=code))
    entries, blocks = tiff_page(rgb, 8, compression=code,
                                tags=[(273, 4, [len(data) - 20])])
    _both_refuse(chip_smoke.tiff_file([(entries, blocks)]))


@pytest.mark.parametrize("comp", ["packbits", "deflate"])
def test_missing_byte_counts(comp):
    """Without StripByteCounts Pillow's raw route never needed them;
    libtiff estimates them for one strip (or one a plane) and refuses more
    (MissingRequired)."""
    g = np.random.default_rng(15)
    s = g.integers(0, 4, (20, 35, 3)) * 60
    code = COMPRESSIONS[comp]
    for kw in ({}, {"rows_per_strip": 2}, {"tile": (16, 16)},
               {"planar": 2}, {"planar": 2, "rows_per_strip": 3}):
        tag = 325 if "tile" in kw else 279
        entries, blocks = tiff_page(s, 8, compression=code,
                                    tags=[(tag, None, None)], **kw)
        _agree(chip_smoke.tiff_file([(entries, blocks)]))
    entries, blocks = tiff_page(s, 8, tags=[(279, None, None)],
                                rows_per_strip=5)
    _same(chip_smoke.tiff_file([(entries, blocks)]))
    # an entry whose values would lie past the end: more than the file in
    # the estimate, which then takes the whole file (the last strip cut)
    for kw in ({}, {"planar": 2}):
        entries, blocks = tiff_page(s, 8, compression=code,
                                    tags=[(279, None, None)], **kw)
        data = bytearray(chip_smoke.tiff_file(
            [(entries + [(50000, 1, b"x" * 8)], blocks)]))
        t = tpre._Tiff(bytes(data))
        at = t.ifd + 2 + 12 * [e[0] for e in t.entries].index(50000)
        data[at + 4:at + 8] = (10 ** 6).to_bytes(4, "little")
        _same(bytes(data))


def _strip_bomb(code, w, h, *, rps=None, tile=None, bigtiff=False):
    """A grey page of w x h with a single 16-byte strip or tile under
    ``code`` and one offset, where its rows a strip (or its square tiles)
    call for many."""
    body = (chip_smoke.packbits(bytes(16)) if code == 32773
            else zlib.compress(bytes(16)))
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8]),
               (259, 3, [code]), (262, 3, [1]), (277, 3, [1])]
    if tile:
        entries += [(322, 4, [tile]), (323, 4, [tile]),
                    (324, 4, "offsets"), (325, 4, "counts")]
    else:
        entries += [(273, 4, "offsets"), (278, 4, [rps]),
                    (279, 4, "counts")]
    return chip_smoke.tiff_file([(entries, [body])], bigtiff=bigtiff)


@pytest.mark.parametrize("case", ["strips", "bigtiff", "tiles", "padded"])
def test_strip_count_bombs_refused(case):
    """A file of a hundred bytes whose size (within the pixel limit) and
    rows a strip, or tile size, call for millions of strips or tiles, with
    one offset: refused before anything of that count is built, as libtiff
    refuses more than a million strips that the file does not list; up to
    a million, the offsets padded with zeros (TIFFFetchStripThing) and the
    second strip refused, as PIL refuses it."""
    import tracemalloc
    top = tpre.MAX_PIXELS
    data, budget = {
        "strips": (_strip_bomb(32773, 1, top, rps=1), 1 << 20),
        "bigtiff": (_strip_bomb(8, 1, top, rps=1, bigtiff=True), 1 << 20),
        "tiles": (_strip_bomb(32773, 16, top // 16, tile=4), 1 << 20),
        "padded": (_strip_bomb(32773, 1, 2_000_000, rps=2), 48 << 20)}[case]
    assert len(data) < 256
    tracemalloc.start()
    try:
        with pytest.raises(ValueError, match="TIFF"):
            tpre.load_image_bytes(data)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < budget
    if case == "padded":
        _both_refuse(data)


def _raw_page(rgb, code, body):
    entries, _ = tiff_page(rgb, 8, compression=code)
    return chip_smoke.tiff_file([(entries, [body])])


def test_packbits_streams():
    """libtiff's PackBitsDecode: a run or literal past the strip is cut
    (it warns), a -128 header byte is skipped, runs cross rows; a stream
    that ends before the strip is full, or inside a literal, is
    refused."""
    rgb = np.random.default_rng(16).integers(0, 3, (7, 10, 3)) * 100
    raw = rgb.astype(np.uint8).tobytes()
    pb = chip_smoke.packbits(raw)
    code = 32773
    _same(_raw_page(rgb, code, pb))
    _same(_raw_page(rgb, code, bytes([128]) + pb + bytes([128])))
    _same(_raw_page(rgb, code, pb + bytes([256 - 20, 7])))
    _same(_raw_page(rgb, code, chip_smoke.packbits(raw[:-2])
                    + bytes([9]) + bytes(range(10))))
    _same(_raw_page(rgb, code, chip_smoke.packbits(raw[:-2])
                    + bytes([256 - 9, 5])))
    _same(_raw_page(rgb, code, b"".join(
        bytes([256 - 127, v]) for v in raw[::128]) + pb))
    _both_refuse(_raw_page(rgb, code, pb[:-2]))
    _both_refuse(_raw_page(rgb, code, chip_smoke.packbits(raw[:-3])
                           + bytes([5, 1])))
    _both_refuse(_raw_page(rgb, code, chip_smoke.packbits(raw[:-3])
                           + bytes([256 - 4])))
    _both_refuse(_raw_page(rgb, code, b""))


def test_deflate_streams():
    """libtiff's ZIPDecode (zlib): the stream's strip bytes and no more,
    so a stream without its Adler-32, or with more data after the strip,
    decodes; a damaged checksum right after the strip's last byte, damaged
    data, a stream that ends early and a raw deflate stream are refused."""
    rgb = np.random.default_rng(17).integers(0, 256, (7, 10, 3))
    raw = rgb.astype(np.uint8).tobytes()
    z = zlib.compress(raw)
    _same(_raw_page(rgb, 8, z))
    _same(_raw_page(rgb, 8, z[:-4]))
    _same(_raw_page(rgb, 8, zlib.compress(raw + b"more than the strip")))
    adler = bytearray(z)
    adler[-1] ^= 1
    _both_refuse(_raw_page(rgb, 8, bytes(adler)))
    late = bytearray(zlib.compress(raw + bytes(64)))
    late[-1] ^= 1                     # past the strip: never checked
    _same(_raw_page(rgb, 8, bytes(late)))
    bad = bytearray(z)
    bad[len(bad) // 2] ^= 0x55
    _agree(_raw_page(rgb, 8, bytes(bad)))
    _both_refuse(_raw_page(rgb, 8, zlib.compress(raw[:-3])))
    _both_refuse(_raw_page(rgb, 8, z[2:]))
    _both_refuse(_raw_page(rgb, 8, z[:len(z) // 2]))


def test_layouts_outside_open_info_and_bad_tags():
    """Refused where Pillow's _setup refuses: a layout outside OPEN_INFO
    (mixed bits, 3 bits, 16-bit palette, big-endian 12 bits), too many
    samples, missing or non-integer dimensions, no offsets, an unknown
    compression, a ColorMap missing, a palette past 256 entries, a width
    of 0."""
    g = np.random.default_rng(18)
    rgb = g.integers(0, 256, (5, 6, 3))
    grey = g.integers(0, 8, (5, 6))
    cases = [write_tiff(rgb, 8, tags=[(258, 3, [8, 8, 16])]),
             write_tiff(grey, 3),
             write_tiff(grey, 16, 3, colormap=CMAP),
             write_tiff(grey, 12, order=">"),
             write_tiff(g.integers(0, 256, (5, 6, 7)), 8),
             write_tiff(rgb, 8, tags=[(256, None, None)]),
             write_tiff(rgb, 8, tags=[(257, 1, b"\x05")]),
             write_tiff(rgb, 8, tags=[(256, 5, [6, 1])]),
             write_tiff(rgb, 8, tags=[(273, None, None)]),
             write_tiff(rgb, 8, tags=[(259, 3, [12345])]),
             write_tiff(grey, 8, 3),
             write_tiff(grey, 8, 3, colormap=CMAP * 2),
             write_tiff(rgb, 8, tags=[(256, 4, [0])])]
    for data in cases:
        _both_refuse(data)


def test_entries_as_pillow_reads_them():
    """ImageFileDirectory_v2's reading: SHORT or LONG sizes, a tag given
    twice (the last wins), an entry of an unknown type skipped, an
    entry's data past the end (the reading stops there: what follows is
    lost), an empty entry, BitsPerSample given once for three samples or
    with a value too many, SampleFormat all 1s, the invalid headers'
    byte orders (PIL reads them raw; libtiff refuses them)."""
    g = np.random.default_rng(19)
    rgb = g.integers(0, 256, (5, 6, 3))
    _same(write_tiff(rgb, 8, tags=[(256, 3, [6]), (257, 3, [5])]))
    entries, blocks = tiff_page(rgb, 8)
    _same(chip_smoke.tiff_file([(entries + [(256, 4, [6])], blocks)]))
    _same(chip_smoke.tiff_file([(entries[:1] + [(300, 99, b"\0\1\0\0")]
                                 + entries[1:], blocks)]))
    late = [(999, 4, [0] * 4)]
    _agree(chip_smoke.tiff_file([(entries[:3] + late + entries[3:],
                                  blocks)]))
    _same(write_tiff(rgb, 8, tags=[(258, 3, [8])]))
    _same(write_tiff(rgb, 8, tags=[(258, 3, [8, 8, 8, 8])]))
    _same(write_tiff(rgb, 8, tags=[(339, 3, [1, 1, 1])]))
    _same(write_tiff(rgb, 8, tags=[(305, 2, b"a writer\0")]))
    _same(write_tiff(rgb, 8, tags=[(262, 2, b"RGB\0")]))
    for code in (1, 8):
        for magic, order in ((b"MM*\0", ">"), (b"II\0*", "<")):
            _agree(write_tiff(rgb, 8, order=order, magic=magic,
                              compression=code))
    # a tag whose data lies past the end: Pillow keeps the entries before
    # it (after the image's tags: the page decodes; before StripOffsets:
    # it is lost, and the page refused)
    for tag, decodes in ((50000, True), (270, False)):
        for code in (1, 8):
            entries, blocks = tiff_page(rgb, 8, compression=code,
                                        tags=[(tag, 2, b"x" * 40)])
            data = bytearray(chip_smoke.tiff_file([(entries, blocks)]))
            at = data.index(b"x" * 40)
            ifd = 8 + sum(len(b) + len(b) % 2 for b in blocks)
            field = data.index(at.to_bytes(4, "little"), ifd)
            data[field:field + 4] = (len(data) + 100).to_bytes(4, "little")
            if decodes:
                _same(bytes(data))
            else:
                _both_refuse(bytes(data))


# the TIFF signatures of Pillow's _accept, each in a file whose first IFD
# offset is 0 (no image): PIL refuses, the port raises ValueError
SIGNATURES = [b"MM\0*", b"II*\0", b"MM*\0", b"II\0*", b"MM\0+", b"II+\0"]


@pytest.mark.parametrize("prefix", SIGNATURES, ids=repr)
def test_signature_without_an_image(prefix):
    """Each of the six signatures is TIFF's (no longer refused by name),
    read as a TIFF: with no first IFD, PIL and the port refuse it."""
    Image.init()
    data = prefix + bytes(64)
    assert TiffImagePlugin._accept(data)
    _both_refuse(data)
    with pytest.raises(ValueError, match="TIFF"):
        tpre.load_image_bytes(data)


@pytest.mark.parametrize("comp,what", [("tiff_lzw", "LZW"),
                                       ("jpeg", "JPEG"),
                                       ("group4", "CCITT Group 4")])
def test_other_compressions_refused_by_name(comp, what):
    """PIL writes and reads them; the port refuses each by name (queued
    in ROADMAP)."""
    mode = "1" if comp == "group4" else "RGB"
    im = Image.fromarray(np.random.default_rng(20).integers(
        0, 256, (16, 24, 3), dtype=np.uint8)).convert(mode)
    _named(_pil(im, compression=comp), what)


# the port's refusal, by name, of a page whose IFD libtiff and Pillow read
# to other samples, bits or compression (queued in ROADMAP)
READ_OTHERWISE = "tags that libtiff reads otherwise"


def _past_the_end(data, tag=262, count=1_000_000):
    """``data`` with the count of ``tag``'s entry raised: Pillow's reading
    of the IFD stops there (its values would lie past the end), libtiff
    skips the entry (Photometric, XResolution) and reads on."""
    import struct
    t = tpre._Tiff(data)
    at = t.ifd + 2 + 12 * [e[0] for e in t.entries].index(tag)
    out = bytearray(data)
    out[at + 4:at + 8] = struct.pack("<L", count)
    return bytes(out)


@pytest.mark.parametrize("comp", ["packbits", "deflate"])
def test_ifd_read_otherwise(comp):
    """Where Pillow loses SamplesPerPixel (its reading of the IFD stopped
    before it) and libtiff does not, PIL decodes a planar RGB page as grey
    (the first plane), or refuses a contiguous one; the port refuses both
    by name. Where Pillow loses only PlanarConfiguration, its decoder
    takes libtiff's, as the port does."""
    s = np.random.default_rng(23).integers(0, 256, (20, 35, 3))
    code = COMPRESSIONS[comp]
    for kw in ({"planar": 2}, {"planar": 2, "tile": (16, 16)}):
        _named(_past_the_end(write_tiff(s, 8, compression=code, **kw)),
               READ_OTHERWISE)
    for kw in ({}, {"tile": (16, 16)}):
        _both_refuse(_past_the_end(write_tiff(s, 8, compression=code, **kw)))
    for kw in ({}, {"tile": (16, 16)}):          # XResolution's count
        data = _past_the_end(write_tiff(s, 8, compression=code, planar=2,
                                        tags=[(282, 5, [72, 1])], **kw),
                             282, 20000)
        assert 284 not in tpre._Tiff(data).tags
        _same(data)


MUTATED_LAYOUTS = ({"rows_per_strip": 3}, {"tile": (16, 16)},
                   {"planar": 2}, {"planar": 2, "tile": (16, 16)},
                   {"order": ">"}, {"bigtiff": True}, {"fill_order": 2})


def test_mutated_files_agree():
    """Random bytes anywhere in small uncompressed, PackBits and Deflate
    files changed (the header, the strips or tiles, the IFD and its
    values), grey, RGB and 16-bit, in strips, tiles, planar 2, big-endian,
    BigTIFF, fill order 2: the port decodes as PIL does or refuses where
    PIL refuses, but for a page whose damaged IFD libtiff and Pillow read
    to other samples, bits or compression, which the port refuses by name
    whatever PIL does (``test_ifd_read_otherwise``)."""
    g = np.random.default_rng(21)
    otherwise = 0
    for trial in range(900):
        code = (1, 32773, 8)[trial % 3]
        kw = dict(MUTATED_LAYOUTS[trial // 3 % len(MUTATED_LAYOUTS)])
        bigtiff, order = kw.pop("bigtiff", False), kw.pop("order", "<")
        bits, k = ((8, 3), (8, 1), (16, 1))[trial // 21 % 3]
        s = g.integers(0, 4, (18, 21, k)) * (80 if bits == 8 else 20000)
        entries, blocks = tiff_page(s, bits, order=order, compression=code,
                                    **kw)
        data = bytearray(chip_smoke.tiff_file([(entries, blocks)],
                                              order=order, bigtiff=bigtiff))
        for _ in range(1 + trial % 3):
            data[int(g.integers(8, len(data)))] = int(g.integers(0, 256))
        try:
            tpre.load_image_bytes(bytes(data))
        except ValueError as e:
            if READ_OTHERWISE in str(e):
                otherwise += 1
                continue
        _agree(bytes(data))
    assert otherwise <= 3


def test_load_image_reads_tiff_files(tmp_path):
    """From a path as from bytes."""
    g = np.random.default_rng(22)
    files = {"rgb.tif": write_tiff(g.integers(0, 256, (9, 13, 3)), 8,
                                   compression=8, predictor=2),
             "p.tif": write_tiff(g.integers(0, 256, (9, 13)), 8, 3,
                                 colormap=CMAP),
             "tiles.tiff": write_tiff(g.integers(0, 256, (20, 35, 3)), 8,
                                      compression=32773, tile=(16, 16))}
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
        got = tpre.load_image(str(tmp_path / name))
        want = jpre.load_image(str(tmp_path / name))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want)
