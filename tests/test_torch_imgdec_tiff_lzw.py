"""LZW (compression 5) and the floating-point predictor (3) in the port's
TIFF decoder (``isc_tiff_lzw`` in ``csrc/imgdec.cc``, ``_tiff_rows`` in
``preprocessing.py``) bit for bit against PIL 12.1 with libtiff 4.7 (the
JAX package's ``load_image_bytes``), on the CPU: the same dtype, shape and
values, or, where PIL refuses a file, a ValueError.

PIL's own LZW files (with and without horizontal differencing, in several
strips) and its mode-"F" files under predictor 3; every layout of
OPEN_INFO written by ``torch_images.write_tiff`` with new-style codes
(``chip_smoke.tiff_lzw``: MSB-first, the early change) and old-style ones
(LSB-first, no early change), in strips, tiles, planar 2, both byte
orders, BigTIFF, fill order 2, orientations, from a path; streams built
code by code (``chip_smoke.lzw_pack``) for each of the decoder's rules:
the string that is its own code's (KwKwK), a code past the table, CLEAR
mid-strip and at the start, a table that fills without CLEAR (libtiff's
1024 entries of slack past 4095), EOI early, a stream cut short, bytes
after the end; the first strip's style kept for the rest. Predictor 3
under LZW and Deflate, whose samples are compared before PIL's conversion
to RGB as well; LZW files mutated at random."""
import io

import numpy as np
import pytest

from insenticap_model_tpu import preprocessing as jpre
from insenticap_model_tpu_torch import preprocessing as tpre

from chip_smoke import lzw_pack, tiff_file, tiff_lzw
from test_torch_imgdec_tiff import (CMAP, KEYS, OPEN_INFO, READ_OTHERWISE,
                                    _agree, _agree_or_named, _both_refuse,
                                    _key_id, _pil, _pil_refuses,
                                    _same, _samples)
from torch_images import tiff_page, write_tiff

Image = pytest.importorskip("PIL.Image")

STYLES = {"new": False, "old": True}
CLEAR, EOI = 256, 257


def _same_samples(data):
    """The page's samples before the conversion to RGB, bit for bit: PIL's
    array of the image and the port's libtiff route's."""
    want = np.asarray(Image.open(io.BytesIO(data)))
    got = tpre._tiff_libtiff_route(tpre._Tiff(data))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _strips(blocks, h, w, k=1, rows=None):
    """A page of h x w x k 8-bit samples whose strips are ``blocks``."""
    entries, _ = tiff_page(np.zeros((h, w, k), np.uint8), 8, compression=5,
                           rows_per_strip=rows)
    return tiff_file([(entries, list(blocks))])


@pytest.mark.parametrize("key", KEYS, ids=[_key_id(k) for k in KEYS])
def test_layout_matches_pil(key):
    """A layout of OPEN_INFO under LZW, new-style and old-style codes: one
    strip, strips of two rows, 16x16 tiles of a 20x35 image (the edge
    tiles cropped), planar 1 and 2. PIL decodes each file but those that
    it refuses on the libtiff route (``_pil_refuses``); YCbCr through
    libtiff's RGBA interface."""
    order, photo, fmt, fill, bps, extra = key
    for layout in ({}, {"rows_per_strip": 2}, {"tile": (16, 16)}):
        shape = (20, 35) if layout.get("tile") else (6, 9)
        s = _samples(key, *shape, seed=KEYS.index(key))
        for planar in (1, 2):
            if (planar == 2 and layout.get("tile")
                    and OPEN_INFO[key][1] == "PX"):
                continue        # PIL's unpacker reads past the tile's rows
            for old in STYLES.values():
                data = write_tiff(
                    s, bps[0], photo, order="<" if order == b"II" else ">",
                    sample_format=fmt[0], extra_samples=extra,
                    fill_order=fill, compression=5, planar=planar,
                    old_lzw=old,
                    colormap=CMAP[:3 << bps[0]] if photo == 3 else None,
                    **layout)
                decoded = _agree(data)
                assert decoded != _pil_refuses(key, "lzw", "tile" in layout,
                                               planar), (layout, planar, old)


@pytest.mark.parametrize("mode", ["RGB", "L", "P", "RGBA", "CMYK", "I;16"])
def test_pil_lzw_files(mode):
    """PIL's own LZW files (libtiff's encoder), in one strip and in strips
    of about 1 KiB, with and without horizontal differencing."""
    g = np.random.default_rng(1)
    if mode == "I;16":
        im = Image.fromarray(g.integers(0, 700, (40, 53)).astype(np.uint16))
    else:
        rgb = (g.integers(0, 6, (40, 53, 3)) * 51).astype(np.uint8)
        im = Image.fromarray(rgb)
        im = im.quantize(37) if mode == "P" else im.convert(mode)
    for info in ({}, {317: 2}):
        for kw in ({}, {"strip_size": 1024}):
            data = _pil(im, compression="tiff_lzw", tiffinfo=info, **kw)
            assert Image.open(io.BytesIO(data)).info["compression"] == (
                "tiff_lzw")
            _same(data)


def _floats(g, h, w):
    """Floats of every kind: halves around 0..255, negatives, large ones,
    infinities, NaN, zeros of both signs, subnormals."""
    v = (g.integers(-20, 540, (h, w)) / 2).astype(np.float32)
    pick = g.integers(0, 12, (h, w))
    v[pick == 0] = np.inf
    v[pick == 1] = -np.inf
    v[pick == 2] = np.nan
    v[pick == 3] = -0.0
    v[pick == 4] = 1e-42
    v[pick == 5] = g.standard_normal(int((pick == 5).sum())) * 1e6
    return v


@pytest.mark.parametrize("comp", ["tiff_lzw", "tiff_adobe_deflate"])
def test_pil_float_predictor_files(comp):
    """PIL's mode-"F" files with the floating-point predictor (libtiff's
    fpDiff), in one strip and in several."""
    f = _floats(np.random.default_rng(2), 37, 45)
    for kw in ({}, {"strip_size": 1024}):
        data = _pil(Image.fromarray(f, "F"), compression=comp,
                    tiffinfo={317: 3}, **kw)
        assert Image.open(io.BytesIO(data)).tag_v2[317] == 3
        _same(data)
        _same_samples(data)


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("code", [5, 8])
def test_float_predictor(code, order):
    """Predictor 3 under LZW and Deflate, either byte order (libtiff hands
    over native samples, which Pillow reads as the file's order), one
    strip, strips of 3 rows, tiles, planar 2 (one sample, so a stride of
    one either way)."""
    f = _floats(np.random.default_rng(3), 21, 35)
    for kw in ({}, {"rows_per_strip": 3}, {"tile": (16, 16)}, {"planar": 2},
               {"tile": (32, 16), "planar": 2}, {"rows_per_strip": 1}):
        data = write_tiff(f, 32, order=order, sample_format=3,
                          compression=code, predictor=3, **kw)
        _same(data)
        _same_samples(data)
    if order == "<":
        np.testing.assert_array_equal(
            tpre._tiff_libtiff_route(tpre._Tiff(data)).view(np.uint32),
            f.view(np.uint32))


def test_float_predictor_refusals():
    """libtiff takes predictor 3 only for IEEE floats of 16, 24, 32 or 64
    bits: integer samples are refused, as are floats outside Pillow's
    OPEN_INFO; under PackBits the tag is ignored."""
    g = np.random.default_rng(4)
    for code in (5, 8):
        _both_refuse(write_tiff(g.integers(0, 256, (5, 9, 3)), 8,
                                compression=code, predictor=3))
        _both_refuse(write_tiff(g.integers(0, 1 << 16, (5, 9)), 16,
                                compression=code, predictor=3))
        _both_refuse(write_tiff(g.integers(-9, 9, (5, 9)), 32,
                                sample_format=2, compression=code,
                                predictor=3))
        _both_refuse(write_tiff(g.standard_normal((5, 9)), 64,
                                sample_format=3, compression=code,
                                predictor=3))
    _same(write_tiff(g.integers(0, 256, (5, 9, 3)), 8, compression=32773,
                     tags=[(317, 3, [3])]))


@pytest.mark.parametrize("style", list(STYLES))
@pytest.mark.parametrize("layout", [
    {"rows_per_strip": 2}, {"tile": (16, 16)}, {"planar": 2},
    {"planar": 2, "tile": (16, 16)}, {"order": ">"}, {"bigtiff": True},
    {"fill_order": 2}, {"predictor": 2}, {"predictor": 2, "order": ">"}],
    ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_styles_and_layouts(layout, style):
    """RGB, grey and 16-bit grey of a 20x35 image, each style of codes,
    in each layout."""
    g = np.random.default_rng(5)
    for bits, s in ((8, g.integers(0, 256, (20, 35, 3))),
                    (8, g.integers(0, 4, (20, 35)) * 85),
                    (16, g.integers(0, 1 << 16, (20, 35)))):
        _same(write_tiff(s, bits, compression=5, old_lzw=STYLES[style],
                         **layout))


@pytest.mark.parametrize("orientation", range(1, 10))
def test_orientation(orientation):
    """The Orientation tag over an LZW page, as PIL applies it."""
    g = np.random.default_rng(6)
    _same(write_tiff(g.integers(0, 256, (7, 12, 3)), 8, compression=5,
                     orientation=orientation, rows_per_strip=3))


def test_load_image_reads_lzw_files(tmp_path):
    """From a path as from bytes (PIL maps no compressed page)."""
    g = np.random.default_rng(7)
    files = {"new.tif": write_tiff(g.integers(0, 256, (9, 13, 3)), 8,
                                   compression=5, predictor=2),
             "old.tif": write_tiff(g.integers(0, 256, (9, 13)), 8,
                                   compression=5, old_lzw=True),
             "f.tif": write_tiff(_floats(g, 9, 13), 32, sample_format=3,
                                 compression=5, predictor=3),
             "pil.tif": _pil(Image.fromarray(g.integers(
                 0, 256, (9, 13, 3), dtype=np.uint8)),
                 compression="tiff_lzw", orientation=6)}
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
        got = tpre.load_image(str(tmp_path / name))
        want = jpre.load_image(str(tmp_path / name))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want)


# -- streams built code by code, one of the decoder's rules each ----------

ROW = bytes(range(65, 73))                # one 8x1 grey row


@pytest.mark.parametrize("style", list(STYLES))
def test_codes_that_repeat_their_own_string(style):
    """KwKwK: a code equal to the next free entry (its string the last
    one's and that one's first byte), in runs of one byte and of two."""
    old = STYLES[style]
    for data in (bytes(64), b"ab" * 40, bytes(range(8)) * 9):
        _same(_strips([tiff_lzw(data, old=old)], 1, len(data)))
    # a, then the code 258 at once: "aa"; then 259: "aaa"
    _same(_strips([lzw_pack([CLEAR, 97, 258, 259, EOI], old=old)], 1, 6))


@pytest.mark.parametrize("style", list(STYLES))
def test_code_past_the_table(style):
    """A code past the next free entry is refused ("Using code not yet in
    table", "Wrong length of decoded string"), one equal to it is not."""
    old = STYLES[style]
    _same(_strips([lzw_pack([CLEAR, 65, 66, 259, EOI], old=old)], 1, 4))
    for bad in (260, 300, 511, 4095):
        _both_refuse(_strips([lzw_pack([CLEAR, 65, 66, bad, EOI], old=old)],
                             1, 4))


@pytest.mark.parametrize("style", list(STYLES))
def test_clear_codes(style):
    """CLEAR mid-strip (the table and the width start again), a run of
    CLEARs, CLEAR at the encoder's widths' edges; a stream whose first code
    is not CLEAR, and a code above EOI right after CLEAR, are refused."""
    old = STYLES[style]
    _same(_strips([lzw_pack([CLEAR, CLEAR, CLEAR, *ROW[:4], CLEAR, CLEAR,
                             *ROW[4:], EOI], old=old)], 1, 8))
    _both_refuse(_strips([lzw_pack([*ROW, EOI], old=old)], 1, 8))
    _both_refuse(_strips([lzw_pack([CLEAR, 258, *ROW, EOI], old=old)], 1, 8))
    _both_refuse(_strips([lzw_pack([CLEAR, *ROW[:4], CLEAR, 300, *ROW[4:],
                                    EOI], old=old)], 1, 8))
    g = np.random.default_rng(8)
    data = g.integers(0, 256, 60 * 200, dtype=np.uint8).tobytes()
    for at in (259, 300, 510, 511, 512, 513, 1023, 1024, 2047, 2048, 4094,
               4095, 4096):
        _same(_strips([tiff_lzw(data, old=old, clear_at=at)], 60, 200))


@pytest.mark.parametrize("style", list(STYLES))
def test_table_that_fills_without_clear(style):
    """Past 4095 entries the codes stay 12 bits wide while the table goes
    on to 5118 (libtiff's CSIZE of 4095 + 1024): CLEAR just then decodes,
    a code more is refused, and so is a stream that never clears."""
    old = STYLES[style]
    data = np.random.default_rng(9).integers(
        0, 256, 90 * 200, dtype=np.uint8).tobytes()
    for at in (4097, 5000, 5119, 5120):
        _same(_strips([tiff_lzw(data, old=old, clear_at=at)], 90, 200))
    for at in (5121, 5122, None):
        _both_refuse(_strips([tiff_lzw(data, old=old, clear_at=at)], 90,
                             200))


@pytest.mark.parametrize("style", list(STYLES))
def test_end_of_the_stream(style):
    """EOI before the strip is full is refused ("Not enough data"), and so
    is a stream that ends first (no EOI); a stream whose last code fills
    the strip needs no EOI; what follows the strip's bytes (codes, EOI,
    other bytes) is not read."""
    old = STYLES[style]
    _both_refuse(_strips([lzw_pack([CLEAR, *ROW[:5], EOI, *ROW[5:], EOI],
                                   old=old)], 1, 8))
    _both_refuse(_strips([lzw_pack([CLEAR, *ROW[:7]], old=old)], 1, 8))
    _both_refuse(_strips([lzw_pack([CLEAR, EOI], old=old)], 1, 8))
    _same(_strips([lzw_pack([CLEAR, *ROW], old=old)], 1, 8))
    _same(_strips([lzw_pack([CLEAR, *ROW, 300, 301, CLEAR, 400], old=old)],
                  1, 8))
    _same(_strips([lzw_pack([CLEAR, *ROW, EOI], old=old) + b"after"], 1, 8))
    # a string cut at the strip's end: A, B, AB, then ABA (the code of the
    # next free entry), of which a strip of 6 bytes takes AB
    for w in (6, 7):
        _same(_strips([lzw_pack([CLEAR, 65, 66, 258, 260, EOI], old=old)], 1,
                      w))
    g = np.random.default_rng(10)
    full = tiff_lzw(g.integers(0, 4, 40 * 50, dtype=np.uint8).tobytes() * 2,
                    old=old)
    for cut in range(1, 12):
        _agree(_strips([full[:-cut]], 80, 50))


@pytest.mark.parametrize("styles", ["new-old", "old-new", "new-new-old",
                                    "old-old-new", "old-new-old"])
def test_first_strip_sets_the_style(styles):
    """LZWPreDecode looks for old-style codes in each strip, but the first
    strip's choice holds: a later strip of the other style is read in the
    first's, which cannot read it."""
    g = np.random.default_rng(11)
    kinds = styles.split("-")
    rgb = g.integers(0, 256, (2 * len(kinds), 9, 3))
    blocks = [tiff_lzw(rgb[2 * i:2 * i + 2].astype(np.uint8).tobytes(),
                       old=STYLES[kind]) for i, kind in enumerate(kinds)]
    _both_refuse(_strips(blocks, 2 * len(kinds), 9, 3, rows=2))
    for kind in set(kinds):
        _same(_strips([tiff_lzw(rgb[2 * i:2 * i + 2].astype(np.uint8)
                                .tobytes(), old=STYLES[kind])
                       for i in range(len(kinds))], 2 * len(kinds), 9, 3,
                      rows=2))


def test_strip_size_limit():
    """TIFFFillStrip's limit on a strip's byte count (ten times the strip
    and 4 KiB, for a count past 1 MiB) holds under LZW: bytes past the
    stream are not needed."""
    rgb = np.random.default_rng(12).integers(0, 256, (4, 9, 3))
    block = tiff_lzw(rgb.astype(np.uint8).tobytes()) + bytes(1 << 21)
    _same(_strips([block], 4, 9, 3))


@pytest.mark.parametrize("comp,what,mode", [
    ("ojpeg", "old-style JPEG", "RGB"), ("group3", "CCITT Group 3", "1")])
def test_still_refused_by_name(comp, what, mode):
    """Old-style JPEG (6; a YCbCr page of the writer's whose strip is
    PIL's JPEG stream, which PIL reads through libtiff's RGBA interface)
    stays refused by name; CCITT in TIFF, which was, is read as PIL reads
    it (``test_torch_imgdec_tiff_ccitt.py``)."""
    im = Image.fromarray(np.random.default_rng(13).integers(
        0, 256, (16, 24, 3), dtype=np.uint8)).convert(mode)
    if comp == "ojpeg":
        def jpeg(part):
            buf = io.BytesIO()
            Image.fromarray(part.astype(np.uint8)).save(buf, "JPEG")
            return buf.getvalue()
        _agree_or_named(write_tiff(np.asarray(im), 8, 6, compression=6,
                                   jpeg=jpeg), what)
    else:
        data = _pil(im, compression=comp)
        assert tpre._TIFF_CODECS[tpre._Tiff(data).compression] == what
        _same(data)


def test_ycbcr_under_lzw_refused_by_name():
    """YCbCr under LZW, which PIL reads through libtiff's RGBA interface,
    was refused by name; the port reads it now as PIL does, at 1 x 1 and
    at the default 2 x 2 (``test_torch_imgdec_tiff_ycbcr.py`` holds the
    rest)."""
    s = np.random.default_rng(14).integers(0, 256, (8, 10, 3))
    _same(write_tiff(s, 8, 6, compression=5, tags=[(530, 3, [1, 1])]))
    _same(write_tiff(s, 8, 6, compression=5))


MUTATED_LAYOUTS = ({"rows_per_strip": 3}, {"tile": (16, 16)},
                   {"planar": 2}, {"order": ">"}, {"bigtiff": True},
                   {"fill_order": 2}, {"predictor": 2})


@pytest.mark.parametrize("layout", MUTATED_LAYOUTS,
                         ids=lambda kw: "-".join(f"{k}{v}"
                                                 for k, v in kw.items()))
def test_mutated_files_agree(layout):
    """Random bytes anywhere in small LZW files changed (the header, the
    strips or tiles, the IFD and its values), new-style and old-style
    codes, grey, RGB and 16-bit: the port decodes as PIL does or refuses
    where PIL refuses, but for a page whose damaged IFD libtiff and Pillow
    read to other samples, bits or compression, which the port refuses by
    name whatever PIL does (at most one file in a hundred)."""
    g = np.random.default_rng(15 + MUTATED_LAYOUTS.index(layout))
    otherwise = decoded = 0
    for trial in range(100):
        kw = dict(layout)
        bigtiff, order = kw.pop("bigtiff", False), kw.pop("order", "<")
        bits, k = ((8, 3), (8, 1), (16, 1))[trial % 3]
        s = g.integers(0, 4, (18, 21, k)) * (80 if bits == 8 else 20000)
        entries, blocks = tiff_page(s, bits, order=order, compression=5,
                                    old_lzw=trial % 2 == 1, **kw)
        data = bytearray(tiff_file([(entries, blocks)],
                                              order=order, bigtiff=bigtiff))
        for _ in range(1 + trial % 3):
            data[int(g.integers(8, len(data)))] = int(g.integers(0, 256))
        try:
            tpre.load_image_bytes(bytes(data))
        except ValueError as e:
            if READ_OTHERWISE in str(e):
                otherwise += 1
                continue
        decoded += _agree(bytes(data))
    assert otherwise <= 1 and decoded > 0
