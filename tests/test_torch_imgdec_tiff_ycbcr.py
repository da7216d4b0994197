"""YCbCr TIFF through libtiff's RGBA interface: the port's
``preprocessing._tiff_rgba`` bit for bit against PIL 12.1 with libtiff 4.7
(the JAX package's ``load_image_bytes`` and ``load_image``), on the CPU.

Pillow reads every YCbCr page but JPEG in one plane through
TIFFRGBAImageGet. Covered here: Pillow's own YCbCr files under PackBits,
LZW, Deflate and Adobe Deflate; the writer's pages
(``torch_images.tiff_page(..., ycbcr_subsampling=...)``) at each
subsampling that libtiff's put routines take in one plane, at sizes that
are and are not multiples of the factors, in one strip, in strips whose
rows split a row of data units, and in tiles whose edges are cropped, in
both byte orders; predictor 2 under LZW and Deflate (libtiff's scanline of
a subsampled strip, and a tile's rows, which it sometimes cannot
undifference); separate planes at 1 x 1 under PackBits, LZW, Deflate and
JPEG; YCbCrCoefficients and ReferenceBlackWhite set, defaulted and
invalid, in every field type libtiff reads; YCbCrPositioning; the eight
orientations, from bytes and from a path; a sample of (Y, Cb, Cr)
triples under several conversions; strips and tiles that fail in a block
(PIL's ``stoponerr`` is 0: libtiff's buffer as each codec leaves it,
``isc_tiff_inflate`` for a Deflate stream that zlib finds corrupt, against
zlib itself too); the refusals PIL shares; a few hundred mutated files.
A page the port would refuse by name where PIL decodes it is counted and
bounded (none is expected)."""
import io
import zlib

import numpy as np
import pytest

from insenticap_model_tpu import preprocessing as jpre
from insenticap_model_tpu_torch import preprocessing as tpre

import chip_smoke
from test_torch_imgdec_tiff import _agree, _both_refuse, _pil, _same
from torch_images import jpeg_coder, tiff_page, write_tiff

Image = pytest.importorskip("PIL.Image")

FACTORS = [(4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1)]
CODECS = {"packbits": 32773, "lzw": 5, "deflate": 8}


def _ycc(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


def _page(s, sub=(2, 2), **kw):
    """A YCbCr page of samples ``s`` at subsampling ``sub``, under Deflate
    unless another compression is given."""
    kw.setdefault("compression", 8)
    return write_tiff(s, 8, 6, ycbcr_subsampling=sub, **kw)


def test_pil_files():
    """Pillow's own YCbCr files (one strip, and a larger page in several
    strips) under PackBits, LZW, Deflate and Adobe Deflate: libtiff's
    writer stores them at 1 x 1 and the default ReferenceBlackWhite."""
    g = np.random.default_rng(30)
    small = Image.fromarray(g.integers(0, 256, (9, 11, 3), dtype=np.uint8))
    big = Image.fromarray(g.integers(0, 256, (150, 230, 3), dtype=np.uint8))
    for comp in ("packbits", "tiff_lzw", "tiff_deflate",
                 "tiff_adobe_deflate"):
        for im in (small, big):
            _same(_pil(im.convert("YCbCr"), compression=comp))


@pytest.mark.parametrize("comp", list(CODECS))
@pytest.mark.parametrize("sub", FACTORS, ids=lambda f: f"{f[0]}x{f[1]}")
def test_subsampling_matches_pil(sub, comp):
    """Each subsampling in one plane: 8x8, 7x9, 5x13 and 17x6 pages in
    one strip, in strips of vs rows, of 3 and 5 rows (which split a row of
    data units at vs 2 and 4; the last strip shorter), of one row, and in
    16x16 and 32x16 tiles (cropped at the edges), in either byte order."""
    code = CODECS[comp]
    for i, (h, w) in enumerate(((8, 8), (7, 9), (5, 13), (17, 6))):
        s = _ycc(h, w, 100 * FACTORS.index(sub) + code % 97 + i)
        order = "<>"[i % 2]
        for rps in (None, sub[1], 3, 5, 1):
            _same(_page(s, sub, compression=code, rows_per_strip=rps,
                        order=order))
        for tile in ((16, 16), (32, 16)):
            _same(_page(s, sub, compression=code, tile=tile, order=order))


@pytest.mark.parametrize("comp", ["lzw", "deflate"])
@pytest.mark.parametrize("sub", FACTORS, ids=lambda f: f"{f[0]}x{f[1]}")
def test_predictor_matches_pil(sub, comp):
    """Predictor 2: horAcc8 with a stride of 3 over libtiff's scanline of
    a subsampled strip (a row of units over vs) or a tile's rows of width
    x 3 bytes. Where the scanline is not a whole number of strides, or a
    tile not of whole rows (4x2, 2x1 and 1x2 tiles of 16 rows), libtiff
    fails the strip after decoding it and PIL shows its bytes as stored."""
    code = CODECS[comp]
    for i, (h, w) in enumerate(((8, 8), (7, 9), (6, 4))):
        s = _ycc(h, w, 7 * FACTORS.index(sub) + i)
        for rps in (None, 3):
            _same(_page(s, sub, compression=code, predictor=2,
                        rows_per_strip=rps))
        for tile in ((16, 16), (16, 48)):
            _same(_page(s, sub, compression=code, predictor=2, tile=tile))


@pytest.mark.parametrize("comp", ["packbits", "lzw", "deflate", "jpeg"])
def test_separate_planes(comp):
    """Separate planes at 1 x 1 (the only subsampling libtiff's
    putseparate8bitYCbCr11tile takes): strips, strips of 7 rows, tiles,
    predictor 2 under LZW and Deflate, JPEG planes of one component (each
    a 4:4:4 stream of PIL's). At 2 x 2 PIL refuses them, and so does the
    port."""
    s = _ycc(20, 35, 31)
    jpeg = {"compression": 7, "jpeg": jpeg_coder(85, 0)} if comp == "jpeg" \
        else {"compression": CODECS[comp]}
    preds = (1, 2) if comp in ("lzw", "deflate") else (1,)
    for layout in ({}, {"rows_per_strip": 7}, {"tile": (16, 16)}):
        for pred in preds:
            _same(write_tiff(s, 8, 6, planar=2, predictor=pred,
                             tags=[(530, 3, [1, 1])], **jpeg, **layout))
        _both_refuse(write_tiff(s, 8, 6, planar=2, **jpeg, **layout))


def test_smoke_ycbcr_writer_matches_pil():
    """``chip_smoke._tiff_ycbcr_bytes``, which writes phase 3e's YCbCr
    TIFFs without PIL (``jpeg_grey`` its JPEG planes): 2 x 2 under LZW, 1 x
    1 in separate planes under Deflate and JPEG, and 4 x 4 under Deflate,
    as PIL reads them, and near the pixels they were made from."""
    y, x = np.mgrid[:40, :56]
    img = np.stack([x * 4, y * 5, (x + y) * 2 + 20], -1).astype(np.uint8)
    for args in (((2, 2), 5, 1), ((1, 1), 8, 2), ((1, 1), 7, 2),
                 ((4, 4), 8, 1)):
        got = _same(chip_smoke._tiff_ycbcr_bytes(np, zlib, img, *args))
        if args[0] == (1, 1):
            assert np.abs(got.astype(int) - img).mean() < 4, args
    plane = img[:, :, 1]
    j = chip_smoke.jpeg_grey(np, plane[:13, :21])
    np.testing.assert_array_equal(tpre.load_image_bytes(j), np.asarray(
        Image.open(io.BytesIO(j))))


# (tag, type, values) of YCbCrCoefficients (529) and ReferenceBlackWhite
# (532): set, in each field type libtiff reads, and invalid (NaN, a green
# of 0, references out of range), or of another count or type (unset)
CONVERSIONS = [
    (529, 5, [299, 1000, 587, 1000, 114, 1000]),
    (529, 5, [2126, 10000, 7152, 10000, 722, 10000]),
    (529, 5, [16777217, 3, 587, 1000, 114, 1000]),
    (529, 5, [2 ** 32 - 1, 2 ** 32 - 3, 1, 3, 1, 3]),
    (529, 10, [-299, 1000, 587, 1000, 114, 1000]),
    (529, 11, [0.3, 0.5, 0.2]), (529, 12, [0.25, 0.5, 0.25]),
    (529, 12, [1e300, 1, -1e300]), (529, 11, [float("inf"), 1, 1]),
    (529, 11, [1, 1e-8, 1]), (529, 11, [-1, 3, 5]), (529, 3, [1, 2, 3]),
    (529, 4, [0, 1, 0]), (529, 11, [float("nan"), 1, 1]),
    (529, 5, [1, 0, 1, 0, 1, 0]), (529, 5, [1, 2, 1, 2]),
    (529, 2, b"abc"), (529, 9, [-1, 2, 3]),
    (532, 5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1]),
    (532, 5, [15, 1, 236, 1, 127, 1, 241, 1, 129, 1, 242, 1]),
    (532, 5, [16777217, 3, 255, 1, 128, 1, 255, 1, 128, 1, 255, 1]),
    (532, 10, [-5, 1, 255, 1, 128, 1, 255, 1, 128, 1, 255, 1]),
    (532, 10, [5, -1, 255, 1, 128, 1, 255, 1, 128, 1, 255, 1]),
    (532, 11, [0, 255, 128, 255, 128, 255]), (532, 3, [0, 255, 0, 255,
                                                      0, 255]),
    (532, 11, [0, 1e-30, 128, 128.00001, 128, 255]),
    (532, 11, [0, 0, 0, 0, 0, 0]),
    (532, 11, [-2147483500, 255, 128, 255, 128, 255]),
    (532, 11, [2147483000, 255, 128, 255, 128, 255]),
    (532, 11, [3e9, 255, 128, 255, 128, 255]),
    (532, 11, [float("nan"), 255, 128, 255, 128, 255]),
    (532, 5, [0, 1, 255, 1]),
]


def test_conversions_match_pil():
    """YCbCrCoefficients and ReferenceBlackWhite as libtiff reads and
    checks them (``_LibTiff.floats``, initYCbCrConversion), each on a
    2 x 2 page of 3-row strips; every page agrees with PIL (the invalid
    ones refused by both)."""
    s = _ycc(7, 9, 33)
    decoded = 0
    for tag, typ, vals in CONVERSIONS:
        for order in "<>":
            decoded += _agree(_page(s, (2, 2), rows_per_strip=3,
                                    order=order, tags=[(tag, typ, vals)]))
    assert decoded == 2 * (len(CONVERSIONS) - 5)


@pytest.mark.parametrize("setting", range(4))
def test_table_sample_matches_pil(setting):
    """16,384 random (Y, Cb, Cr) triples a page (1 x 1, Deflate) under
    the default conversion, Rec. 709's coefficients, studio-range
    references, and odd references of fractions (all 2^24 triples under
    each: ``python tools/ycbcr_triples.py``, outside the tier-1 run)."""
    tags = [[], [(529, 5, [2126, 10000, 7152, 10000, 722, 10000])],
            [(532, 5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])],
            [(532, 5, [7, 3, 250, 1, 255, 2, 241, 1, 129, 1, 200, 3]),
             (529, 5, [1, 3, 1, 2, 1, 6])]][setting]
    _same(_page(_ycc(128, 128, 34 + setting), (1, 1), compression=8,
                tags=tags))


def test_positioning_and_grey():
    """YCbCrPositioning (531) centred or cosited moves nothing in PIL's
    output; the grey YCbCr layout (one sample) PIL refuses."""
    s = _ycc(7, 9, 35)
    for pos in (1, 2):
        _same(_page(s, (2, 2), rows_per_strip=3, tags=[(531, 3, [pos])]))
        _same(_page(s, (2, 1), tile=(16, 16), tags=[(531, 3, [pos])]))
    _both_refuse(write_tiff(s[:, :, 0], 8, 6, compression=8))


def test_orientations(tmp_path):
    """All eight orientations, on 3-row strips of a 2 x 2 page and on
    16x16 tiles of a 4 x 2 one, from bytes and from a path (a compressed
    page is decoded, never mapped)."""
    s = _ycc(7, 21, 36)
    for o in range(1, 9):
        for kw in ({"rows_per_strip": 3, "sub": (2, 2)},
                   {"tile": (16, 16), "sub": (4, 2)}):
            kw = dict(kw)
            data = _page(s, kw.pop("sub"), orientation=o, compression=5,
                         **kw)
            _same(data)
            path = tmp_path / f"o{o}.tif"
            path.write_bytes(data)
            np.testing.assert_array_equal(tpre.load_image(str(path)),
                                          jpre.load_image(str(path)))


def test_pillow_reads_one_sample_libtiff_three():
    """A page whose StripOffsets entry claims more values than the file
    holds (its first, the strip's offset, at the end of the file): Pillow
    stops reading the IFD there, misses SamplesPerPixel and takes the grey
    layout ("L"), while libtiff reads the one offset it needs and three
    samples; PIL unpacks the first bytes of each RGBA row as grey, and so
    does the port."""
    entries, blocks = tiff_page(_ycc(6, 10, 37), 8, 6, compression=8,
                                ycbcr_subsampling=(2, 2))
    data = bytearray(chip_smoke.tiff_file([(entries, blocks)]))
    ifd = int.from_bytes(data[4:8], "little")
    at = ifd + 2 + 12 * [e[0] for e in entries].index(273)
    offset = data[at + 8:at + 12]
    data[at + 4:at + 12] = (1 << 26).to_bytes(4, "little") + len(
        data).to_bytes(4, "little")
    got = _same(bytes(data + offset))
    assert got.ndim == 2


def test_refusals_pil_shares():
    """Separate planes at 2 x 2 and 2 x 1, 4 and 16 bits, factors of 3 and
    8 and 0, four samples, a float page, predictor 3: libtiff's RGBA
    interface (or its directory) refuses them, so does the port."""
    s = _ycc(8, 8, 38)
    _both_refuse(write_tiff(s, 8, 6, planar=2, compression=8,
                            tags=[(530, 3, [2, 1])]))
    for bits in (4, 16):
        _both_refuse(write_tiff(s.astype(int) % (1 << bits), bits, 6,
                                compression=8, tags=[(530, 3, [1, 1])]))
    for sub in ([3, 2], [8, 2], [2, 0], [1, 3]):
        _both_refuse(write_tiff(s, 8, 6, compression=8,
                                tags=[(530, 3, sub)]))
    _both_refuse(write_tiff(np.concatenate([s, s[:, :, :1]], 2), 8, 6,
                            compression=8, tags=[(530, 3, [1, 1])]))
    _both_refuse(write_tiff(s.astype(np.float32), 32, 6, compression=8,
                            sample_format=3, tags=[(530, 3, [1, 1])]))
    _both_refuse(_page(s, (2, 2), compression=8, tags=[(317, 3, [3])]))


def _tile_row(comp, second, old=False):
    """A 2 x 2 page of two 16x16 tiles side by side whose second tile's
    stored bytes are ``second(stored, raw)``."""
    s = _ycc(16, 32, 39)
    entries, blocks = tiff_page(s, 8, 6, compression=comp, old_lzw=old,
                                tile=(16, 16), ycbcr_subsampling=(2, 2))
    raw = chip_smoke.ycbcr_units(np, s[:, 16:], 2, 2)
    blocks[1] = second(blocks[1], raw)
    return chip_smoke.tiff_file([(entries, blocks)])


def test_failing_tiles_read_as_libtiff_leaves_them():
    """PIL's ``stoponerr`` is 0: a tile after the first of its row that
    fails is drawn from the buffer as libtiff leaves it. Cut short under
    PackBits, new-style LZW and Deflate, its bytes then zeros; under
    old-style LZW the first tile's bytes after it (LZWDecodeCompat clears
    nothing); a tile past the end of the file, zeros; a Deflate stream
    that ends early, or with a fault (a bad header, block type or
    checksum, a flipped byte), what inflate wrote first. The first tile
    of a row failing, PIL refuses the page."""
    cut = {"half": lambda b, r: b[:len(b) // 2],
           "one byte": lambda b, r: b[:1]}
    for comp, old in ((32773, False), (5, False), (5, True), (8, False)):
        for how in cut.values():
            _same(_tile_row(comp, how, old))
    bad = {"short stream": lambda b, r: zlib.compress(r[:300]),
           "header": lambda b, r: b"\x78\x9d" + b[2:],
           "block type": lambda b, r: b[:2] + bytes([b[2] | 6]) + b[3:],
           "checksum": lambda b, r: b[:-1] + bytes([b[-1] ^ 1]),
           "flipped": lambda b, r: b[:40] + bytes([b[40] ^ 0x5A]) + b[41:]}
    for how in bad.values():
        _same(_tile_row(8, how))
    _same(write_tiff(_ycc(16, 32, 40), 8, 6, compression=8,
                     tile=(16, 16), ycbcr_subsampling=(2, 2),
                     tags=[(325, 4, [60, 10 ** 6])]))
    _both_refuse(write_tiff(_ycc(16, 32, 40), 8, 6, compression=8,
                            tile=(16, 16), ycbcr_subsampling=(2, 2),
                            tags=[(325, 4, [10 ** 6, 60])]))


def _inflate(chunk, size):
    out = np.zeros(size, np.uint8)
    wrote = tpre.ctypes.c_longlong()
    err = tpre.ctypes.create_string_buffer(256)
    rc = tpre._lib().isc_tiff_inflate(chunk, len(chunk), out.ctypes.data,
                                      size, tpre.ctypes.byref(wrote), err,
                                      256)
    return rc, out[:wrote.value].tobytes()


def test_inflate_against_zlib():
    """``isc_tiff_inflate`` against Python's zlib: stored, fixed and
    dynamic blocks at every level, whole and into less room; 400 streams
    with bytes changed, where zlib's outcome (faulty or not) is its own
    and what it wrote runs on from all that zlib gives byte by byte up to
    the fault."""
    g = np.random.default_rng(41)
    streams = []
    for level in range(10):
        raw = (g.integers(0, 6, 3000) * 40).astype(np.uint8).tobytes()
        streams.append((zlib.compress(raw, level), raw))
    streams.append((zlib.compress(b"ab" * 20), b"ab" * 20))
    for chunk, raw in streams:
        for size in (len(raw), len(raw) // 3, 1):
            assert _inflate(chunk, size) == (0, raw[:size])
        assert _inflate(chunk, len(raw) + 5)[0] == 2
    faults = 0
    for trial in range(400):
        chunk, raw = streams[trial % len(streams)]
        bad = bytearray(chunk)
        for _ in range(1 + trial % 3):
            bad[int(g.integers(0, len(bad)))] = int(g.integers(0, 256))
        bad = bytes(bad)
        rc, got = _inflate(bad, len(raw))
        try:
            want = zlib.decompressobj().decompress(bad, len(raw))
        except zlib.error:
            faults += 1
            assert rc == 1
            d, seen = zlib.decompressobj(), b""
            for k in range(len(bad)):
                try:
                    seen += d.decompress(bad[k:k + 1])
                except zlib.error:
                    break
            assert got.startswith(seen), trial
            continue
        assert (rc, got) == ((0 if len(want) == len(raw) else 2), want)
    assert faults > 100


@pytest.mark.parametrize("comp", list(CODECS) + ["jpeg"])
def test_mutated_files_agree(comp):
    """Random bytes anywhere in small YCbCr files changed (the header, the
    strips or tiles, the IFD and its values): strips and tiles at 2 x 2,
    4 x 2, 2 x 1 and 1 x 1, predictor 2 on every other LZW and Deflate
    file, JPEG planes at 1 x 1. The port decodes as PIL does or refuses
    where PIL refuses; one it would refuse by name where PIL decodes is
    counted, and there is none."""
    g = np.random.default_rng(42 + ["packbits", "lzw", "deflate",
                                    "jpeg"].index(comp))
    named = decoded = 0
    for trial in range(90):
        sub = [(2, 2), (4, 2), (2, 1), (1, 1)][trial % 4]
        tile = (16, 16) if trial % 3 == 0 else None
        s = (g.integers(0, 8, (9, 40 if tile else 13, 3)) * 32).astype(
            np.uint8)
        if comp == "jpeg":
            data = write_tiff(s, 8, 6, planar=2, compression=7,
                              jpeg=jpeg_coder(80, 0), tile=tile,
                              rows_per_strip=None if tile else 4,
                              tags=[(530, 3, [1, 1])])
        else:
            data = _page(s, sub, compression=CODECS[comp], tile=tile,
                         rows_per_strip=None if tile else 4,
                         predictor=2 if comp != "packbits" and trial % 2
                         else 1)
        data = bytearray(data)
        for _ in range(1 + trial % 3):
            data[int(g.integers(8, len(data)))] = int(g.integers(0, 256))
        data = bytes(data)
        try:
            want = jpre.load_image_bytes(data)
        except Exception:
            want = None
        try:
            got = tpre.load_image_bytes(data)
        except ValueError as e:
            assert want is None or "unsupported" in str(e), e
            named += want is not None
            continue
        assert want is not None and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        decoded += 1
    assert named == 0 and decoded > 20
