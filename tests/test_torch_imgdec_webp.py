"""The port's lossless WebP decoder (``preprocessing._decode_webp``, the
container, with the VP8L bitstream in ``csrc/imgdec.cc``) bit for bit
against PIL 12.1 with libwebp 1.6 (the JAX package's ``load_image_bytes``),
on the CPU: the same dtype, the same shape (always RGB) and the same
values, or, where PIL refuses a file, a ValueError.

The bitstreams come from the writer of ``tests/torch_images.py``
(``chip_smoke.vp8l``), which codes given pixels as they are (the decoded
image is what the transforms make of them), and from PIL: each predictor
mode alone and in tiles of every size, the border rules on single rows and
columns, cross-colour with negative multipliers, subtract-green, colour
indexing at every bundle width (indices past the palette included), the
transforms in several orders, colour caches of 1 to 11 bits (in
sub-images too), meta prefix codes with several groups (unused ones
included), simple codes of one and two symbols, normal codes of one
symbol, with and without repeats and ``max_symbol``, the 120 short
distance codes on narrow images, plain distances, self-overlapping copies,
random streams of all of it; PIL's files at methods 0, 4 and 6; VP8X with
ICCP, EXIF and XMP; the first frame of an animation, at an offset on a
larger canvas. Lossy WebP decodes as PIL decodes it (the files here; the
lossy decoder's own matrix is ``test_torch_imgdec_vp8.py``); malformed
containers and bitstreams, and mutated and truncated files, are refused
where PIL refuses them and decode as PIL decodes them otherwise."""
import io

import numpy as np
import pytest

from insenticap_model_tpu import preprocessing as jpre
from insenticap_model_tpu_torch import preprocessing as tpre

import chip_smoke
from torch_images import (VP8LBitWriter, vp8l, webp_anim, webp_anmf,
                          webp_chunk, webp_file, webp_vp8x)

Image = pytest.importorskip("PIL.Image")


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
    """The port decodes as PIL does, or refuses where PIL refuses."""
    try:
        want = jpre.load_image_bytes(data)
    except Exception:
        with pytest.raises(ValueError):
            tpre.load_image_bytes(data)
        return "refused"
    got = tpre.load_image_bytes(data)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return "decoded"


def _simple(payload):
    return webp_file(webp_chunk(b"VP8L", payload))


def _argb(h, w, seed, levels=256, sparse=0.0):
    """Random coded ARGB pixels: channels of ``levels`` values spread over
    0-255, a ``sparse`` share of pixels zero (flat runs, as a residual
    has)."""
    g = np.random.default_rng(seed)
    ch = g.integers(0, levels, (h, w, 4)) * (255 // max(levels - 1, 1))
    px = (ch[..., 0] << 24 | ch[..., 1] << 16 | ch[..., 2] << 8
          | ch[..., 3]).astype(np.uint32)
    px[g.random((h, w)) < sparse] = 0
    return px


def _tiles(h, w, bits, values):
    """A transform's sub-image: one value per tile of 2^bits."""
    return np.resize(np.asarray(values, np.uint32),
                     (-(-h >> bits), -(-w >> bits)))


def _green(values):
    return np.asarray(values, np.uint32) << 8


def _pil(im, **kw):
    buf = io.BytesIO()
    im.save(buf, "WEBP", **kw)
    return buf.getvalue()


def _photo(h, w, seed):
    g = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(x / 7), 128 + 100 * np.cos(y / 5),
                    (x + y) * 255 / (h + w)], -1) + g.normal(0, 6, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


# -- the transforms ---------------------------------------------------------

@pytest.mark.parametrize("mode", range(16))
def test_predictor_mode_alone(mode):
    """One predictor mode over the whole image (modes 14 and 15 are not
    in the format; libwebp runs them as mode 0), on residuals with flat
    runs and edges, so that Select ties and the clamped modes clamp; the
    top row (L), left column (T) and top-left pixel (black) by the border
    rules, the rightmost pixel's TR the row's first."""
    h, w = 11, 13
    for levels, sparse in ((256, 0.0), (3, 0.6)):
        coded = _argb(h, w, 100 + mode, levels, sparse)
        _same(_simple(vp8l(np, coded, transforms=[
            ("predictor", 2, _tiles(h, w, 2, _green([mode])))])))


@pytest.mark.parametrize("bits", range(2, 10))
def test_predictor_tiles(bits):
    """Random modes in tiles of 2^bits (2 to 9), on an image whose sides
    are no multiple of the tile."""
    h, w = 37, 45
    g = np.random.default_rng(bits)
    modes = _green(g.integers(0, 16, (-(-h >> bits)) * (-(-w >> bits))))
    coded = _argb(h, w, bits, 5, 0.3)
    _same(_simple(vp8l(np, coded, transforms=[
        ("predictor", bits, _tiles(h, w, bits, modes))])))


@pytest.mark.parametrize("h,w", [(1, 1), (1, 17), (17, 1), (2, 2), (3, 1)])
def test_predictor_borders(h, w):
    """Single rows and columns: the border rules alone."""
    coded = _argb(h, w, h * 31 + w)
    _same(_simple(vp8l(np, coded, transforms=[
        ("predictor", 2, _tiles(h, w, 2, _green(range(16))))])))


@pytest.mark.parametrize("bits", [2, 3, 6])
def test_cross_colour(bits):
    """Cross-colour multipliers of both signs (-128 to 127 as signed
    bytes), alone and under the predictor and subtract-green."""
    h, w = 23, 29
    g = np.random.default_rng(50 + bits)
    n = (-(-h >> bits)) * (-(-w >> bits))
    mult = g.integers(0, 1 << 24, n).astype(np.uint32)
    mult[0] = 0x80FF81                 # -128, -1, -127
    cross = ("cross_colour", bits, _tiles(h, w, bits, mult))
    coded = _argb(h, w, 60 + bits)
    _same(_simple(vp8l(np, coded, transforms=[cross])))
    _same(_simple(vp8l(np, coded, transforms=[
        ("subtract_green",), cross,
        ("predictor", 3, _tiles(h, w, 3, _green([11, 12, 13, 5])))])))


def test_subtract_green():
    _same(_simple(vp8l(np, _argb(19, 21, 70), transforms=[
        ("subtract_green",)])))


# (colours, width): bundles of 8, 4, 2 and 1 pixels a byte, at widths
# that leave the last byte part-filled
PALETTES = [(2, 13), (3, 11), (4, 7), (16, 9), (17, 5), (256, 6), (1, 3),
            (5, 1)]


@pytest.mark.parametrize("n,w", PALETTES)
def test_colour_indexing(n, w):
    """The palette delta-coded, the indices bundled in green, the first
    in the low bits; an index past the palette (up to what the bundle
    width holds) gives transparent black, which is RGB 0."""
    h = 7
    g = np.random.default_rng(n)
    bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
    per = 8 >> bits
    top = 1 << per
    for hi in (n, top):                 # in range, then past the palette
        idx = g.integers(0, hi, (h, w))
        pw = -(-w >> bits)
        full = np.zeros((h, pw << bits), np.uint32)
        full[:, :w] = idx
        packed = np.zeros((h, pw), np.uint32)
        for k in range(1 << bits):
            packed |= full[:, k::1 << bits] << (k * per)
        palette = g.integers(0, 1 << 32, n, dtype=np.uint64).astype(
            np.uint32)
        _same(_simple(vp8l(np, _green(packed) | 0xFF000000, size=(w, h),
                           transforms=[("colour_indexing", palette)])))


def test_colour_indexing_then_predictor():
    """Transforms read after colour indexing work at the packed width
    (undone before it); those read before, at the full width (after it)."""
    h, w = 9, 14
    g = np.random.default_rng(80)
    pal = g.integers(0, 1 << 32, 4, dtype=np.uint64).astype(np.uint32)
    packed = _argb(h, -(-w >> 2), 81)
    modes = _tiles(h, 4, 2, _green([1, 11, 13]))
    _same(_simple(vp8l(np, packed, size=(w, h), transforms=[
        ("colour_indexing", pal), ("predictor", 2, modes),
        ("subtract_green",)])))
    _same(_simple(vp8l(np, packed, size=(w, h), transforms=[
        ("predictor", 2, _tiles(h, w, 2, _green([12, 4]))),
        ("colour_indexing", pal)])))


# -- the colour cache, the meta codes, the prefix codes ----------------------

@pytest.mark.parametrize("cache_bits", [1, 4, 11])
def test_colour_cache(cache_bits):
    """Hits of a cache of 2^bits entries (the hash 0x1e35a7bd * argb),
    every pixel inserted, literal or copied; in the sub-images too."""
    h, w = 24, 31
    coded = _argb(h, w, 90 + cache_bits, levels=3)
    _same(_simple(vp8l(np, coded, cache_bits=cache_bits, min_match=5)))
    _same(_simple(vp8l(np, coded, cache_bits=cache_bits,
                       sub_cache_bits=cache_bits, transforms=[
                           ("predictor", 2, _tiles(h, w, 2, _green(
                               [0, 1, 2, 11])))])))


@pytest.mark.parametrize("bits,groups", [(2, 5), (3, 3), (5, 2), (9, 1)])
def test_meta_codes(bits, groups):
    """An entropy image of ``groups`` prefix-code groups in blocks of
    2^bits, the group in green and red; a group index that skips values
    (the skipped groups' codes are read, and unused)."""
    h, w = 33, 27
    g = np.random.default_rng(bits)
    shape = (-(-h >> bits), -(-w >> bits))
    coded = _argb(h, w, 95 + bits, levels=6)
    ids = g.integers(0, groups, shape)
    _same(_simple(vp8l(np, coded, meta=(bits, ids), cache_bits=3)))
    _same(_simple(vp8l(np, coded, meta=(bits, ids * 3 + 256))))


@pytest.mark.parametrize("what", ["one_symbol", "two_symbols",
                                  "first_symbol_1bit", "normal_one_symbol",
                                  "no_repeats", "no_max_symbol"])
def test_prefix_codes(what):
    """Simple codes (one symbol, in no bits; two; the first symbol in 1
    bit or 8), a normal code of one symbol (no bits), normal codes without
    repeat codes or without ``max_symbol``."""
    g = np.random.default_rng(7)
    kw = {}
    if what == "one_symbol":
        coded = np.full((5, 9), 0xFF102030, np.uint32)
    elif what == "two_symbols":
        coded = np.where(g.random((9, 7)) < 0.5, 0xFF102030,
                         0xFF102130).astype(np.uint32)
    elif what == "first_symbol_1bit":
        coded = np.where(g.random((9, 7)) < 0.5, 0x01000100,
                         0x01000000).astype(np.uint32)
    elif what == "normal_one_symbol":
        coded = np.full((5, 9), 0xFF102030, np.uint32)
        kw = {"codes": {"normal": True}}
    else:
        coded = _argb(17, 19, 8, levels=40)
        kw = {"codes": {"rle": False} if what == "no_repeats"
              else {"max_symbol": False}}
    _same(_simple(vp8l(np, coded, distances=(), **kw)))
    _same(_simple(vp8l(np, coded, **kw)))


@pytest.mark.parametrize("w", [1, 2, 3, 8, 16])
def test_distance_map(w):
    """Each of the 120 short distance codes alone, on images narrow enough
    that dy * width + dx falls below 1 (read as 1) or runs back rows."""
    coded = _argb(-(-200 // w), w, w, levels=2)
    for code in range(1, 121):
        _same(_simple(vp8l(np, coded, distances=[code], min_match=1)))


def test_plain_distances_and_long_copies():
    """Plain distances (code - 120), copies that overlap themselves (a run
    of one pixel at distance 1) up to the longest length, 4096."""
    flat = np.full((70, 100), 0xFF405060, np.uint32)
    flat[30:33, 10:60] = _argb(3, 50, 11, levels=4)
    _same(_simple(vp8l(np, flat, distances=[1, 121, 130])))
    _same(_simple(vp8l(np, _argb(20, 20, 12, levels=2),
                       distances=range(121, 300), min_match=2)))


@pytest.mark.parametrize("seed", range(16))
def test_random_streams(seed):
    """Random streams of everything together: size, which transforms in
    which order, cache sizes, meta codes, code options, distances."""
    g = np.random.default_rng(1000 + seed)
    h, w = (int(v) for v in g.integers(1, 40, 2))
    transforms, width = [], w
    for kind in g.permutation(["predictor", "cross_colour",
                               "subtract_green", "colour_indexing"]):
        if g.random() < 0.5:
            continue
        if kind == "colour_indexing":
            n = int(g.integers(1, 257))
            bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
            transforms.append((kind, g.integers(0, 1 << 32, n,
                                                dtype=np.uint64)))
            width = -(-width >> bits)
        elif kind == "subtract_green":
            transforms.append((kind,))
        else:
            bits = int(g.integers(2, 10))
            sub = _argb(-(-h >> bits), -(-width >> bits), seed + 5)
            transforms.append((kind, bits, sub))
    meta = None
    if g.random() < 0.5:
        bits = int(g.integers(2, 6))
        meta = (bits, g.integers(0, 4, (-(-h >> bits), -(-width >> bits))))
    coded = _argb(h, width, seed, levels=int(g.integers(2, 257)),
                  sparse=g.random() / 2)
    _same(_simple(vp8l(
        np, coded, size=(w, h), transforms=transforms, meta=meta,
        cache_bits=int(g.integers(0, 12)),
        sub_cache_bits=int(g.integers(0, 12)),
        distances=g.choice(np.arange(1, 400), int(g.integers(0, 30)),
                           replace=False).tolist(),
        min_match=int(g.integers(1, 5)),
        codes={"normal": bool(g.random() < 0.3),
               "max_symbol": bool(g.random() < 0.5),
               "rle": bool(g.random() < 0.7)})))


# -- PIL's files and the containers -----------------------------------------

PIL_IMAGES = ["photo", "palette", "grey", "rgba_exact"]


def _pil_image(kind):
    img = _photo(37, 53, 3)
    if kind == "palette":
        return Image.fromarray(img).quantize(29)
    if kind == "grey":                  # opens as RGB, not as a 2-D "L"
        return Image.fromarray(img[:, :, 0])
    if kind == "rgba_exact":            # the RGB under alpha 0 kept
        alpha = np.random.default_rng(4).integers(0, 256, img.shape[:2])
        alpha[::3] = 0
        return Image.fromarray(np.dstack([img, alpha.astype(np.uint8)]))
    return Image.fromarray(img)


@pytest.mark.parametrize("method", [0, 4, 6])
@pytest.mark.parametrize("kind", PIL_IMAGES)
def test_pil_lossless_files(kind, method):
    data = _pil(_pil_image(kind), lossless=True, method=method, exact=True)
    assert data[12:16] == b"VP8L"
    got = _same(data)
    assert got.ndim == 3


@pytest.mark.parametrize("extra", [{"icc_profile": b"\x01" * 131},
                                   {"exif": b"Exif\0\0II*\0" + bytes(20)},
                                   {"xmp": b"<x:xmpmeta/>"},
                                   {"icc_profile": b"icc", "exif": b"Exif\0\0",
                                    "xmp": b"<x/>"}])
def test_pil_extended_files(extra):
    """VP8X files: the ICCP, EXIF and XMP chunks skipped."""
    data = _pil(Image.fromarray(_photo(21, 17, 5)), lossless=True, **extra)
    assert data[12:16] == b"VP8X"
    _same(data)


def test_pil_animated_file():
    """The first frame of PIL's animation."""
    frames = [Image.fromarray(_photo(19, 23, s)) for s in (6, 7, 8)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", lossless=True, save_all=True,
                   append_images=frames[1:], duration=50)
    data = buf.getvalue()
    assert b"ANMF" in data
    _same(data)


def _frame(h, w, seed):
    return webp_chunk(b"VP8L", vp8l(np, _argb(h, w, seed)))


CONTAINERS = {
    # an animation's first frame at an offset on a larger canvas: the rest
    # transparent black, ANIM's background unused
    "anim_offset": lambda: webp_file(
        webp_vp8x(20, 16, 0x12), webp_anim(0xFF336699),
        webp_anmf(4, 6, 9, 5, _frame(5, 9, 1)),
        webp_anmf(0, 0, 20, 16, _frame(16, 20, 2))),
    "anim_whole_canvas": lambda: webp_file(
        webp_vp8x(9, 5, 0x02), webp_anim(), webp_anmf(0, 0, 9, 5,
                                                      _frame(5, 9, 3))),
    # the ANMF header's size is not the frame's: the image chunk's is
    "anim_anmf_size_unlike_frame": lambda: webp_file(
        webp_vp8x(20, 16, 0x02), webp_anim(),
        webp_anmf(2, 2, 3, 3, _frame(5, 9, 4))),
    # a lossy second frame: only the first is decoded
    "anim_lossy_second_frame": lambda: webp_file(
        webp_vp8x(17, 17, 0x02), webp_anim(),
        webp_anmf(0, 0, 9, 5, _frame(5, 9, 5)),
        webp_anmf(0, 0, 16, 16, _pil_chunks(
            _pil(Image.fromarray(_photo(16, 16, 9))))[0])),
    "vp8x_unknown_chunks": lambda: webp_file(
        webp_vp8x(9, 5, 0x2C), webp_chunk(b"ICCP", b"abc"),
        webp_chunk(b"ZZZZ", b"hello"), _frame(5, 9, 6),
        webp_chunk(b"EXIF", b""), webp_chunk(b"XMP ", b"x")),
    "vp8x_alpha_flag": lambda: webp_file(webp_vp8x(9, 5, 0x10),
                                         _frame(5, 9, 7)),
    # a simple file's chunks after the image: read past, an ALPH dropped
    "simple_trailing_chunks": lambda: webp_file(
        _frame(5, 9, 8), webp_chunk(b"ALPH", b"\0\1"),
        webp_chunk(b"JUNK", b"xyz")),
    # bytes past the RIFF size: ignored
    "trailing_bytes": lambda: webp_file(_frame(5, 9, 10)) + b"garbage!",
    # an odd payload padded to an even size
    "odd_payload": lambda: webp_file(webp_chunk(b"VP8L", vp8l(
        np, np.full((3, 3), 0xFF000000, np.uint32)) + b"\0")),
}


def _pil_chunks(data):
    """The chunks of a WebP file (each with its header and pad byte)."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        n = int.from_bytes(data[pos + 4:pos + 8], "little")
        out.append(data[pos:pos + 8 + n + (n & 1)])
        pos += 8 + n + (n & 1)
    return out


@pytest.mark.parametrize("name", sorted(CONTAINERS))
def test_containers(name):
    got = _same(CONTAINERS[name]())
    if name == "anim_offset":
        assert got.shape == (16, 20, 3)
        assert not got[:6].any() and not got[:, :4].any()


# -- refusals ----------------------------------------------------------------

def test_lossy_agrees_with_pil():
    """Lossy WebP: plain (VP8), with alpha (VP8X, ALPH, VP8), PIL's
    animation whose first frame is lossy and one built here of the RGBA
    file's ALPH and VP8 chunks. The port decodes them as PIL does
    (``test_torch_imgdec_vp8.py`` holds the lossy decoder to PIL in full)."""
    img = _photo(16, 20, 11)
    rgba = Image.fromarray(np.dstack([img, img[:, :, :1]]))
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", save_all=True,
                              append_images=[Image.fromarray(img[::-1])])
    hand = webp_file(webp_vp8x(20, 16, 0x02), webp_anim(),
                     webp_anmf(0, 0, 20, 16, *_pil_chunks(_pil(rgba))[1:]))
    for data in (_pil(Image.fromarray(img)), _pil(rgba), buf.getvalue(),
                 hand):
        assert _same(data).shape == (16, 20, 3)


def test_decompression_bomb_refused():
    """A VP8L header (and a VP8X canvas) past PIL's pixel limit is refused
    before anything is allocated, as PIL refuses it."""
    bw = VP8LBitWriter()
    for v, n in ((0x2F, 8), (16383, 14), (16383, 14), (0, 4)):
        bw.put(v, n)
    bomb = _simple(bw.bytes() + bytes(8))
    canvas = webp_file(webp_vp8x(16000, 16000, 0x02), webp_anim(),
                       webp_anmf(0, 0, 9, 5, _frame(5, 9, 12)))
    for data in (bomb, canvas):
        with pytest.raises(Image.DecompressionBombError):
            jpre.load_image_bytes(data)
        with pytest.raises(ValueError, match="exceeds the limit"):
            tpre.load_image_bytes(data)


def _raw(w, h, body, version=0, pad=b""):
    """A simple WebP of a hand-made VP8L stream: its header, then
    ``body(bw)``."""
    bw = VP8LBitWriter()
    for v, n in ((0x2F, 8), (w - 1, 14), (h - 1, 14), (0, 1), (version, 3)):
        bw.put(v, n)
    body(bw)
    return _simple(bw.bytes() + pad)


def _one(bw, sym):
    """A simple code of one symbol (8-bit form)."""
    for v, n in ((1, 1), (0, 1), (1, 1), (sym, 8)):
        bw.put(v, n)


def _normal(bw, lens):
    """A normal code of the lengths as literals, through a code-length
    code of the 16 literal lengths at 4 bits each, all of it read."""
    order = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
    bw.put(0, 1)
    bw.put(15, 4)
    for s in order:
        bw.put(4 if s < 16 else 0, 3)
    bw.put(0, 1)
    for v in lens:
        bw.code(v, 4)


def _codes(green, dist=0, cache=None):
    """The five codes of a stream: green's lengths (a dict), one symbol
    for the others; ``cache``: its bits after the transform bit."""
    def body(bw):
        bw.put(0, 1)                    # no transform
        if cache is None:
            bw.put(0, 1)
        else:
            bw.put(1, 1)
            bw.put(cache, 4)
        bw.put(0, 1)                    # no meta codes
        lens = [0] * (280 + (1 << cache if cache else 0))
        for s, n in green.items():
            lens[s] = n
        _normal(bw, lens)
        for _ in range(3):
            _one(bw, 255)
        _one(bw, dist)
    return body


def _bits(*values):
    """A stream's body of (value, bits) pairs."""
    def body(bw):
        for v, n in values:
            bw.put(v, n)
    return body


def _pixels(codes, *values):
    """``codes``, then (value, bits) pairs: green symbols of a code of two
    one-bit symbols (the lower 0, the other 1) and extra bits."""
    def body(bw):
        codes(bw)
        _bits(*values)(bw)
    return body


BAD_STREAMS = {
    "signature": lambda: _simple(b"\x2e" + _raw(3, 1, _pixels(
        _codes({0: 1, 1: 1}), (0, 3)))[21:]),
    "version_1": lambda: _raw(3, 1, _pixels(_codes({0: 1, 1: 1}), (0, 3)),
                              version=1),
    "code_incomplete": lambda: _raw(3, 1, _pixels(_codes({0: 1, 1: 2}),
                                                  (0, 3))),
    "code_over_subscribed": lambda: _raw(3, 1, _pixels(
        _codes({0: 1, 1: 1, 2: 1}), (0, 3))),
    "code_all_zero": lambda: _raw(3, 1, _pixels(_codes({}), (0, 3))),
    "cache_bits_0": lambda: _raw(3, 1, _pixels(_codes({0: 1, 1: 1}, cache=0),
                                               (0, 3))),
    "cache_bits_12": lambda: _raw(3, 1, _pixels(_codes({0: 1, 1: 1},
                                                       cache=12), (0, 3))),
    "transform_twice": lambda: _raw(3, 1, _bits((1, 1), (2, 2), (1, 1),
                                                (2, 2), (0, 1))),
    # a copy of 1 at distance code 1 (dy 1: a whole row back) first
    "copy_before_first_pixel": lambda: _raw(2, 2, _pixels(
        _codes({0: 1, 256: 1}, dist=0), (1, 1), (0, 3))),
    # a literal, then a copy of 3 (length symbol 2) into 2 pixels left
    "copy_past_last_pixel": lambda: _raw(3, 1, _pixels(
        _codes({0: 1, 258: 1}, dist=1), (0, 1), (1, 1))),
    "size_unlike_vp8x": lambda: webp_file(webp_vp8x(9, 6), _frame(5, 9, 13)),
}
GOOD_STREAMS = {
    "literals": lambda: _raw(3, 1, _pixels(_codes({0: 1, 1: 1}),
                                           (0b101, 3))),
    "copy_inside": lambda: _raw(3, 1, _pixels(_codes({0: 1, 257: 1},
                                                     dist=1), (0, 1),
                                              (1, 1))),
    "cache_hit": lambda: _raw(3, 1, _pixels(_codes({0: 1, 281: 1}, cache=1),
                                            (0, 1), (1, 1), (1, 1))),
}


@pytest.mark.parametrize("name", sorted(BAD_STREAMS))
def test_bad_streams_refused(name):
    _both_refuse(BAD_STREAMS[name]())


@pytest.mark.parametrize("name", sorted(GOOD_STREAMS))
def test_hand_made_streams(name):
    """The hand-made streams that ``BAD_STREAMS`` break, unbroken."""
    _same(GOOD_STREAMS[name]())


def test_container_faults():
    """Container faults as libwebp's demuxer and WebPGetFeatures see them:
    refused where PIL refuses, read where it reads."""
    frame = _frame(5, 9, 14)
    good = webp_file(frame)
    vp8x = webp_vp8x(9, 5)
    cases = [
        good[:-1],                                  # shorter than its RIFF
        good[:4] + (len(good) - 7).to_bytes(4, "little") + good[8:],
        good[:4] + bytes(4) + good[8:],             # RIFF size 0
        good[:16] + (len(frame) - 7).to_bytes(4, "little") + good[20:],
        webp_file(frame, b"abc"),                   # a stub after the image
        webp_file(frame, webp_chunk(b"JUNK", b"x")[:8]),
        webp_file(vp8x),                            # VP8X, no image
        webp_file(webp_chunk(b"VP8X", vp8x[8:] + b"\0\0"), frame),
        webp_file(webp_vp8x(9, 5, 0x40), frame),     # a reserved flag
        webp_file(webp_vp8x(9, 5, 0x02), frame),     # outside ANMF
        webp_file(webp_vp8x(9, 5, 0x02), webp_anmf(0, 0, 9, 5, frame)),
        webp_file(webp_vp8x(9, 5, 0x02), webp_anim()),
        webp_file(webp_vp8x(9, 5, 0x02), webp_anim(),
                  webp_anmf(2, 0, 9, 5, frame)),     # off the canvas
        webp_file(webp_vp8x(9, 5), frame, frame),    # two images
        webp_file(webp_vp8x(9, 5, 0x10), frame, webp_chunk(b"ALPH", b"a")),
        webp_file(vp8x, webp_chunk(b"ALPH", b"a"), frame),
        webp_file(webp_chunk(b"ALPH", b"a"), frame),
        webp_file(vp8x, webp_chunk(b"VP8L", b"\x2f\0\0")),
        webp_file(webp_vp8x(9, 5, 0x02), webp_anim(), webp_anmf(
            0, 0, 9, 5, webp_chunk(b"ALPH", b"a"))),
        webp_file(webp_vp8x(9, 5, 0x02), webp_anim(), webp_anmf(
            0, 0, 9, 5, webp_chunk(b"JUNK", b"abcd")), webp_anmf(
            0, 0, 9, 5, frame)),
    ]
    outcomes = [_agree(data) for data in cases]
    assert "refused" in outcomes and "decoded" in outcomes


# -- corrupt files, files on disk, the smoke run's writer --------------------

def _mutation_seeds():
    photo = Image.fromarray(_photo(13, 17, 20))
    h, w = 11, 14
    return [_pil(photo, lossless=True),
            _pil(photo.quantize(11), lossless=True, method=6),
            _pil(photo, lossless=True, icc_profile=b"icc", exif=b"Exif\0\0"),
            _simple(vp8l(np, _argb(h, w, 21, levels=4), cache_bits=4,
                         meta=(2, np.arange(12).reshape(3, 4) % 3),
                         transforms=[("subtract_green",), (
                             "predictor", 2, _tiles(h, w, 2, _green(
                                 range(14)))), ("cross_colour", 3, _tiles(
                                     h, w, 3, [0x80FF81, 0x017F02]))])),
            _simple(vp8l(np, _argb(h, 4, 22, levels=4), size=(w, h),
                         transforms=[("colour_indexing", [1, 2, 3, 4])])),
            CONTAINERS["anim_offset"](), CONTAINERS["vp8x_unknown_chunks"]()]


@pytest.mark.parametrize("seed", range(4))
def test_mutated_webp_agrees_with_pil(seed):
    """Corrupted lossless WebP files (bytes changed, cut, inserted or
    removed, every seed file with every kind): where PIL decodes one, the
    port gives the same array; where PIL refuses it, the port raises
    ValueError (never anything else)."""
    g = np.random.default_rng(300 + seed)
    seeds = _mutation_seeds()
    outcomes = set()
    for i in range(20 * len(seeds)):    # each seed 5 times each kind
        d = bytearray(seeds[i % len(seeds)])
        kind = i // len(seeds) % 4
        if kind == 0:
            for _ in range(int(g.integers(1, 4))):
                d[int(g.integers(0, len(d)))] = int(g.integers(0, 256))
        elif kind == 1:
            d = d[:int(g.integers(1, len(d)))]
        elif kind == 2:
            p = int(g.integers(0, len(d)))
            d = d[:p] + bytes(g.integers(0, 256, int(g.integers(1, 20)),
                                         dtype=np.uint8)) + d[p:]
        else:
            p = int(g.integers(2, len(d)))
            d = d[:p] + d[p + int(g.integers(1, 20)):]
        outcomes.add(_agree(bytes(d)))
    assert outcomes == {"refused", "decoded"}


@pytest.mark.parametrize("cut", [1, 2, 3, 6])
def test_truncated_bitstreams(cut):
    """VP8L payloads cut short inside consistent chunk sizes: the decoder
    reads zeros past the end, and refuses a stream that needs more bits
    than it holds (64 at least), as libwebp's bit reader does."""
    outcomes = set()
    streams = [vp8l(np, _argb(1, 1, 30)),
               vp8l(np, np.full((2, 3), 0xFF000000, np.uint32)),
               vp8l(np, _argb(6, 7, 31, levels=3), cache_bits=2)]
    for s in streams:
        outcomes.add(_agree(_simple(s[:max(1, len(s) - cut)])))
        outcomes.add(_agree(_simple(s.rstrip(b"\0") or s[:1])))
    assert "refused" in outcomes


def test_load_image_reads_webp_files(tmp_path):
    cases = {"pil.webp": _pil(Image.fromarray(_photo(9, 11, 40)),
                              lossless=True),
             "anim.webp": CONTAINERS["anim_offset"]()}
    for name, data in cases.items():
        (tmp_path / name).write_bytes(data)
        got = tpre.load_image(str(tmp_path / name))
        want = jpre.load_image(str(tmp_path / name))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want)


def test_smoke_writer_file_matches_pil():
    """The lossless WebP that chip_smoke.py writes without PIL (subtract-
    green, a colour cache, both kinds of distance): PIL and the port decode
    it to the pixels the writer meant."""
    img = _photo(24, 32, 41) // 32 * 32
    data, want = chip_smoke._webp_bytes(np, img)
    np.testing.assert_array_equal(_same(data), want)
