"""The port's lossy WebP decoder (``preprocessing._decode_webp`` with the
VP8 key frame in ``csrc/imgdec.cc``'s ``isc_vp8_decode`` and the ALPH
chunk's checks) bit for bit against PIL 12.1 with libwebp 1.6 (the JAX
package's ``load_image_bytes``), on the CPU, with no tolerance: the same
dtype, shape (always RGB) and values, or both refuse (the port with
ValueError).

PIL's encoder writes key frames of one kind only (the normal filter at
sharpness 0, no filter deltas, one token partition, absolute segments,
profile 0), so most of the frames here come from the writer of
``tests/torch_images.py`` (``vp8_frame``), which takes every header option
and every macroblock's modes and levels by argument: each intra mode alone
over whole frames (their first row and column, the top-right corner and
the rightmost column), both loop filters at the levels where the
interior limit and the high-edge-variance threshold change, with every
sharpness and filter deltas, 1 to 8 token partitions, odd sizes for the
crop and the upsampler's edges, delta and absolute segments with and
without a map, quantiser deltas, the skip probability, probability
updates, profiles 1-3 and the scale bits, DCT_CAT1-6 levels (with
dequantised values past 16 bits); then PIL's own files at its qualities
and methods, grey and RGB; ALPH chunks raw and VP8L, with each filter and
pre-processing, and the headers libwebp refuses; VP8X with the alpha flag
clear; a lossy first frame on a larger canvas; and mutated and truncated
frames and ALPH chunks, where PIL mostly refuses."""
import glob
import io
import os

import numpy as np
import pytest

from insenticap_model_tpu import preprocessing as jpre
from insenticap_model_tpu_torch import preprocessing as tpre

from torch_images import (B_DC, B_HE, B_TM, B_VE, random_mb, vp8_frame,
                          vp8_tables, vp8l, webp_anim, webp_anmf, webp_chunk,
                          webp_chunks, webp_file, webp_vp8x)

Image = pytest.importorskip("PIL.Image")


def _same(data):
    want = jpre.load_image_bytes(data)
    got = tpre.load_image_bytes(data)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


def _agree(data):
    """The port decodes as PIL does, or refuses (ValueError) where PIL
    refuses."""
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


def _simple(frame):
    return webp_file(webp_chunk(b"VP8 ", frame))


def _mbs(w, h, seed, **kw):
    g = np.random.default_rng(seed)
    return [random_mb(g, **kw) for _ in range(((w + 15) >> 4)
                                              * ((h + 15) >> 4))]


def _pil(im, **kw):
    buf = io.BytesIO()
    im.save(buf, "WEBP", **kw)
    return buf.getvalue()


def _photo(h, w, seed, noise=6.0):
    g = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(x / 7), 128 + 100 * np.cos(y / 5),
                    (x + y) * 255 / (h + w)], -1) + g.normal(0, noise,
                                                             (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


# -- the tables --------------------------------------------------------------

def test_tables_are_libwebps():
    """The decoder's tables (which the writer reads from the same source)
    are libwebp's, byte for byte: each found whole in this host's bundled
    libwebp (the coefficient probabilities and their update probabilities,
    the 4x4 mode probabilities in libwebp's order of the modes, the DC and
    AC quantiser steps, the last as little-endian uint16)."""
    import PIL
    libs = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..",
                                  "pillow.libs", "libwebp-*.so*"))
    if not libs:
        pytest.skip("no bundled libwebp shared object beside PIL")
    blob = open(libs[0], "rb").read()
    tabs = vp8_tables()
    for name, tab in tabs.items():
        dtype = "<u2" if name == "kAcTable" else np.uint8
        assert tab.astype(dtype).tobytes() in blob, name
    assert tabs["kCoeffsProba0"].size == tabs["kCoeffsUpdateProba"].size \
        == 1056


# -- the writer's frames -------------------------------------------------------

MODES = ([("y16", m) for m in (B_DC, B_TM, B_VE, B_HE)]
         + [("b4", m) for m in range(10)]
         + [("uv", m) for m in (B_DC, B_TM, B_VE, B_HE)])


@pytest.mark.parametrize("where,mode", MODES,
                         ids=[f"{w}-{m}" for w, m in MODES])
def test_intra_mode_alone(where, mode):
    """One intra mode in every macroblock (or every 4x4 block) of a frame
    of 3x3 macroblocks cut to 45x41: the first row and column predict from
    libwebp's borders (127 above, 129 left, their corner 127 on the first
    row and 129 below it), DC from what there is, the rightmost column's
    4x4 blocks from the row above's last pixel; with residuals and
    without."""
    for seed, density in ((1, 0.0), (2, 0.4)):
        mbs = _mbs(45, 41, seed, p4=float(where == "b4"), density=density)
        for mb in mbs:
            if where == "y16":
                mb["ymode"] = mode
            elif where == "b4":
                mb["bmodes"] = [mode] * 16
            else:
                mb["uvmode"] = mode
        _same(_simple(vp8_frame(45, 41, mbs, q=20)))


FILTER_LEVELS = (0, 1, 14, 15, 39, 40, 63)


@pytest.mark.parametrize("simple", [0, 1])
@pytest.mark.parametrize("level", FILTER_LEVELS)
def test_loop_filter(simple, level):
    """The simple and the normal loop filter at the levels where the
    high-edge-variance threshold changes (15, 40) and at the ends, with
    sharpness 0 to 7 (the interior limit), on 16x16 and 4x4 macroblocks,
    skipped ones (no inner edges) among them, then with filter deltas that
    push the level past 0 and 63."""
    w, h = 40, 37
    for sharpness in range(8):
        mbs = _mbs(w, h, 10 * level + sharpness, density=0.5)
        _same(_simple(vp8_frame(w, h, mbs, q=60, simple=simple, level=level,
                                sharpness=sharpness, skip_prob=90)))
    for ref, mode in ((-63, 0), (20, 40), (0, -level - 1)):
        mbs = _mbs(w, h, 100 + level + ref, density=0.5)
        _same(_simple(vp8_frame(
            w, h, mbs, q=60, simple=simple, level=level, sharpness=2,
            lf_delta={"update": True, "ref": [ref, 9, None, -9],
                      "mode": [mode, None, 4, None]})))


@pytest.mark.parametrize("partitions", [1, 2, 4, 8])
def test_token_partitions(partitions):
    """1, 2, 4 and 8 token partitions (macroblock row r in partition r mod
    the count), more than the rows included."""
    for w, h in ((33, 80), (20, 20)):
        _same(_simple(vp8_frame(w, h, _mbs(w, h, partitions), q=50,
                                level=20, partitions=partitions)))


SIZES = [(1, 1), (1, 2), (2, 1), (2, 2), (3, 5), (7, 9), (15, 16), (16, 17),
         (17, 33), (33, 17)]


@pytest.mark.parametrize("h,w", SIZES)
def test_odd_sizes(h, w):
    """Sizes that end inside a macroblock and a chroma sample: the crop,
    the upsampler's first and last rows and its last column."""
    _same(_simple(vp8_frame(w, h, _mbs(w, h, h * 100 + w, density=0.6),
                            q=10, level=30)))


_DELTAS = {"update": True, "ref": [5, None, -20, 3],
                  "mode": [-11, 2, None, None]}
HEADERS = {
    "segments_absolute_map": {"segments": {
        "map": [100, None, 30], "data": {"absolute": True,
                                         "quant": [10, None, 127, 60],
                                         "filter": [0, 63, None, 20]}},
        "level": 30},
    "segments_delta_map": {"segments": {
        "map": [None, 200, 1], "data": {"absolute": False,
                                        "quant": [-40, 30, None, 127],
                                        "filter": [-63, 10, 63, None]}},
        "level": 20},
    "segments_delta_no_map": {"segments": {
        "map": None, "data": {"absolute": False, "quant": [5, -5, 0, 0],
                              "filter": [10, 0, 0, 0]}}, "level": 10},
    # segments without data: every quantiser index 0, no filter strength
    "segments_no_data": {"segments": {"map": [50, 50, 50], "data": None},
                         "level": 40},
    # the frame's level 0 turns the filter off whatever the segments say
    "level_0_segment_filter": {"segments": {
        "map": [128, 128, 128], "data": {"absolute": True,
                                         "quant": [30, 40, 50, 60],
                                         "filter": [30, 40, 50, 60]}}},
    "quant_deltas": {"q": 100, "dq": (15, -15, 7, 15, -8)},
    "quant_clipped": {"q": 127, "dq": (15, 15, 15, 15, 15)},
    "quant_zero": {"q": 0, "dq": (-15, -15, -15, -15, -15)},
    "skip_prob": {"skip_prob": 40, "level": 25},
    "skip_prob_zero": {"skip_prob": 0},
    "updates": {"updates": {(t, b, c, p): (7 * t + 13 * b + 29 * c
                                           + 31 * p) % 256
                            for t in range(4) for b in range(8)
                            for c in range(3) for p in range(0, 11, 2)}},
    "lf_delta_kept": {"lf_delta": {"update": False}, "level": 30},
    "lf_delta_mode": {"lf_delta": _DELTAS, "level": 30},
    "profile_1": {"profile": 1}, "profile_2": {"profile": 2},
    "profile_3": {"profile": 3, "level": 20, "simple": 1},
    "scale_bits": {"scale": (3, 1)},
    "colour_space_clamp_refresh": {"colour_space": 1, "clamp_type": 1,
                                   "refresh": 1},
}


@pytest.mark.parametrize("name", sorted(HEADERS))
def test_header_options(name):
    """Each header option PIL's encoder never writes: segments (absolute or
    delta, with and without a map, without data), the quantiser deltas and
    their clipping, the skip probability, coefficient probability updates,
    filter deltas, profiles 1-3 and the scale bits (both ignored, as
    libwebp ignores them), the colour space, clamping and refresh bits."""
    w, h = 37, 35
    _same(_simple(vp8_frame(w, h, _mbs(w, h, len(name), big=0.2),
                            **{"q": 40, **HEADERS[name]})))


@pytest.mark.parametrize("seed", range(8))
def test_random_frames(seed):
    """Every option at random at once: sizes, filters, segments, deltas,
    partitions, skip probability, updates, and levels of every category,
    dequantised past 16 bits (libwebp's SSE2 inverse DCT wraps them)."""
    g = np.random.default_rng(seed)
    w, h = int(g.integers(1, 60)), int(g.integers(1, 60))
    kw = {"q": int(g.integers(0, 128)), "simple": int(g.integers(0, 2)),
          "level": int(g.integers(0, 64)),
          "sharpness": int(g.integers(0, 8)),
          "partitions": int(2 ** g.integers(0, 4)),
          "dq": tuple(int(v) for v in g.integers(-15, 16, 5)),
          "skip_prob": int(g.integers(0, 256)),
          "lf_delta": {"update": True,
                       "ref": [int(g.integers(-63, 64))] * 4,
                       "mode": [int(g.integers(-63, 64))] * 4},
          "segments": {"map": g.integers(0, 256, 3).tolist(),
                       "data": {"absolute": bool(g.integers(0, 2)),
                                "quant": g.integers(-127, 128, 4).tolist(),
                                "filter": g.integers(-63, 64, 4).tolist()}},
          "updates": {tuple(int(v) for v in k): int(g.integers(0, 256))
                      for k in zip(g.integers(0, 4, 40), g.integers(0, 8, 40),
                                   g.integers(0, 3, 40),
                                   g.integers(0, 11, 40))}}
    _same(_simple(vp8_frame(w, h, _mbs(w, h, seed, big=0.3), **kw)))


# -- PIL's files ---------------------------------------------------------------

@pytest.mark.parametrize("quality", [0, 50, 80, 100])
@pytest.mark.parametrize("method", [0, 4, 6])
def test_pil_lossy_files(quality, method):
    """PIL's lossy files at its qualities and methods: RGB, noisy RGB (the
    filter level falls to 0 at quality 100) and grey (which opens as RGB,
    H x W x 3: lossy WebP is always YUV 4:2:0)."""
    img = _photo(37, 53, quality + method)
    for im in (Image.fromarray(img),
               Image.fromarray(_photo(23, 29, method, noise=60)),
               Image.fromarray(img[:, :, 1])):
        data = _pil(im, quality=quality, method=method)
        assert data[12:16] == b"VP8 "
        assert _same(data).shape == im.size[::-1] + (3,)


# -- ALPH ----------------------------------------------------------------------

_W, _H = 23, 19


def _frame():
    return vp8_frame(_W, _H, _mbs(_W, _H, 5), q=30, level=10)


def _with_alph(alph, flags=0x10, frame=None):
    """VP8X (alpha flag by default), ALPH, VP8 of the 23 x 19 frame."""
    return webp_file(webp_vp8x(_W, _H, flags), webp_chunk(b"ALPH", alph),
                     webp_chunk(b"VP8 ", frame or _frame()))


def _alpha_stream(transforms=(), cache_bits=0, seed=0, levels=4, wide=_W):
    """A VP8L image stream of the frame's size without its 5-byte header:
    the alpha in green (coded ``wide`` pixels a row: colour indexing packs
    four 2-bit indices a pixel)."""
    g = np.random.default_rng(seed)
    px = (0xFF000000 | g.integers(0, levels, (_H, wide)).astype(np.uint32)
          << 8)
    return vp8l(np, px, size=(_W, _H), transforms=list(transforms),
                cache_bits=cache_bits)[5:]


ALPHS = {
    **{f"raw_filter{f}": bytes([f << 2]) + bytes(range(256)) * 2
       for f in range(4)},
    "raw_levels": bytes([1 << 4]) + bytes(_W * _H),
    "raw_short": bytes([0]) + bytes(_W * _H - 1),
    "raw_long": bytes([0]) + bytes(_W * _H + 7),
    **{f"vp8l_filter{f}": bytes([1 | f << 2]) + _alpha_stream()
       for f in range(4)},
    "vp8l_levels": bytes([1 | 1 << 4]) + _alpha_stream(),
    # colour indexing alone: libwebp's 8-bit path
    "vp8l_indexed": bytes([1]) + _alpha_stream(
        [("colour_indexing", [0, 1 << 8, 2 << 8, 3 << 8])], levels=256,
        wide=(_W + 3) // 4),
    # other transforms or a colour cache: its 32-bit path
    "vp8l_predictor": bytes([1]) + _alpha_stream(
        [("predictor", 2, np.full((5, 6), 1 << 8, np.uint32))]),
    "vp8l_cache": bytes([1]) + _alpha_stream(cache_bits=3, levels=9),
    **{f"header_{b:#04x}": bytes([b]) + _alpha_stream()
       for b in (2, 3, 0x21, 0x31, 0x41, 0x81, 0xC0)},
    "empty": b"",
    "header_only": bytes([1]),
    "vp8l_garbage": bytes([1]) + bytes(range(7, 250, 3)),
}


@pytest.mark.parametrize("name", sorted(ALPHS))
def test_alph_chunks(name):
    """ALPH chunks of every compression, filter and pre-processing: the
    RGB is the frame's whatever the alpha (libwebp's RGBA is not
    premultiplied); compression 2 or 3, pre-processing past 1, reserved
    bits, an empty chunk, raw data short of the plane and a VP8L stream
    libwebp cannot decode are refused, as PIL refuses them."""
    data = _with_alph(ALPHS[name])
    outcome = _agree(data)
    refused = name.startswith(("header_", "empty", "raw_short")) or name in (
        "header_only", "vp8l_garbage")
    assert outcome == ("refused" if refused else "decoded"), outcome


def test_alph_dropped_without_alpha_flag():
    """A VP8X file whose alpha flag is clear: libwebp's demuxer drops its
    ALPH chunk, so a corrupt one is not read (PIL decodes the file); with
    the flag set it is refused."""
    bad = bytes([1]) + bytes(range(7, 250, 3))
    assert _agree(_with_alph(bad, flags=0)) == "decoded"
    assert _agree(_with_alph(bad, flags=0x10)) == "refused"


@pytest.mark.parametrize("kind", ["alpha_vp8", "vp8_only"])
def test_lossy_first_frame_on_canvas(kind):
    """An animation's lossy first frame (ALPH and VP8, or VP8 alone) at an
    offset on a larger canvas, the rest transparent black; the second
    frame, lossless, not decoded."""
    frame = vp8_frame(17, 13, _mbs(17, 13, 8), q=50, level=12)
    chunks = [webp_chunk(b"VP8 ", frame)]
    if kind == "alpha_vp8":
        chunks.insert(0, webp_chunk(b"ALPH", bytes([1]) + vp8l(
            np, np.full((13, 17), 0xFF00FF00, np.uint32))[5:]))
    data = webp_file(webp_vp8x(30, 24, 0x12), webp_anim(0xFF112233),
                     webp_anmf(10, 8, 17, 13, *chunks),
                     webp_anmf(0, 0, 30, 24, webp_chunk(b"VP8L", vp8l(
                         np, np.full((24, 30), 0xFF123456, np.uint32)))))
    got = _same(data)
    assert got.shape == (24, 30, 3)
    assert not got[:8].any() and not got[:, :10].any()


# -- corrupt frames --------------------------------------------------------------

def _mutation_seeds():
    """({chunk tag: payload}, token partitions) of files to corrupt: PIL's
    (one token partition, segments; with ALPH by its default and its
    method 0) and the writer's (four token partitions, the simple
    filter)."""
    rgba = np.dstack([_photo(40, 44, 1), _photo(40, 44, 2)[:, :, :1]])
    files = [_pil(Image.fromarray(_photo(48, 64, 3)), quality=90),
             _pil(Image.fromarray(_photo(33, 31, 4)), quality=20, method=6),
             _pil(Image.fromarray(rgba)),
             _pil(Image.fromarray(rgba), alpha_quality=50, method=0),
             _simple(vp8_frame(40, 50, _mbs(40, 50, 9, big=0.2), q=40,
                               simple=1, level=30, partitions=4))]
    return [({c[:4].decode().strip(): c[8:8 + int.from_bytes(c[4:8],
                                                               "little")]
              for c in webp_chunks(f)}, 4 if i == 4 else 1)
            for i, f in enumerate(files)]


def _partitions(body, count):
    """[(start, end)] of a VP8 payload's first partition and each of its
    ``count`` token partitions (the last takes the rest)."""
    start = 10 + (int.from_bytes(body[:3], "little") >> 5)
    out, sizes = [(10, start)], start
    start += 3 * (count - 1)
    for k in range(count - 1):
        n = int.from_bytes(body[sizes + 3 * k:sizes + 3 * k + 3], "little")
        out.append((start, start + n))
        start += n
    return out + [(start, len(body))]


def _rebuild(chunks, **repl):
    return webp_file(*[webp_chunk(k.ljust(4).encode(), repl.get(k, v))
                       for k, v in chunks.items()])


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", ["partition0", "tokens", "alph"])
def test_mutated_frames_agree_with_pil(kind, seed):
    """Seeded bit flips (one to three) in partition 0, in the token
    partitions or in the ALPH chunk, of every seed file that has one, the
    chunk sizes kept: where PIL decodes, the port gives the same array
    (a corrupt stream drives libwebp's boolean decoder past its range,
    where its 56-bit loads decide what it reads); where PIL refuses, the
    port raises ValueError, never anything else. The seed and the kind
    vary independently."""
    g = np.random.default_rng(7000 + seed)
    outcomes = set()
    for chunks, parts in _mutation_seeds():
        key = "ALPH" if kind == "alph" else "VP8"
        if key not in chunks:
            continue
        body = chunks[key]
        bounds = _partitions(chunks["VP8"], parts)
        lo, hi = {"partition0": bounds[0], "tokens": (bounds[1][0],
                                                      len(body)),
                  "alph": (0, len(body))}[kind]
        for _ in range(25):
            b = bytearray(body)
            for _ in range(int(g.integers(1, 4))):
                b[int(g.integers(lo, hi))] ^= 1 << int(g.integers(0, 8))
            outcomes.add(_agree(_rebuild(chunks, **{key: bytes(b)})))
    assert outcomes == {"refused", "decoded"}


def test_truncated_frames_agree_with_pil():
    """VP8 payloads cut at every one of their last 16 bytes and inside each
    partition, and ALPH chunks cut, the chunk sizes consistent: libwebp
    reads one zero byte past a partition's end, then fails the first
    partition at the end of a row of modes and a token partition at the
    end of a macroblock; an empty last partition is refused. PIL decodes
    the files cut by one byte and refuses most others; the port agrees on
    every one."""
    outcomes = {}
    for i, (chunks, parts) in enumerate(_mutation_seeds()):
        body = chunks["VP8"]
        cuts = set(range(len(body) - 16, len(body)))
        for lo, hi in _partitions(body, parts):
            cuts |= {lo + (hi - lo) * k // 4 for k in range(1, 4)}
        for cut in sorted(cuts):
            outcomes[i, "VP8", cut] = _agree(
                _rebuild(chunks, VP8=body[:cut]))
        if "ALPH" in chunks:
            alph = chunks["ALPH"]
            for cut in sorted(set(range(max(1, len(alph) - 8), len(alph)))
                              | {len(alph) // 2, 2}):
                outcomes[i, "ALPH", cut] = _agree(
                    _rebuild(chunks, ALPH=alph[:cut]))
    assert {v for (_, k, _), v in outcomes.items() if k == "VP8"} \
        == {"refused", "decoded"}
    assert "refused" in {v for (_, k, _), v in outcomes.items()
                         if k == "ALPH"}


def test_load_image_reads_lossy_files(tmp_path):
    cases = {"pil.webp": _pil(Image.fromarray(_photo(9, 11, 40))),
             "alpha.webp": _pil(Image.fromarray(np.dstack(
                 [_photo(9, 11, 41), _photo(9, 11, 42)[:, :, :1]])))}
    for name, data in cases.items():
        (tmp_path / name).write_bytes(data)
        got = tpre.load_image(str(tmp_path / name))
        want = jpre.load_image(str(tmp_path / name))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want)


def test_alph_8bit_path_reads_past_the_end():
    """libwebp decodes an alpha plane coded with colour indexing alone (no
    cache, one-symbol red, blue and alpha codes) by its 8-bit path, which
    accepts a last symbol that reads past the data; its 32-bit path (any
    other transform) refuses that read. PIL decodes the first stream cut
    by a byte and refuses the second; so does the port."""
    assert _agree(_with_alph(ALPHS["vp8l_indexed"][:-1])) == "decoded"
    assert _agree(_with_alph(ALPHS["vp8l_predictor"][:-1])) == "refused"
