"""The port's GIF and BMP decoders (``preprocessing._decode_gif`` and
``_decode_bmp``, with the LZW and RLE coders in ``csrc/imgdec.cc``) bit
for bit against PIL 12.1 (the JAX package's ``load_image_bytes``), on the
CPU: the same dtype, the same shape (2-D for PIL's "L") and the same
values, or, where PIL refuses a file, a ValueError.

GIF: global and local colour tables, the identity grey ramp and no table
(mode "L"), interlaced and plain rows at heights that leave passes empty,
minimum code sizes 2 to 12, streams that fill the 4096-entry table and
clear it or go on at 12 bits, an end code inside the data (PIL goes on
decoding where the file holds more than its 64 KiB read, and refuses the
file otherwise), a frame at an offset with and without a transparency
index, a frame that grows the screen, extensions and stray bytes, an
animated file (frame 0 only), PIL's own files. BMP: 1, 4 and 8 bits with
PIL's "1", "L" and "P" palette checks, 16 (5-5-5, and bitfields 5-5-5 and
5-6-5), 24 and 32 bits (raw, and every bitfield layout PIL names), RLE8
and RLE4 (encoded and absolute runs, end of line, deltas), headers of 12
to 124 bytes, bottom-up and top-down, PIL's offset and raw-mode quirks,
PIL's own files. The formats PIL opens and the port does not are refused
by name. Corrupted GIFs and BMPs decode as PIL decodes them, or are
refused where PIL refuses them."""
import io
import re
import struct

import numpy as np
import pytest

from insenticap_model_tpu import preprocessing as jpre
from insenticap_model_tpu_torch import preprocessing as tpre

import chip_smoke
from torch_images import gif_blocks, write_bmp, write_gif

Image = pytest.importorskip("PIL.Image")

_G = np.random.default_rng(24)
PAL256 = bytes(_G.integers(0, 256, 768, dtype=np.uint8).tolist())
PAL4 = bytes([10, 20, 30, 40, 50, 60, 70, 80, 90, 100, 110, 120])
RAMP4 = bytes(np.repeat(np.arange(4), 3).astype(np.uint8).tolist())
RAMP256 = bytes(np.repeat(np.arange(256), 3).astype(np.uint8).tolist())
# the 32-bit bitfield layouts PIL names (r, g, b, a masks)
MASKS32 = [(0xFF0000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0),
           (0xFF000000, 0xFF00, 0xFF, 0),
           (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
           (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
           (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
           (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0, 0, 0, 0)]


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


def _idx(h, w, n, seed):
    return np.random.default_rng(seed).integers(0, n, (h, w))


def _pil(im, fmt, **kw):
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _photo(h, w, seed):
    return Image.fromarray(np.random.default_rng(seed).integers(
        0, 256, (h, w, 3), dtype=np.uint8))


def _codes(codes, width):
    """Fixed-width LZW codes, packed as GIF packs them."""
    v = sum(c << (i * width) for i, c in enumerate(codes))
    return v.to_bytes(-(-len(codes) * width // 8), "little")


def _raw_gif(min_size, stream, table=PAL4, w=3, h=2):
    """A GIF of one w x h frame whose image data is ``stream``."""
    return (b"GIF89a" + struct.pack("<HHBBB", w, h, 0x80 | 1, 0, 0) + table
            + b"," + struct.pack("<HHHHB", 0, 0, w, h, 0)
            + bytes([min_size]) + gif_blocks(stream) + b";")


# -- GIF ---------------------------------------------------------------------

_STRAY = (b"!\xfe\x05hello\x03abc\x00"                   # a comment
          b"!\xff\x0bNETSCAPE2.0\x03\x01\x05\x00\x00"    # a loop count
          b"!\x01\x0c" + bytes(12) + b"\x02hi\x00"       # plain text
          b"!\xff\x0bXMP DataXMP\x04abcd\x00"            # an application
          b"\x00\x17")                                   # stray bytes
GIF_CASES = {
    "global_table": lambda: write_gif(_idx(37, 41, 256, 0), table=PAL256),
    "local_table": lambda: write_gif(_idx(37, 41, 256, 1),
                                     local_table=PAL256),
    "local_over_global": lambda: write_gif(_idx(19, 23, 256, 2), table=PAL4,
                                           local_table=PAL256),
    "plain_1x1": lambda: write_gif(_idx(1, 1, 256, 3), table=PAL256),
    "grey_ramp_L": lambda: write_gif(_idx(9, 11, 4, 4), table=RAMP4,
                                     min_size=2),
    "grey_ramp_256_L": lambda: write_gif(_idx(9, 11, 256, 5), table=RAMP256),
    "no_table_L": lambda: write_gif(_idx(9, 11, 4, 6), min_size=2),
    "local_ramp_L": lambda: write_gif(_idx(9, 11, 4, 7), table=PAL4,
                                      local_table=RAMP4, min_size=2),
    "min_size_2": lambda: write_gif(_idx(17, 13, 4, 9), table=PAL4,
                                    min_size=2),
    "min_size_8_four_colours": lambda: write_gif(_idx(17, 13, 4, 10),
                                                 table=PAL4),
    "min_size_12": lambda: write_gif(_idx(5, 7, 256, 11), table=PAL256,
                                     min_size=12),
    "full_table_cleared": lambda: write_gif(_idx(200, 200, 256, 12),
                                            table=PAL256),
    "full_table_kept": lambda: write_gif(_idx(200, 200, 256, 13),
                                         table=PAL256,
                                         clear_when_full=False),
    "full_table_interlaced": lambda: write_gif(_idx(150, 170, 256, 14),
                                               table=PAL256, interlace=True),
    "end_code_inside_a_large_file": lambda: write_gif(
        _idx(300, 300, 256, 15), table=PAL256, end_after=100),
    "index_past_table": lambda: write_gif(np.array([[0, 1, 2, 3],
                                                    [4, 5, 200, 255]]),
                                          table=PAL4),
    "offset_frame": lambda: write_gif(_idx(3, 3, 4, 16), screen=(5, 5),
                                      pos=(1, 1), table=PAL4, min_size=2,
                                      background=2),
    "offset_frame_transparency": lambda: write_gif(
        _idx(3, 3, 4, 16), screen=(5, 5), pos=(1, 1), table=PAL4,
        min_size=2, background=2, transparency=3),
    "offset_frame_transparency_L": lambda: write_gif(
        _idx(3, 4, 4, 17), screen=(7, 6), pos=(2, 1), min_size=2,
        transparency=2),
    "frame_past_screen": lambda: write_gif(_idx(3, 3, 4, 18), screen=(3, 3),
                                           pos=(2, 1), table=PAL4,
                                           min_size=2),
    "frame_on_empty_screen": lambda: write_gif(_idx(3, 4, 4, 19),
                                               screen=(0, 0), table=PAL4,
                                               min_size=2),
    "animated": lambda: write_gif(
        _idx(10, 12, 256, 20), table=PAL256, frames=[
            {"idx": _idx(5, 5, 4, 21), "pos": (2, 2), "transparency": 1,
             "local_table": PAL4, "min_size": 2}]),
    "extensions_and_stray_bytes": lambda: write_gif(
        _idx(10, 12, 256, 22), table=PAL256, extensions=_STRAY),
    "gif87a": lambda: write_gif(_idx(10, 12, 256, 23), table=PAL256,
                                version=b"87a"),
    "pil_P": lambda: _pil(_photo(37, 41, 0).quantize(200), "GIF"),
    "pil_P_transparency": lambda: _pil(_photo(23, 19, 1).quantize(8), "GIF",
                                       transparency=3),
    # PIL writes "L" with a table that is not the ramp, "1" with the ramp
    "pil_L_read_as_P": lambda: _pil(_photo(20, 13, 2).convert("L"), "GIF"),
    "pil_1_read_as_L": lambda: _pil(_photo(20, 13, 3).convert("1"), "GIF"),
    "pil_RGB": lambda: _pil(_photo(31, 33, 4), "GIF"),
    "pil_RGBA": lambda: _pil(_photo(31, 33, 5).convert("RGBA"), "GIF"),
    "pil_plain_small": lambda: _pil(_photo(9, 7, 6).quantize(16), "GIF"),
}
for _h in (1, 2, 3, 4, 5, 8, 9, 17):
    GIF_CASES[f"interlaced_h{_h}"] = (
        lambda h=_h: write_gif(_idx(h, 7, 256, 30 + h), table=PAL256,
                               interlace=True))


@pytest.mark.parametrize("case", list(GIF_CASES))
def test_gif_matches_pil(case):
    got = _same(GIF_CASES[case]())
    assert got.ndim == (2 if case.endswith("_L") else 3)


GIF_REFUSED = {
    "end_code_inside_a_small_file": lambda: write_gif(
        _idx(30, 30, 256, 40), table=PAL256, end_after=50),
    "truncated_image_data": lambda: write_gif(_idx(30, 30, 256, 41),
                                              table=PAL256)[:400],
    "truncated_header": lambda: write_gif(_idx(3, 3, 4, 42), table=PAL4,
                                          min_size=2)[:12],
    "no_image": lambda: b"GIF89a\x03\x00\x02\x00\x81\x00\x00" + PAL4 + b";",
    "first_code_past_clear": lambda: _raw_gif(2, _codes([4, 6, 5], 3)),
    "undefined_code": lambda: _raw_gif(2, _codes([4, 1, 7, 5], 3)),
    "min_size_13": lambda: write_gif(_idx(3, 3, 4, 43), table=PAL4,
                                     min_size=13),
    "empty_frame": lambda: write_gif(np.zeros((0, 3), np.int64),
                                     screen=(3, 3), table=PAL4, min_size=2),
    "empty_screen_and_frame": lambda: write_gif(np.zeros((0, 0), np.int64),
                                                table=PAL4, min_size=2),
    "short_graphic_control": lambda: write_gif(
        _idx(3, 3, 4, 44), table=PAL4, min_size=2,
        extensions=b"!\xf9\x02\x01\x00\x00"),
}


@pytest.mark.parametrize("case", list(GIF_REFUSED))
def test_gif_refused_as_pil_refuses(case):
    _both_refuse(GIF_REFUSED[case]())


# -- BMP ---------------------------------------------------------------------

def _palette(kind, bits, seed):
    n = 1 << bits
    g = np.random.default_rng(seed)
    return {"P": g.integers(0, 256, (n, 3)),
            "P_short": g.integers(0, 256, (max(1, n // 2 + 1), 3)),
            "1": [[0, 0, 0], [255, 255, 255]],
            "L": np.repeat(np.arange(n), 3).reshape(-1, 3),
            "P_off_by_one": [[0, 0, 0], [255, 254, 255]]}[kind]


BMP_CASES = {}
for _hdr in (12, 40, 124):
    for _td in ((False,) if _hdr == 12 else (False, True)):
        _tag = f"h{_hdr}_{'top_down' if _td else 'bottom_up'}"
        for _bits in (1, 4, 8):
            for _kind in ("P", "P_short", "1", "L", "P_off_by_one"):
                if _kind == "L" and _bits != 8:
                    continue
                BMP_CASES[f"{_tag}_{_bits}bit_{_kind}"] = (
                    lambda b=_bits, k=_kind, h=_hdr, t=_td: write_bmp(
                        _idx(13, 21, 1 << b, b), b,
                        palette=_palette(k, b, b), header=h, top_down=t))
        BMP_CASES[f"{_tag}_16bit_555"] = (
            lambda h=_hdr, t=_td: write_bmp(_idx(9, 11, 1 << 16, 50), 16,
                                            header=h, top_down=t))
        BMP_CASES[f"{_tag}_24bit"] = (
            lambda h=_hdr, t=_td: write_bmp(
                np.asarray(_photo(9, 11, 51)), 24, header=h, top_down=t))
        BMP_CASES[f"{_tag}_32bit"] = (
            lambda h=_hdr, t=_td: write_bmp(_idx(9, 11, 1 << 32, 52), 32,
                                            header=h, top_down=t))
for _hdr in (40, 52, 56, 108, 124):
    for _name, _masks in (("555", (0x7C00, 0x3E0, 0x1F)),
                          ("565", (0xF800, 0x7E0, 0x1F))):
        BMP_CASES[f"h{_hdr}_bitfields_{_name}"] = (
            lambda h=_hdr, m=_masks: write_bmp(
                _idx(7, 9, 1 << 16, 53), 16, header=h, compression=3,
                masks=m))
    BMP_CASES[f"h{_hdr}_bitfields_24bit"] = (
        lambda h=_hdr: write_bmp(np.asarray(_photo(7, 9, 54)), 24, header=h,
                                 compression=3,
                                 masks=(0xFF0000, 0xFF00, 0xFF)))
for _i, _masks in enumerate(MASKS32):
    for _hdr in ((40, 124) if _masks[3] == 0 else (124,)):
        BMP_CASES[f"h{_hdr}_bitfields_32bit_layout{_i}"] = (
            lambda h=_hdr, m=_masks: write_bmp(
                _idx(7, 9, 1 << 32, 55), 32, header=h, compression=3,
                masks=m, top_down=True))
# RLE data byte for byte (the palette's 8 or 16 entries random)
RLE = {
    # an encoded run, end of line (padding the row), an absolute run of 5
    # (word aligned), a delta (Pillow skips the two bytes after its
    # escape, then reads right and up), an encoded run cut at the row's
    # end, end of bitmap
    "rle8_delta": (8, 4, 6, [4, 7, 0, 0, 0, 5, 1, 2, 3, 4, 5, 0, 0, 2, 9, 9,
                             2, 1, 6, 3, 0, 0, 3, 6, 0, 1]),
    # rows filled by runs, end of line at a row's end (no padding), runs
    # after a full row (cut to nothing until an end of line)
    "rle8_eol_at_row_end": (8, 3, 4, [4, 1, 0, 0, 2, 2, 2, 3, 5, 4, 0, 0,
                                      3, 5, 0, 0, 0, 1]),
    "rle8_absolute_even": (8, 2, 5, [0, 4, 1, 2, 3, 4, 1, 5, 0, 0, 5, 6,
                                     0, 1]),
    "rle4_runs": (4, 3, 5, [5, 0x12, 0, 0, 3, 0x34, 2, 0x56, 0, 0, 5, 0x78,
                            0, 1]),
    # Pillow reads count // 2 bytes of an absolute run of RLE4
    "rle4_absolute_odd": (4, 2, 6, [0, 5, 0x12, 0x34, 1, 0x5, 0, 0, 6,
                                    0x9A, 0, 1]),
    "rle4_delta": (4, 3, 4, [2, 0x31, 0, 2, 0, 0, 1, 1, 4, 0x45, 0, 0,
                             4, 0x67, 0, 1]),
    # the pixels end without an end of bitmap
    "rle8_no_end_of_bitmap": (8, 2, 3, [3, 1, 0, 0, 3, 2]),
}
for _name, (_bits, _h, _w, _rle) in RLE.items():
    for _td in (False, True):
        BMP_CASES[f"{_name}{'_top_down' if _td else ''}"] = (
            lambda b=_bits, h=_h, w=_w, r=_rle, t=_td: write_bmp(
                np.zeros((h, w)), b, rle=bytes(r), top_down=t,
                compression=1 if b == 8 else 2,
                palette=_palette("P", b, 60)))
BMP_CASES.update({
    "rle8_grey_L": lambda: write_bmp(np.zeros((4, 6)), 8,
                                     rle=bytes(RLE["rle8_delta"][3]),
                                     compression=1,
                                     palette=_palette("L", 8, 0)),
    # an absolute run of 3 from an odd offset ends on an even position:
    # no padding byte follows it
    "rle8_odd_offset": lambda: write_bmp(
        np.zeros((2, 5)), 8, rle=bytes([0, 3, 1, 2, 3, 2, 4, 0, 0, 5, 6, 0,
                                        1]),
        compression=1, palette=_palette("P", 3, 61),
        offset=14 + 40 + 32 + 1),
    "rle8_photo": lambda: write_bmp(
        np.zeros((31, 37)), 8, compression=1, palette=chip_smoke._quantised(
            np, np.zeros((1, 1, 3), np.uint8))[1],
        rle=chip_smoke._rle8(np, chip_smoke._quantised(
            np, np.asarray(_photo(31, 37, 62)))[0])),
    # PIL's quirks: a pixel offset just past the header skips 4 bytes an
    # entry (even after a 12-byte header); offset 0 reads right after the
    # palette; a black-and-white palette reads 8-bit rows as mode "1"
    # bits; a 16-entry grey ramp reads 4-bit rows as "L" bytes where the
    # padded row holds them; more than 256 grey entries are still "L"
    "offset_past_header": lambda: write_bmp(_idx(3, 5, 4, 63), 8,
                                            palette=_palette("P", 2, 63),
                                            offset=54),
    "offset_zero": lambda: write_bmp(_idx(3, 5, 4, 64), 8,
                                     palette=_palette("P", 2, 64), offset=0),
    "bw_palette_8bit_rows": lambda: write_bmp(
        _idx(3, 11, 256, 65), 8, palette=_palette("1", 8, 0)),
    "grey_ramp_4bit_rows": lambda: write_bmp(
        _idx(2, 4, 16, 66), 4, palette=np.repeat(np.arange(16), 3).reshape(
            -1, 3)),
    "grey_ramp_512_entries": lambda: write_bmp(
        _idx(3, 5, 256, 67), 8,
        palette=np.repeat(np.arange(512) % 256, 3).reshape(-1, 3)),
    "colour_count_on_24bit": lambda: write_bmp(
        np.asarray(_photo(3, 5, 68)), 24, colors=7),
    "pil_1": lambda: _pil(_photo(19, 23, 70).convert("1"), "BMP"),
    "pil_L": lambda: _pil(_photo(19, 23, 71).convert("L"), "BMP"),
    "pil_P": lambda: _pil(_photo(19, 23, 72).quantize(100), "BMP"),
    "pil_RGB": lambda: _pil(_photo(19, 23, 73), "BMP"),
    "pil_RGBA": lambda: _pil(_photo(19, 23, 74).convert("RGBA"), "BMP"),
})


@pytest.mark.parametrize("case", list(BMP_CASES))
def test_bmp_matches_pil(case):
    got = _same(BMP_CASES[case]())
    assert got.ndim == (2 if "_L" in case or "pil_L" == case
                        or "grey" in case else 3)


BMP_REFUSED = {
    "jpeg_compressed": lambda: write_bmp(np.asarray(_photo(3, 4, 80)), 24,
                                         compression=4),
    "png_compressed": lambda: write_bmp(np.asarray(_photo(3, 4, 81)), 24,
                                        compression=5),
    "compression_6": lambda: write_bmp(np.asarray(_photo(3, 4, 82)), 24,
                                       compression=6),
    "header_20": lambda: (lambda d: d[:14] + struct.pack("<I", 20)
                          + d[18:])(write_bmp(_idx(3, 4, 4, 83), 8,
                                              palette=_palette("P", 2, 83))),
    "bitfields_layout": lambda: write_bmp(
        _idx(3, 4, 1 << 32, 84), 32, header=124, compression=3,
        masks=(0xFF00, 0xFF0000, 0xFF, 0)),
    "bitfields_at_8bit": lambda: write_bmp(
        _idx(3, 4, 4, 85), 8, palette=_palette("P", 2, 85), compression=3,
        masks=(0xFF0000, 0xFF00, 0xFF)),
    "bitfields_masks_cut_off": lambda: write_bmp(
        _idx(3, 4, 1 << 16, 86), 16, compression=3,
        masks=(0xF800, 0x7E0, 0x1F), offset=54)[:60],
    "palette_of_300": lambda: write_bmp(_idx(3, 4, 256, 87), 8,
                                        palette=_palette("P", 8, 87)[:1]
                                        .repeat(300, 0) + 1),
    "colour_count_70000": lambda: write_bmp(_idx(3, 4, 4, 88), 8,
                                            palette=_palette("P", 2, 88),
                                            colors=70000),
    "bit_depth_2": lambda: write_bmp(_idx(3, 4, 4, 89), 2,
                                     palette=_palette("P", 2, 89)),
    "truncated_rows": lambda: write_bmp(np.asarray(_photo(5, 7, 90)),
                                        24)[:-30],
    "truncated_header": lambda: write_bmp(np.asarray(_photo(5, 7, 91)),
                                          24)[:40],
    "zero_width": lambda: (lambda d: d[:18] + struct.pack("<i", 0)
                           + d[22:])(write_bmp(np.asarray(_photo(2, 3, 92)),
                                               24)),
    "grey_ramp_4bit_rows_too_short": lambda: write_bmp(
        _idx(2, 9, 16, 93), 4, palette=np.repeat(np.arange(16), 3).reshape(
            -1, 3)),
    "rle_at_24bit": lambda: write_bmp(np.zeros((2, 4, 3)), 24, compression=1,
                                      rle=bytes([4, 5, 0, 0, 4, 3, 0, 1])),
    "rle_on_bw_palette": lambda: write_bmp(
        np.zeros((2, 4)), 8, compression=1, palette=_palette("1", 8, 0),
        rle=bytes([4, 1, 0, 0, 4, 0, 0, 1])),
    "rle_too_few_pixels": lambda: write_bmp(
        np.zeros((3, 4)), 8, compression=1, palette=_palette("P", 3, 94),
        rle=bytes([4, 5, 0, 0, 4, 3, 0, 1])),
    "rle_runs_past_the_row": lambda: write_bmp(
        np.zeros((2, 4)), 8, compression=1, palette=_palette("P", 3, 95),
        rle=bytes([4, 5, 4, 3, 0, 1])),
    "rle_delta_cut_off": lambda: write_bmp(
        np.zeros((2, 4)), 8, compression=1, palette=_palette("P", 3, 96),
        rle=bytes([2, 5, 0, 2, 1, 0, 1])),
}


@pytest.mark.parametrize("case", list(BMP_REFUSED))
def test_bmp_refused_as_pil_refuses(case):
    _both_refuse(BMP_REFUSED[case]())


def _rle_stream(g, w, h, rle4):
    """Random RLE ops: encoded runs (some past the row), end of line,
    deltas, absolute runs (word aligned), end of bitmap or not."""
    out = bytearray()
    for _ in range(int(g.integers(1, 3 * h + 3))):
        k = int(g.integers(0, 10))
        if k < 5:
            out += bytes([int(g.integers(1, w + 3)), int(g.integers(0, 256))])
        elif k == 5:
            out += b"\0\0"
        elif k == 6:
            out += b"\0\2" + bytes(g.integers(0, 4, 4, dtype=np.uint8)
                                   .tolist())
        else:
            c = int(g.integers(3, w + 4))
            out += bytes([0, c]) + bytes(g.integers(
                0, 16 if rle4 else 8, c // 2 if rle4 else c,
                dtype=np.uint8).tolist())
            out += bytes(len(out) % 2)
    return bytes(out) + (b"\0\1" if g.random() < 0.7 else b"")


@pytest.mark.parametrize("seed", range(4))
def test_random_rle_streams_match_pil(seed):
    """Random RLE8 and RLE4 data over palette, grey-ramp and black-and-
    white tables, bottom-up and top-down, at odd and even offsets: each
    decodes as PIL decodes it, or is refused where PIL refuses it; both
    outcomes occur."""
    g = np.random.default_rng(100 + seed)
    outcomes = set()
    for i in range(60):
        w, h = int(g.integers(1, 9)), int(g.integers(1, 6))
        rle4 = bool(i % 2)
        bits = 4 if rle4 and i % 4 == 1 else 8
        pal = [g.integers(0, 256, (16, 3)),
               np.repeat(np.arange(1 << bits), 3).reshape(-1, 3),
               _palette("1", 8, 0)][int(g.integers(0, 3))]
        data = write_bmp(np.zeros((h, w)), bits, rle=_rle_stream(g, w, h,
                                                                 rle4),
                         compression=2 if rle4 else 1, palette=pal,
                         top_down=i % 3 == 0,
                         offset=None if i % 5 else 14 + 40 + 4 * len(pal)
                         + 1)
        try:
            want = jpre.load_image_bytes(data)
        except Exception:
            with pytest.raises(ValueError):
                tpre.load_image_bytes(data)
            outcomes.add("refused")
            continue
        np.testing.assert_array_equal(tpre.load_image_bytes(data), want)
        assert tpre.load_image_bytes(data).shape == want.shape
        outcomes.add("decoded")
    assert outcomes == {"refused", "decoded"}


# -- corrupt files, files on disk, the smoke run's writers, other formats ---

def _mutation_seeds():
    g = np.random.default_rng(7)
    photo = _photo(19, 23, 8)
    return [_pil(photo.quantize(40), "GIF"), _pil(photo.convert("1"), "GIF"),
            write_gif(g.integers(0, 256, (20, 30)), table=PAL256,
                      interlace=True),
            write_gif(g.integers(0, 4, (3, 3)), screen=(5, 5), pos=(1, 1),
                      table=PAL4, min_size=2, transparency=3),
            write_gif(g.integers(0, 4, (9, 11)), min_size=2),
            _pil(photo, "BMP"), _pil(photo.convert("L"), "BMP"),
            _pil(photo.convert("1"), "BMP"), _pil(photo.quantize(40), "BMP"),
            BMP_CASES["h124_bitfields_565"](),
            BMP_CASES["h124_bitfields_32bit_layout5"](),
            BMP_CASES["h12_bottom_up_24bit"](), BMP_CASES["rle8_delta"](),
            BMP_CASES["rle4_delta"]()]


@pytest.mark.parametrize("seed", range(4))
def test_mutated_gif_and_bmp_agree_with_pil(seed):
    """Corrupted GIFs and BMPs (bytes changed, cut, inserted or removed):
    where PIL decodes one, the port gives the same array; where PIL
    refuses it, the port raises ValueError (never anything else)."""
    g = np.random.default_rng(200 + seed)
    seeds = _mutation_seeds()
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
        try:
            want = jpre.load_image_bytes(bytes(d))
        except Exception:
            with pytest.raises(ValueError):
                tpre.load_image_bytes(bytes(d))
            continue
        got = tpre.load_image_bytes(bytes(d))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_load_image_reads_gif_and_bmp_files(tmp_path):
    """From a path as from bytes (PIL maps an uncompressed BMP from a path
    rather than reading it)."""
    cases = {"p.gif": GIF_CASES["pil_P"](), "l.gif": GIF_CASES["no_table_L"](),
             "p.bmp": BMP_CASES["pil_P"](), "l.bmp": BMP_CASES["pil_L"](),
             "rgb.bmp": BMP_CASES["h40_top_down_24bit"](),
             "rle.bmp": BMP_CASES["rle8_delta"]()}
    for name, data in cases.items():
        (tmp_path / name).write_bytes(data)
        got = tpre.load_image(str(tmp_path / name))
        want = jpre.load_image(str(tmp_path / name))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("what", ["gif", "bmp24", "bmp_rle8"])
def test_smoke_timing_files_match_pil(what):
    """The 448x448 GIF and BMPs that chip_smoke.py times, written from a
    photo's pixels without PIL: PIL and the port decode each to the pixels
    the writer meant."""
    img = np.asarray(_photo(448, 448, 9))
    img = np.clip(img.astype(np.int32) // 64 * 64 + np.arange(448)[:, None,
                                                                None] % 7,
                  0, 255).astype(np.uint8)        # runs, as a photo has
    data, want = {"gif": chip_smoke._gif_bytes,
                  "bmp24": chip_smoke._bmp_bytes,
                  "bmp_rle8": lambda np_, im: chip_smoke._bmp_bytes(
                      np_, im, rle8=True)}[what](np, img)
    np.testing.assert_array_equal(_same(data), want)


# every format PIL writes here, opens again, and the port refuses by name
# (TGA, which has no signature, shares CUR's first bytes; TIFF under a
# compression the port does not read yet, LZMA)
NAMED = [("TIFF", "1", "TIFF"), ("PPM", "RGB", "PPM"), ("PPM", "L", "PPM"),
         ("PPM", "1", "PPM"),
         ("ICO", "RGB", "ICO"), ("JPEG2000", "RGB", "JPEG 2000"),
         ("QOI", "RGB", "QOI"), ("DDS", "RGB", "DDS"),
         ("ICNS", "RGB", "ICNS"), ("SGI", "RGB", "SGI"),
         ("PCX", "RGB", "PCX"), ("AVIF", "RGB", "AVIF"),
         ("IM", "RGB", "IM"), ("XBM", "1", "XBM"), ("MSP", "1", "MSP"),
         ("TGA", "RGB", "CUR or TGA")]


@pytest.mark.parametrize("fmt,mode,name", NAMED,
                         ids=[f"{f}-{m}" for f, m, _ in NAMED])
def test_other_formats_refused_by_name(fmt, mode, name):
    """What PIL decodes and the port does not read yet (ROADMAP queues
    each) is refused with its name, not as a file of no known format."""
    data = _pil(_photo(16, 16, 10).convert(mode), fmt,
                **({"compression": "lzma"} if fmt == "TIFF" else {}))
    assert jpre.load_image_bytes(data).ndim in (2, 3)
    with pytest.raises(ValueError, match="unsupported: " + name):
        tpre.load_image_bytes(data)


# the bytes before a signature that lies past the file's start
_LEAD = {"AVIF": b"\0\0\0\x1c"}
SIGNATURES = [(name, at, p) for name, at, prefixes in tpre._REFUSED
              for p in prefixes]


@pytest.mark.parametrize("name,at,prefix", SIGNATURES,
                         ids=[f"{n}-{p!r}" for n, _, p in SIGNATURES])
def test_refused_signatures_are_pillows(name, at, prefix):
    """Every signature that the port refuses by name is one that a
    Pillow plugin's ``_accept`` takes (IM's plugin has none:
    ``test_other_formats_refused_by_name`` decodes an IM file), and the
    refusal names the format the signature belongs to."""
    Image.init()
    data = _LEAD.get(name, bytes(at)) + prefix + bytes(64)
    assert len(_LEAD.get(name, bytes(at))) == at
    takers = [f for f, (_, accept) in Image.OPEN.items()
              if accept is not None and accept(data)]
    assert takers or name == "IM"
    with pytest.raises(ValueError, match=re.escape("unsupported: " + name)):
        tpre.load_image_bytes(data)
