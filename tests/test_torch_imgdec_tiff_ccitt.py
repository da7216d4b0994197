"""CCITT fax compressions in the port's TIFF decoder (``isc_tiff_fax`` in
``csrc/imgdec.cc``, ``_TiffFax`` in ``preprocessing.py``) bit for bit
against PIL 12.1 with libtiff 4.7 (the JAX package's ``load_image_bytes``
and ``load_image``), on the CPU: the same dtype, shape and values, or,
where PIL refuses a file, a ValueError.

RLE (2), RLEW (32771), Group 3 (3) one- and two-dimensional, with and
without fill bits, and Group 4 (4). PIL's own pages (libtiff's encoder)
in one strip and in several; pages of ``chip_smoke.tiff_fax`` through
``torch_images.tiff_page`` at photometric 0 and 1, fill order 1 and 2,
both byte orders, in strips and in tiles with cropped edges, at widths
of 1 and of more than 8, 64 and 2560 pixels (the shared make-up codes);
``chip_smoke._tiff_fax_bytes`` equal to PIL and to its bits; the eight
orientations; T4Options as libtiff's directory reader reads it; RLEW's
rows aligned to the file's 16-bit words; the rows a Group 4 strip that
ends early leaves as the strip before wrote them (Pillow's buffer); the
refusals PIL shares. Mutated files: bit flips, zeroed and 0xFF tails in
a strip, and bytes changed anywhere, whose answers agree with PIL's or
are refused by name, counted: a strip that libtiff decodes but leaves
rows of unwritten that no strip before wrote (PIL shows what its buffer
held), and a page whose IFD libtiff and Pillow read otherwise."""
import io
import re

import numpy as np
import pytest

from insenticap_model_tpu import preprocessing as jpre
from insenticap_model_tpu_torch import preprocessing as tpre

import chip_smoke
from test_torch_imgdec_tiff import READ_OTHERWISE, _both_refuse, _pil, _same
from torch_images import tiff_page, write_tiff

Image = pytest.importorskip("PIL.Image")

# Pillow's name and T4Options of each coding, and the port's compression
PIL_CODINGS = {"rle": ("tiff_ccitt", None), "rlew": ("tiff_raw_16", None),
               "g3": ("group3", None), "g3-2d": ("group3", 1),
               "g3-uncompressed": ("group3", 2), "g3-fill": ("group3", 4),
               "g3-2d-fill": ("group3", 5), "g4": ("group4", None)}
# the writer's codings: (compression, T4Options)
CODINGS = {"rle": (2, 0), "g3": (3, 0), "g3-2d": (3, 1), "g3-2d-fill": (3, 5),
           "g4": (4, 0)}


def _page(g, h=64, w=96):
    """A document-like page of bits (1 black): white with black blocks
    and strokes."""
    a = np.zeros((h, w), np.uint8)
    for _ in range(h * w // 500 + 1):
        y, x = int(g.integers(0, h)), int(g.integers(0, w))
        a[y:y + int(g.integers(1, 9)), x:x + int(g.integers(1, 30))] = 1
    return a


def _pil_page(bits, coding, fill=1, **kw):
    """PIL's page of ``bits`` (1 black: a mode "1" image white where 0) in
    a coding of ``PIL_CODINGS``, of FillOrder ``fill``."""
    comp, t4 = PIL_CODINGS[coding]
    info = {266: fill} if fill != 1 else {}
    if t4 is not None:
        info[292] = t4
    return _pil(Image.fromarray(bits == 0), compression=comp,
                tiffinfo=info, **kw)


@pytest.mark.parametrize("coding", list(PIL_CODINGS))
def test_pil_pages(coding):
    """PIL's own pages of each coding, in one strip and in strips of 512
    bytes, fill order 1 and 2; where PIL reads back its bits (all but
    RLEW, which libtiff's decoder aligns otherwise than its encoder), the
    port gives them too."""
    a = _page(np.random.default_rng(1))
    for kw in ({}, {"strip_size": 512}, {"fill": 2}):
        data = _pil_page(a, coding, **kw)
        got = _same(data)
        if coding != "rlew":
            np.testing.assert_array_equal(got[:, :, 0], (1 - a) * 255)


@pytest.mark.parametrize("coding", list(CODINGS))
def test_photometric_fill_and_byte_order(coding):
    """The writer's pages at photometric 0 (WhiteIsZero, PIL's "1;I") and
    1, fill order 1 and 2, little- and big-endian."""
    code, t4 = CODINGS[coding]
    a = _page(np.random.default_rng(2), 24, 45)
    for photo in (0, 1):
        for fill in (1, 2):
            for order in ("<", ">"):
                _same(write_tiff(a, 1, photo, order=order, fill_order=fill,
                                 compression=code, t4options=t4))


@pytest.mark.parametrize("coding", list(CODINGS))
def test_strips_and_tiles(coding):
    """Strips of 1 and 3 rows and 16x16 tiles of a 20x35 page (the edge
    tiles cropped), each strip or tile coded afresh; the run arrays and
    Group 3's mode pass from one to the next as in libtiff."""
    code, t4 = CODINGS[coding]
    a = _page(np.random.default_rng(3), 20, 35)
    for layout in ({"rows_per_strip": 1}, {"rows_per_strip": 3},
                   {"tile": (16, 16)}, {"tile": (32, 16)}):
        got = _same(write_tiff(a, 1, 0, compression=code, t4options=t4,
                               **layout))
        np.testing.assert_array_equal(got[:, :, 0], (1 - a) * 255)


@pytest.mark.parametrize("w", [1, 7, 9, 64, 65, 2700])
def test_widths(w):
    """Rows of 1 pixel, either side of a byte and of 64 (a make-up code),
    and past 2560 (the shared make-up codes, 2560 repeated), every
    coding."""
    g = np.random.default_rng(w)
    a = (g.random((5, w)) < 0.3).astype(np.uint8)
    a[:, w // 3:] = a[:, w // 3:] * (g.random((5, 1)) < 0.5)   # long runs
    for code, t4 in CODINGS.values():
        got = _same(write_tiff(a, 1, 0, compression=code, t4options=t4,
                               rows_per_strip=2))
        np.testing.assert_array_equal(got[:, :, 0], (1 - a) * 255)


def test_smoke_writer_matches_pil_and_bits():
    """``chip_smoke._tiff_fax_bytes`` (phase 3e's pages) decodes to its
    bits in PIL and in the port, for every coding it writes."""
    a = _page(np.random.default_rng(4), 40, 53)
    for code, t4 in CODINGS.values():
        data, want = chip_smoke._tiff_fax_bytes(np, a, code, t4)
        np.testing.assert_array_equal(jpre.load_image_bytes(data), want)
        np.testing.assert_array_equal(_same(data), want)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation(orientation, tmp_path):
    """The Orientation tag over Group 4 strips and Group 3 2D tiles, from
    bytes and from a path."""
    a = _page(np.random.default_rng(5), 21, 30)
    for kw in ({"compression": 4, "rows_per_strip": 5},
               {"compression": 3, "t4options": 1, "tile": (16, 16)}):
        data = write_tiff(a, 1, 0, orientation=orientation, **kw)
        _same(data)
        path = tmp_path / "o.tif"
        path.write_bytes(data)
        np.testing.assert_array_equal(tpre.load_image(str(path)),
                                      jpre.load_image(str(path)))


def test_t4options_as_libtiff_reads_it():
    """T4Options of SHORT, LONG and BYTE is read; of two values, or a
    negative SSHORT, libtiff ignores it (one-dimensional): a 2D page then
    decodes as 1D data, as PIL decodes it."""
    a = _page(np.random.default_rng(6), 12, 40)
    for typ, vals in ((3, [1]), (4, [1]), (1, [1]), (4, [1, 1]), (8, [-1]),
                      (4, [0x10001])):
        _same(write_tiff(a, 1, 0, compression=3, t4options=1,
                         tags=[(292, typ, vals)]))


def test_rlew_aligns_to_the_files_words(tmp_path):
    """RLEW (32771) starts each row at a 16-bit word of the file, so its
    strip decodes otherwise at an odd offset: PIL's page at an even and
    an odd one, from bytes and from a path."""
    a = _page(np.random.default_rng(7), 30, 37)
    data = _pil_page(a, "rlew")
    t = Image.open(io.BytesIO(data))
    strip = data[t.tag_v2[273][0]:][:t.tag_v2[279][0]]
    for pad in (b"", b"\0"):
        entries, _ = tiff_page(a, 1, 0, compression=2, tags=[
            (259, 3, [32771]), (273, 4, [8 + len(pad)]),
            (279, 4, [len(strip)])])
        data = chip_smoke.tiff_file([(entries, [pad + strip])])
        _same(data)
        path = tmp_path / "w.tif"
        path.write_bytes(data)
        np.testing.assert_array_equal(tpre.load_image(str(path)),
                                      jpre.load_image(str(path)))


def _strips(code, blocks, bits, rows, photo=1):
    entries, _ = tiff_page(bits, 1, photo, compression=code,
                           rows_per_strip=rows)
    return chip_smoke.tiff_file([(entries, blocks)])


def test_early_end_keeps_the_strip_before():
    """A Group 4 strip that ends early (EOFB, or the end of its data) after
    its first row is no error to libtiff: its other rows keep what the
    strip before left in Pillow's buffer, as the port's do; in the first
    strip they are whatever that buffer held, refused by name. A strip
    that ends before its first row fails, as in PIL."""
    a = _page(np.random.default_rng(8), 8, 21)
    first = chip_smoke.tiff_fax(np, a[:4], 4)
    short = chip_smoke.tiff_fax(np, a[4:5], 4)
    got = _same(_strips(4, [first, short], a, 4))
    np.testing.assert_array_equal(got[4:, :, 0] // 255, np.concatenate(
        [a[4:5], np.zeros((1, 21), np.uint8), a[2:4]]))
    assert jpre.load_image_bytes(_strips(4, [short, first], a, 4)).ndim == 3
    with pytest.raises(ValueError, match=re.escape(tpre._TIFF_FAX_UNWRITTEN)):
        tpre.load_image_bytes(_strips(4, [short, first], a, 4))
    _both_refuse(_strips(4, [first, bytes(2)], a, 4))


def test_refusals_pil_shares():
    """libtiff's Fax3SetupState refuses 2 bits a sample, and Pillow three
    1-bit samples in one plane; a row too wide for the run arrays is
    refused (PIL's limit on pixels comes first)."""
    g = np.random.default_rng(9)
    _both_refuse(write_tiff(g.integers(0, 4, (6, 9)), 2, 1, compression=4))
    _both_refuse(write_tiff(g.integers(0, 2, (6, 9, 3)), 1, 2,
                            compression=4))
    entries, blocks = tiff_page(np.zeros((1, 8), np.uint8), 1, 0,
                                compression=4)
    entries = [e if e[0] != 256 else (256, 4, [(1 << 31) - 1])
               for e in entries]
    _both_refuse(chip_smoke.tiff_file([(entries, blocks)]))


def _mutated(g, coding, trial):
    """One of PIL's pages (one strip, or strips of 512 bytes) with one
    strip's bit flipped, or its tail from a random byte zeroed or set to
    0xFF."""
    data = bytearray(_pil_page(_page(g), coding,
                               **({"strip_size": 512} if trial % 2 else {})))
    t = Image.open(io.BytesIO(bytes(data)))
    k = int(g.integers(len(t.tag_v2[273])))
    at, n = t.tag_v2[273][k], t.tag_v2[279][k]
    if trial % 3 == 0:
        bit = int(g.integers(n * 8))
        data[at + bit // 8] ^= 1 << bit % 8
    else:
        i = at + int(g.integers(n))
        data[i:at + n] = (b"\0" if trial % 3 == 1 else b"\xff") * (at + n - i)
    return bytes(data)


def _outcome(data):
    """Whether PIL decoded the file (the port then equal), or the name of
    the port's refusal where PIL decodes it (``_TIFF_FAX_UNWRITTEN`` or
    ``READ_OTHERWISE``)."""
    try:
        jpre.load_image_bytes(data)
    except Exception:
        _both_refuse(data)
        return False
    try:
        tpre.load_image_bytes(data)
    except ValueError as e:
        for name in (tpre._TIFF_FAX_UNWRITTEN, READ_OTHERWISE):
            if name in str(e):
                return name
        raise
    _same(data)
    return True


# of a hundred mutated pages of each coding, at most as many refused by
# name as PIL shows its buffer for (Group 4 alone leaves rows unwritten)
UNWRITTEN_AT_MOST = {"rle": 0, "rlew": 0, "g3": 0, "g3-2d": 0,
                     "g3-2d-fill": 0, "g4": 45}


@pytest.mark.parametrize("coding", list(UNWRITTEN_AT_MOST))
def test_mutated_strips(coding):
    """A hundred of PIL's pages of a coding, mutated in a strip: bit flips
    (a bad code word, a row of the wrong length, libtiff's recovery), a
    zeroed tail (EOLs, and for Group 3 the retry without EOLs) and a 0xFF
    tail (white runs of 7, black of 2, V0). The port agrees with PIL
    (decoded, or both refuse), or refuses by name a page PIL shows its
    buffer for, no more than ``UNWRITTEN_AT_MOST``."""
    g = np.random.default_rng(10 + list(UNWRITTEN_AT_MOST).index(coding))
    outcomes = [_outcome(_mutated(g, coding, trial)) for trial in range(100)]
    named = sum(o == tpre._TIFF_FAX_UNWRITTEN for o in outcomes)
    assert READ_OTHERWISE not in outcomes
    assert named <= UNWRITTEN_AT_MOST[coding]
    assert outcomes.count(True) >= 30


def test_mutated_anywhere():
    """Bytes changed anywhere in small pages of the writer's (the header,
    the IFD and its values, the strips or tiles), every coding, strips and
    tiles: the port agrees with PIL, or refuses by name (unwritten rows,
    or an IFD that libtiff and Pillow read otherwise), at most one page in
    twenty."""
    g = np.random.default_rng(20)
    outcomes = []
    for trial in range(300):
        code, t4 = list(CODINGS.values())[trial % len(CODINGS)]
        layout = ({"rows_per_strip": 5}, {"tile": (16, 16)})[trial // 5 % 2]
        data = bytearray(write_tiff(_page(g, 18, 21), 1, trial // 10 % 2,
                                    compression=code, t4options=t4,
                                    **layout))
        for _ in range(1 + trial % 3):
            data[int(g.integers(8, len(data)))] = int(g.integers(0, 256))
        outcomes.append(_outcome(bytes(data)))
    assert sum(isinstance(o, str) for o in outcomes) <= 15
    assert outcomes.count(True) >= 100


def test_agree_on_random_streams():
    """Random bytes (dense, sparse in ones, sparse in zeros) as the strips
    or tiles of every coding, 8 x 50 pixels in two strips of four rows or
    four tiles of 32 x 4: whatever libtiff makes of them (in tiles a
    failed decode is no error), as PIL shows it or refuses it, or refused
    by name where PIL shows its buffer."""
    g = np.random.default_rng(21)
    outcomes = []
    for trial in range(80):
        code, t4 = list(CODINGS.values())[trial % len(CODINGS)]
        p = (0.5, 0.1, 0.9)[trial % 3]
        layout = ({"rows_per_strip": 4}, {"tile": (32, 4)})[trial // 5 % 2]
        entries, blocks = tiff_page(np.zeros((8, 50), np.uint8), 1, 0,
                                    compression=code, t4options=t4,
                                    **layout)
        blocks = [np.packbits(g.random(8 * 40) < p).tobytes()
                  for _ in blocks]
        outcomes.append(_outcome(chip_smoke.tiff_file([(entries, blocks)])))
    assert READ_OTHERWISE not in outcomes
    assert outcomes.count(True) >= 40
