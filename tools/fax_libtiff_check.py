"""The port's CCITT decoder (``preprocessing._TiffFax``, ``isc_tiff_fax``)
against libtiff itself, strip by strip: Pillow's bundled libtiff 4.7
called through ctypes (TIFFOpen, then TIFFReadEncodedStrip or
TIFFReadEncodedTile of every strip or tile, in order, into a buffer
filled with 0x00 and, in a second open, with 0xFF, so that the bits it
leaves unwritten show), on pages of random bytes and on the writer's
pages (``chip_smoke.tiff_fax``) with bits flipped, tails zeroed or set to
0xFF, of every coding (RLE, RLEW, Group 3 1D, 2D and 2D with fill bits,
Group 4), in strips and tiles, widths 1 to 2700. For each strip or tile:
whether libtiff fails it, which bits it writes and their values; the
port must agree on all three (a tile the codec fails is no failure to
TIFFReadEncodedTile). Prints one JSON line of counts by coding; exits 1
on any disagreement, naming the first few.

    python tools/fax_libtiff_check.py [--pages 6000] [--seed 0]

It imports PIL (for its libtiff) and the tests' writers, so it is not
part of the port; about 12 s for 1000 pages on the CPU. The tier-1 tests
hold the same decoder to PIL's arrays
(``tests/test_torch_imgdec_tiff_ccitt.py``).
"""
from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

# name -> (compression, T4Options)
CODINGS = {"rle": (2, 0), "rlew": (32771, 0), "g3": (3, 0),
           "g3-2d": (3, 1), "g3-2d-fill": (3, 5), "g4": (4, 0)}


def libtiff():
    """Pillow's bundled libtiff, its sibling libraries loaded first."""
    import PIL
    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                        "pillow.libs")
    found = glob.glob(os.path.join(libs, "libtiff*.so*"))
    if not found:
        sys.exit(f"no libtiff in {libs}")
    rest = [p for p in glob.glob(os.path.join(libs, "*.so*"))]
    for _ in range(len(rest)):          # in dependency order, by retrying
        for p in list(rest):
            try:
                ctypes.CDLL(p, mode=ctypes.RTLD_GLOBAL)
                rest.remove(p)
            except OSError:
                pass
    lib = ctypes.CDLL(found[0])
    quiet = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_char_p,
                             ctypes.c_void_p)(lambda *a: None)
    lib.TIFFSetErrorHandler(quiet)
    lib.TIFFSetWarningHandler(quiet)
    lib._quiet = quiet
    lib.TIFFOpen.restype = ctypes.c_void_p
    lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.TIFFClose.argtypes = [ctypes.c_void_p]
    for fn in ("TIFFReadEncodedStrip", "TIFFReadEncodedTile"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                     ctypes.c_void_p, ctypes.c_int64]
        getattr(lib, fn).restype = ctypes.c_int64
    return lib


def with_libtiff(lib, path, sizes, tiled, fill):
    """[(return, bytes)] of each strip or tile, its buffer first filled
    with ``fill``."""
    t = lib.TIFFOpen(path.encode(), b"r")
    if not t:
        return None
    read = lib.TIFFReadEncodedTile if tiled else lib.TIFFReadEncodedStrip
    out = []
    for i, size in enumerate(sizes):
        buf = ctypes.create_string_buffer(bytes([fill]) * size, size)
        out.append((read(t, i, buf, size), buf.raw))
    lib.TIFFClose(t)
    return out


def with_port(data, rows, tw):
    """[(failed, reach, bytes)] of each strip or tile: the codec's own
    failure, the bits of each row it writes, the rows."""
    from insenticap_model_tpu_torch import preprocessing as tpre
    t = tpre._Tiff(data)
    lt = tpre._LibTiff(t)
    name = tpre._TIFF_CODECS[lt.compression]
    rowbytes = (tw + 7) // 8
    fax = tpre._TiffFax(lt, name, tw, max(rows), rowbytes)
    out = []
    for i, n in enumerate(rows):
        fax.reach[:] = 0
        chunk = tpre._tiff_fill(lt, i, n * rowbytes)
        err = ctypes.create_string_buffer(256)
        rc = tpre._lib().isc_tiff_fax(
            chunk, len(chunk), fax.buf.ctypes.data, n, rowbytes, tw,
            fax.kind, lt.offsets[i] & 1, fax.runs.ctypes.data, fax.cap,
            fax.nruns, fax.mode.ctypes.data, fax.reach.ctypes.data, err,
            len(err))
        if rc > 1:
            raise RuntimeError(err.value.decode())
        out.append((rc == 1, fax.reach[:n].copy(), fax.buf[:n].copy()))
    return out


def page(g, trial):
    """(coding, file bytes, rows of each strip or tile, tile width)."""
    import chip_smoke
    from torch_images import tiff_page
    coding = list(CODINGS)[trial % len(CODINGS)]
    code, t4 = CODINGS[coding]
    w = int(g.choice([1, 7, 8, 9, 33, 64, 65, 100, 300, 2700]))
    h = int(g.integers(1, 30))
    if g.random() < 0.25:
        tw, tl = int(g.choice([16, 32, 48])), int(g.integers(1, 17))
        layout = {"tile": (tw, tl)}
    else:
        tl = int(g.integers(1, h + 1))
        tw, layout = w, {"rows_per_strip": tl}
    bits = (g.random((h, w)) < g.random() * 0.6).astype(np.uint8)
    entries, blocks = tiff_page(bits, 1, 0, compression=2 if code == 32771
                                else code, t4options=t4, **layout)
    entries = [e if e[0] != 259 else (259, 3, [code]) for e in entries]
    if g.random() < 0.5:                # random bytes
        p = g.random()
        blocks = [np.packbits(g.random(8 * int(g.integers(1, 60))) < p)
                  .tobytes() for _ in blocks]
    else:                               # the writer's, damaged
        blocks = [bytearray(b) for b in blocks]
        b = blocks[int(g.integers(len(blocks)))]
        if b:
            at = int(g.integers(len(b)))
            kind = int(g.integers(3))
            if kind == 0:
                b[at] ^= 1 << int(g.integers(8))
            else:
                b[at:] = (b"\0" if kind == 1 else b"\xff") * (len(b) - at)
        blocks = [bytes(b) or b"\0" for b in blocks]
    data = chip_smoke.tiff_file([(entries, blocks)])
    if "tile" in layout:
        rows = [tl] * len(blocks)
    else:
        rows = [min(tl, h - y) for y in range(0, h, tl)]
    return coding, data, rows, tw, "tile" in layout


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pages", type=int, default=6000)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    lib = libtiff()
    g = np.random.default_rng(a.seed)
    counts = {c: {"strips": 0, "libtiff_fails": 0, "bits_unwritten": 0,
                  "disagree": 0} for c in CODINGS}
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "page.tif")
        for trial in range(a.pages):
            coding, data, rows, tw, tiled = page(g, trial)
            with open(path, "wb") as f:
                f.write(data)
            rowbytes = (tw + 7) // 8
            sizes = [n * rowbytes for n in rows]
            zeros = with_libtiff(lib, path, sizes, tiled, 0)
            ones = with_libtiff(lib, path, sizes, tiled, 255)
            port = with_port(data, rows, tw)
            for i, n in enumerate(rows):
                c = counts[coding]
                c["strips"] += 1
                (rc, b0), (_, b1) = zeros[i], ones[i]
                failed, reach, got = port[i]
                x0, x1, xg = (np.unpackbits(np.frombuffer(b, np.uint8)[
                    :n * rowbytes].reshape(n, rowbytes), 1)[:, :tw]
                    for b in (b0, b1, got.tobytes()))
                written = np.arange(tw)[None, :] < reach[:, None]
                fails = rc == -1
                c["libtiff_fails"] += fails
                c["bits_unwritten"] += bool(not fails and (x0 != x1).any())
                same = fails == (failed and not tiled) and (fails or (
                    np.array_equal(x0 == x1, written)
                    and np.array_equal(xg[written], x0[written])))
                if not same:
                    c["disagree"] += 1
                    bad.append((trial, coding, i))
                if fails:
                    break               # PIL stops at a failed strip
    print(json.dumps({"pages": a.pages, "seed": a.seed, "counts": counts,
                      "first_disagreements": bad[:5]}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
