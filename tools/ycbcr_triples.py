"""Every (Y, Cb, Cr) triple through the port's YCbCr TIFF path against
PIL's: a 4096x4096 page holding each of the 2^24 triples once (1 x 1,
Deflate, strips of 256 rows), under libtiff's default conversion, Rec.
709's YCbCrCoefficients, studio-range ReferenceBlackWhite, and odd
fractions of both; prints one JSON line {setting: whether all 2^24 pixels
equal}. The tier-1 tests hold a sample of 16,384 triples a setting
(``tests/test_torch_imgdec_tiff_ycbcr.py::test_table_sample_matches_pil``).

    python tools/ycbcr_triples.py

It imports both packages and PIL (like the tests), so it is not part of
the port; about 20 s and 1 GB on the CPU.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

SETTINGS = {
    "default": [],
    "rec709": [(529, 5, [2126, 10000, 7152, 10000, 722, 10000])],
    "studio": [(532, 5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])],
    "fractions": [(532, 5, [7, 3, 250, 1, 255, 2, 241, 1, 129, 1, 200, 3]),
                  (529, 5, [1, 3, 1, 2, 1, 6])],
}


def main() -> dict:
    from insenticap_model_tpu import preprocessing as jpre
    from insenticap_model_tpu_torch import preprocessing as tpre
    from torch_images import write_tiff
    v = np.arange(1 << 24, dtype=np.uint32)
    page = np.stack([v >> 16, (v >> 8) & 255, v & 255], -1).astype(
        np.uint8).reshape(4096, 4096, 3)
    out = {}
    for name, tags in SETTINGS.items():
        data = write_tiff(page, 8, 6, compression=8, rows_per_strip=256,
                          ycbcr_subsampling=(1, 1), tags=tags)
        out[name] = bool(np.array_equal(tpre.load_image_bytes(data),
                                        jpre.load_image_bytes(data)))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
