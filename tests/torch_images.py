"""The committed image fixtures of the port's decoders
(``tests/data/torch_images/``): JPEGs and PNGs written by PIL, and
``expected.npz`` holding PIL's decoded arrays (the JAX package's
``load_image_bytes``), for the card's machine, which has no PIL. The
arrays are stored as differences along each row (uint8, wrapping), which
zlib packs to half the size, and an array two fixtures share once
(``SAME_PIXELS``); ``decode_expected`` undoes both.

    python tests/torch_images.py      # rewrites the directory

``tests/test_torch_imgdec.py`` rebuilds them and requires them equal to
what is committed, so that they cannot drift from PIL. The fixtures'
names, their directory and ``decode_expected`` live in ``chip_smoke.py``,
which reads them on the card without this file's PIL and JAX imports."""
import io
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import (FIXTURE_DIR as DIR, FIXTURES, SAME_PIXELS,  # noqa: E402,F401
                        decode_expected)


def _photo(h, w, seed, noise=6.0):
    """A smooth image with some texture: what a camera gives, compressing
    to a few KB."""
    g = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(x / (w / 5.0)),
                    128 + 100 * np.cos(y / (h / 4.0)),
                    (x + y) * 255.0 / (h + w)], -1)
    img += g.normal(0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def build():
    """{file name: bytes} of every fixture, written by PIL."""
    from PIL import Image
    out = {}

    def save(name, im, fmt, **kw):
        buf = io.BytesIO()
        im.save(buf, fmt, **kw)
        out[name] = buf.getvalue()

    small = Image.fromarray(_photo(45, 61, 0))
    save("j444.jpg", small, "JPEG", quality=90, subsampling=0)
    save("j422.jpg", small, "JPEG", quality=75, subsampling=1)
    save("j420_448.jpg", Image.fromarray(_photo(448, 448, 1, 1.0)), "JPEG",
         quality=75, subsampling=2)
    save("grey.jpg", small.convert("L"), "JPEG", quality=80)
    save("rst.jpg", Image.fromarray(_photo(37, 53, 2)), "JPEG", quality=85,
         subsampling=2, restart_marker_blocks=3)
    save("prog.jpg", small, "JPEG", quality=75, progressive=True)
    save("prog420_448.jpg", Image.fromarray(_photo(448, 448, 1, 1.0)),
         "JPEG", quality=75, subsampling=2, progressive=True)
    save("prog_rst.jpg", Image.fromarray(_photo(37, 53, 8)), "JPEG",
         quality=85, subsampling=2, progressive=True,
         restart_marker_blocks=2)
    save("cmyk.jpg", small.convert("CMYK"), "JPEG", quality=75)
    save("rgb.png", Image.fromarray(_photo(33, 47, 3)), "PNG")
    rgba = np.concatenate([_photo(29, 41, 4),
                           _photo(29, 41, 5)[:, :, :1]], -1)
    save("rgba.png", Image.fromarray(rgba), "PNG")
    save("p.png", Image.fromarray(_photo(31, 39, 6)).quantize(37), "PNG")
    return out


def expected(files):
    """PIL's arrays of the decodable fixtures, as the JAX package gives
    them."""
    from insenticap_model_tpu.preprocessing import load_image_bytes
    return {name: load_image_bytes(data) for name, data in files.items()
            if FIXTURES[name] == "decode"}


def npz_bytes(arrays) -> bytes:
    """expected.npz's bytes: each array as its row differences, keyed by
    the file name; a name in ``SAME_PIXELS`` is left to its twin's."""
    for k, v in SAME_PIXELS.items():
        assert np.array_equal(arrays[k], arrays[v]), k
    buf = io.BytesIO()
    np.savez_compressed(buf, **{
        k: np.diff(v.astype(np.int16), axis=1, prepend=0).astype(np.uint8)
        for k, v in sorted(arrays.items()) if k not in SAME_PIXELS})
    return buf.getvalue()


if __name__ == "__main__":
    files = build()
    os.makedirs(DIR, exist_ok=True)
    files["expected.npz"] = npz_bytes(expected(files))
    for name, data in files.items():
        with open(os.path.join(DIR, name), "wb") as f:
            f.write(data)
    print({n: len(d) for n, d in files.items()})
