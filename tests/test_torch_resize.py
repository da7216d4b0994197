"""The port's ``preprocessing.resize_to_bucket`` (Pillow's bilinear
resampler in numpy) bit for bit against the JAX package's, which is PIL's
``Image.resize(..., BILINEAR)``: downscales and upscales on one axis and on
both, to the serving buckets and to odd shapes, and the identity at the
bucket's shape; plus ``bucket_for_shape`` against the JAX package's."""
import numpy as np
import pytest

from insenticap_model_tpu import preprocessing as jpre
from insenticap_model_tpu_torch import preprocessing as tpre

pytest.importorskip("PIL.Image")

SOURCES = [(480, 640), (1000, 1000), (448, 448), (100, 100), (7, 9),
           (1, 1), (300, 200), (512, 384), (33, 2000)]
TARGETS = [(448, 448), (384, 512), (512, 384), (448, 100), (100, 448),
           (17, 23)]


@pytest.mark.parametrize("src", SOURCES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_resize_matches_pil(src):
    g = np.random.default_rng(src[0] * 7 + src[1])
    img = g.integers(0, 256, src + (3,), dtype=np.uint8)
    # both axes, and each axis alone (one pass skipped, as PIL skips it)
    for bucket in TARGETS + [(src[0], 448), (448, src[1])]:
        got = tpre.resize_to_bucket(img, bucket)
        want = jpre.resize_to_bucket(img, bucket)
        assert got.shape == want.shape == tuple(bucket) + (3,)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_resize_smooth_image_matches_pil():
    """A smooth image (where rounding ties between passes are common)."""
    y, x = np.mgrid[0:480, 0:640]
    img = np.stack([x % 256, y % 256, (x + y) % 256], -1).astype(np.uint8)
    for bucket in TARGETS:
        np.testing.assert_array_equal(tpre.resize_to_bucket(img, bucket),
                                      jpre.resize_to_bucket(img, bucket))


def test_resize_identity_at_bucket():
    img = np.random.default_rng(0).integers(0, 256, (384, 512, 3),
                                            dtype=np.uint8)
    assert tpre.resize_to_bucket(img, (384, 512)) is img


@pytest.mark.parametrize("shape", [(480, 640), (640, 480), (500, 500),
                                   (100, 1000), (1000, 100), (383, 511)])
def test_bucket_for_shape_matches(shape):
    for buckets in (tpre.DEFAULT_BUCKET_SHAPES, ((16, 16), (12, 16),
                                                  (16, 12))):
        assert tpre.bucket_for_shape(*shape, buckets) == \
            jpre.bucket_for_shape(*shape, buckets)
