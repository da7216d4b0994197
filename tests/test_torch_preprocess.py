"""The port's offline preprocessing (``preprocessing.py``'s offline half and
``cli/preprocess.py``) against the JAX package's on the CPU: every text
stage on the caption datasets and sentiment corpus of
``tests/test_preprocessing.py``'s ``corpus_tree`` (the LMs trained by the
repo's ``isclm``), and feature extraction in both bucket modes at full
ResNet-101 depth on tiny PNGs (and on a CMYK JPEG, an Adam7-interlaced
PNG, GIFs and BMPs, which the port decodes as PIL does), with the same
weights.

Tolerances: every file the text stages write is held byte for byte. The
features within 1e-5 of the output's largest magnitude (f32, sums in
another order through 104 convolutions; ``test_torch_encoder.py``'s
tolerance); the port decodes and resizes the PNGs bit for bit as PIL does
(``test_torch_imgdec.py``, ``test_torch_resize.py``).
"""
import os
import shutil

import numpy as np
import pytest
import torch

from insenticap_model_tpu import preprocessing as jpp
from insenticap_model_tpu.cli import preprocess as jcli
from insenticap_model_tpu_torch import preprocessing as tpp
from insenticap_model_tpu_torch.cli import preprocess as tcli
from insenticap_model_tpu_torch.data.feature_store import open_store
from test_preprocessing import corpus_tree  # noqa: F401 (a fixture)
from torch_images import (make_png, vp8l, webp_anim, webp_anmf, webp_chunk,
                          webp_file, webp_vp8x, write_bmp, write_tiff)
from torch_parity import encoder_params, resnet_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE_TOL = 1e-5
BUCKETS = "64x64,48x64,64x48"        # a tiny ladder for the CPU


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _text_flags(root, who):
    out = os.path.join(root, who)
    return ["--caption_datasets_dir", os.path.join(root, "caption_datasets"),
            "--dataset_names", "coco",
            "--captions_dir", os.path.join(out, "captions"),
            "--corpus_dir", os.path.join(out, "corpus"),
            "--senti_imgs_dir", os.path.join(root, "senti_imgs"),
            "--img_senti_labels", os.path.join(out, "img_senti_labels.json"),
            "--seed", "3"]


def test_text_stages_write_the_jax_files(corpus_tree):  # noqa: F811
    """corpus_all (captions, senti_corpus, idx2concept, idx2word,
    senti_captions, anno, lms), then senti_labels and det_sentiments,
    through each package's CLI on the same inputs."""
    root = str(corpus_tree)
    if not os.path.exists(jpp._isclm_binary() or ""):
        pytest.skip("native/build/isclm is not built (make -C native)")
    os.makedirs(os.path.join(root, "senti_imgs"))
    for senti, n in (("positive", 230), ("negative", 210), ("neutral", 120)):
        for i in range(n):
            open(os.path.join(root, "senti_imgs", f"{senti}_{i}.jpg"),
                 "w").close()
    for who in ("jax", "port"):
        shutil.copytree(os.path.join(root, "corpus"),
                        os.path.join(root, who, "corpus"))
    for who, main in (("jax", jcli.main), ("port", tcli.main)):
        flags = _text_flags(root, who)
        main(["corpus_all", *flags])
        main(["senti_labels", *flags])
        caps = os.path.join(root, who, "captions", "coco")
        concepts = tpp._load(caps, "img_concepts.json")["train"]
        tpp._dump({fn: cs[:3] for fn, cs in concepts.items()}, caps,
                  "img_det_concepts.json")
        main(["det_sentiments", *flags])
    files = _files(os.path.join(root, "jax"))
    assert files == _files(os.path.join(root, "port"))
    for rel in ("captions/coco/part/lm/neutral_w.sri",
                "captions/coco/part/lm/positive_id.sri",
                "captions/coco/part/img_det_sentiments.json",
                "captions/coco/part/senti_captions.json",
                "corpus/part/sentiment_detector.json",
                "img_senti_labels.json"):
        assert rel in files
    for rel in files:
        with open(os.path.join(root, "jax", rel), "rb") as a, \
                open(os.path.join(root, "port", rel), "rb") as b:
            assert a.read() == b.read(), rel


@pytest.fixture(scope="module")
def weights():
    return encoder_params(0)


def _png_dir(d, sizes):
    from PIL import Image
    os.makedirs(d)
    g = np.random.default_rng(0)
    for name, (h, w, mode) in sizes.items():
        arr = g.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
        Image.fromarray(arr).convert(mode).save(os.path.join(d, name))
    return d


def _assert_stores_close(jdir, tdir, names):
    for kind in ("fc", "att"):
        js = open_store(os.path.join(jdir, f"feats_{kind}.isc"))
        ts = open_store(os.path.join(tdir, f"feats_{kind}.isc"))
        assert sorted(ts.keys()) == sorted(js.keys()) == sorted(names)
        want, got = js.batch(sorted(names)), ts.batch(sorted(names))
        assert got.shape == want.shape and np.isfinite(got).all()
        scale = float(np.abs(want).max())
        assert scale > 0
        assert float(np.abs(got - want).max()) <= SCALE_TOL * scale, kind


def test_extract_imgs_feat_exact_mode_matches_jax(weights, tmp_path):
    """Two shapes (one batch of 2, one padded from 1 image), RGB and
    greyscale PNGs, batch size 2."""
    jp, tp = weights
    imgs = _png_dir(str(tmp_path / "imgs"), {
        "img0.png": (64, 72, "RGB"), "img1.png": (64, 72, "L"),
        "img2.png": (72, 64, "RGB")})
    jpp.extract_imgs_feat(imgs, str(tmp_path / "jax"), jp, batch_size=2,
                          store_format="native")
    tpp.extract_imgs_feat(imgs, str(tmp_path / "port"), tp, batch_size=2,
                          device="cpu")
    _assert_stores_close(str(tmp_path / "jax"), str(tmp_path / "port"),
                         ["img0.png", "img1.png", "img2.png"])


def test_preprocess_features_resize_mode_matches_jax(weights, tmp_path):
    """The port's ``preprocess features`` CLI (the ResNet-101 read from a
    reference-named ``.pth``) against the JAX package's function: images
    resized to the three buckets of a tiny ladder, one already at a
    bucket's shape."""
    jp, _ = weights
    imgs = _png_dir(str(tmp_path / "imgs"), {
        "a.png": (64, 64, "RGB"), "b.png": (100, 130, "RGB"),
        "c.png": (130, 100, "L"), "d.png": (64, 64, "RGB")})
    pth = str(tmp_path / "resnet101.pth")
    torch.save({k: torch.from_numpy(v) for k, v in
                resnet_state_dict(0).items()}, pth)
    jpp.extract_imgs_feat(imgs, str(tmp_path / "jax"), jp, batch_size=2,
                          store_format="native", bucket_mode="resize",
                          bucket_shapes=((64, 64), (48, 64), (64, 48)))
    tcli.main(["features", "--imgs_dir", imgs,
               "--feats_dir", str(tmp_path / "port"),
               "--resnet101_file", pth, "--feat_bucket_shapes", BUCKETS,
               "--feat_batch_size", "2", "--device", "cpu"])
    _assert_stores_close(str(tmp_path / "jax"), str(tmp_path / "port"),
                         ["a.png", "b.png", "c.png", "d.png"])


def test_preprocess_features_reads_cmyk_and_interlaced(weights, tmp_path):
    """``preprocess features`` over a folder of one CMYK JPEG and one
    Adam7-interlaced PNG (both refused by the port's decoder before, which
    stopped the whole extraction): the features equal the JAX package's,
    whose PIL reads both."""
    from PIL import Image
    jp, _ = weights
    imgs = tmp_path / "imgs"
    os.makedirs(imgs)
    g = np.random.default_rng(5)
    Image.fromarray(g.integers(0, 256, (70, 90, 3)).astype(np.uint8)
                    ).convert("CMYK").save(imgs / "cmyk.jpg", quality=80)
    (imgs / "adam7.png").write_bytes(make_png(
        g.integers(0, 256, (64, 64, 3)), 8, 2, interlace=1))
    pth = str(tmp_path / "resnet101.pth")
    torch.save({k: torch.from_numpy(v) for k, v in
                resnet_state_dict(0).items()}, pth)
    jpp.extract_imgs_feat(str(imgs), str(tmp_path / "jax"), jp, batch_size=2,
                          store_format="native", bucket_mode="resize",
                          bucket_shapes=((64, 64), (48, 64), (64, 48)))
    tcli.main(["features", "--imgs_dir", str(imgs),
               "--feats_dir", str(tmp_path / "port"),
               "--resnet101_file", pth, "--feat_bucket_shapes", BUCKETS,
               "--feat_batch_size", "2", "--device", "cpu"])
    _assert_stores_close(str(tmp_path / "jax"), str(tmp_path / "port"),
                         ["adam7.png", "cmyk.jpg"])


def test_preprocess_features_reads_gif_and_bmp(weights, tmp_path):
    """``preprocess features`` over a folder of a palette GIF, a grey-ramp
    GIF (PIL's "L"), a 24-bit BMP and an RLE8 BMP (each refused by the
    port's decoder before, which stopped the whole extraction): the
    features equal the JAX package's, whose PIL reads them all."""
    from PIL import Image
    jp, _ = weights
    imgs = tmp_path / "imgs"
    os.makedirs(imgs)
    g = np.random.default_rng(6)
    photo = Image.fromarray(g.integers(0, 256, (70, 90, 3)).astype(np.uint8))
    photo.quantize(64).save(imgs / "p.gif")
    photo.convert("1").save(imgs / "grey.gif")
    photo.save(imgs / "rgb.bmp")
    (imgs / "rle.bmp").write_bytes(write_bmp(
        np.zeros((64, 64)), 8, compression=1,
        palette=g.integers(0, 256, (256, 3)),
        rle=b"".join(bytes([64, int(v), 0, 0]) for v in
                     g.integers(0, 256, 64)) + b"\0\1"))
    pth = str(tmp_path / "resnet101.pth")
    torch.save({k: torch.from_numpy(v) for k, v in
                resnet_state_dict(0).items()}, pth)
    jpp.extract_imgs_feat(str(imgs), str(tmp_path / "jax"), jp, batch_size=2,
                          store_format="native", bucket_mode="resize",
                          bucket_shapes=((64, 64), (48, 64), (64, 48)))
    tcli.main(["features", "--imgs_dir", str(imgs),
               "--feats_dir", str(tmp_path / "port"),
               "--resnet101_file", pth, "--feat_bucket_shapes", BUCKETS,
               "--feat_batch_size", "2", "--device", "cpu"])
    _assert_stores_close(str(tmp_path / "jax"), str(tmp_path / "port"),
                         ["grey.gif", "p.gif", "rgb.bmp", "rle.bmp"])


def test_preprocess_features_reads_lossless_webp(weights, tmp_path):
    """``preprocess features`` over a folder with lossless WebPs (simple,
    VP8X with an ICC profile, and an animation whose first frame lies at
    an offset on its canvas), each refused by the port's decoder before,
    which stopped the whole extraction: the features equal the JAX
    package's, whose PIL reads them all."""
    from PIL import Image
    jp, _ = weights
    imgs = tmp_path / "imgs"
    os.makedirs(imgs)
    g = np.random.default_rng(7)
    photo = Image.fromarray(g.integers(0, 256, (70, 90, 3)).astype(np.uint8))
    photo.save(imgs / "rgb.webp", lossless=True)
    photo.quantize(50).save(imgs / "icc.webp", lossless=True,
                            icc_profile=b"icc")
    frames = [vp8l(np, 0xFF000000 | g.integers(0, 1 << 24, s).astype(
        np.uint32)) for s in ((40, 50), (64, 80))]
    (imgs / "anim.webp").write_bytes(webp_file(
        webp_vp8x(80, 64, 0x02), webp_anim(),
        webp_anmf(10, 6, 50, 40, webp_chunk(b"VP8L", frames[0])),
        webp_anmf(0, 0, 80, 64, webp_chunk(b"VP8L", frames[1]))))
    pth = str(tmp_path / "resnet101.pth")
    torch.save({k: torch.from_numpy(v) for k, v in
                resnet_state_dict(0).items()}, pth)
    jpp.extract_imgs_feat(str(imgs), str(tmp_path / "jax"), jp, batch_size=2,
                          store_format="native", bucket_mode="resize",
                          bucket_shapes=((64, 64), (48, 64), (64, 48)))
    tcli.main(["features", "--imgs_dir", str(imgs),
               "--feats_dir", str(tmp_path / "port"),
               "--resnet101_file", pth, "--feat_bucket_shapes", BUCKETS,
               "--feat_batch_size", "2", "--device", "cpu"])
    _assert_stores_close(str(tmp_path / "jax"), str(tmp_path / "port"),
                         ["anim.webp", "icc.webp", "rgb.webp"])


def test_preprocess_features_reads_lossy_webp(weights, tmp_path):
    """``preprocess features`` over a folder holding a lossy WebP (PIL's,
    quality 80) beside a JPEG: the port's decoder refused it before, which
    stopped the whole extraction; the features equal the JAX package's."""
    from PIL import Image
    jp, _ = weights
    imgs = tmp_path / "imgs"
    os.makedirs(imgs)
    g = np.random.default_rng(8)
    y, x = np.mgrid[0:60, 0:84]
    photo = np.clip(np.stack([128 + 90 * np.sin(x / 9), 128 + 90 * np.cos(
        y / 7), (x + y) * 1.5], -1) + g.normal(0, 8, (60, 84, 3)), 0,
        255).astype(np.uint8)
    Image.fromarray(photo).save(imgs / "lossy.webp", quality=80)
    Image.fromarray(photo[::-1]).save(imgs / "b.jpg", quality=90)
    assert (imgs / "lossy.webp").read_bytes()[12:16] == b"VP8 "
    pth = str(tmp_path / "resnet101.pth")
    torch.save({k: torch.from_numpy(v) for k, v in
                resnet_state_dict(0).items()}, pth)
    jpp.extract_imgs_feat(str(imgs), str(tmp_path / "jax"), jp, batch_size=2,
                          store_format="native", bucket_mode="resize",
                          bucket_shapes=((64, 64), (48, 64), (64, 48)))
    tcli.main(["features", "--imgs_dir", str(imgs),
               "--feats_dir", str(tmp_path / "port"),
               "--resnet101_file", pth, "--feat_bucket_shapes", BUCKETS,
               "--feat_batch_size", "2", "--device", "cpu"])
    _assert_stores_close(str(tmp_path / "jax"), str(tmp_path / "port"),
                         ["b.jpg", "lossy.webp"])


def test_preprocess_features_reads_tiff(weights, tmp_path):
    """``preprocess features`` over a folder holding TIFFs (PIL's
    uncompressed RGB, PackBits palette, LZW (predictor 2) and YCbCr JPEG
    files, the writer's Deflate RGBA with predictor 2 and orientation 6, a
    16-bit grey BigTIFF in tiles and an old-style LZW grey file) beside a
    JPEG:
    the port's decoder refused them before, which stopped the whole
    extraction; the features equal the JAX package's."""
    from PIL import Image
    jp, _ = weights
    imgs = tmp_path / "imgs"
    os.makedirs(imgs)
    g = np.random.default_rng(9)
    photo = g.integers(0, 256, (60, 84, 3)).astype(np.uint8)
    Image.fromarray(photo).save(imgs / "rgb.tif")
    Image.fromarray(photo[::-1]).quantize(60).save(imgs / "p.tif",
                                                   compression="packbits")
    (imgs / "turned.tiff").write_bytes(write_tiff(
        np.dstack([photo[:, ::-1], photo[:, :, :1]]), 8, extra_samples=(2,),
        compression=8, predictor=2, orientation=6))
    (imgs / "grey16.tif").write_bytes(write_tiff(
        g.integers(0, 1 << 16, (50, 70)), 16, bigtiff=True, offset_type=16,
        tile=(32, 32), compression=32773))
    Image.fromarray(photo[::-1, ::-1]).save(
        imgs / "lzw.tif", compression="tiff_lzw", tiffinfo={317: 2})
    (imgs / "old_lzw.tif").write_bytes(write_tiff(
        photo[:, :, 1], 8, compression=5, old_lzw=True, rows_per_strip=7))
    Image.fromarray(photo[:, ::-1]).convert("YCbCr").save(
        imgs / "jpeg.tif", compression="jpeg", quality=75)
    Image.fromarray(photo[:, ::-1]).save(imgs / "b.jpg", quality=90)
    pth = str(tmp_path / "resnet101.pth")
    torch.save({k: torch.from_numpy(v) for k, v in
                resnet_state_dict(0).items()}, pth)
    jpp.extract_imgs_feat(str(imgs), str(tmp_path / "jax"), jp, batch_size=2,
                          store_format="native", bucket_mode="resize",
                          bucket_shapes=((64, 64), (48, 64), (64, 48)))
    tcli.main(["features", "--imgs_dir", str(imgs),
               "--feats_dir", str(tmp_path / "port"),
               "--resnet101_file", pth, "--feat_bucket_shapes", BUCKETS,
               "--feat_batch_size", "2", "--device", "cpu"])
    _assert_stores_close(str(tmp_path / "jax"), str(tmp_path / "port"),
                         ["b.jpg", "grey16.tif", "jpeg.tif", "lzw.tif",
                          "old_lzw.tif", "p.tif", "rgb.tif", "turned.tiff"])


def test_h5_store_is_refused_by_name(tmp_path):
    with pytest.raises(ValueError, match="HDF5"):
        tpp.extract_imgs_feat(str(tmp_path), str(tmp_path / "f"), {},
                              store_format="h5", device="cpu")
    # the CLI refuses before it reads the weights (no file there)
    with pytest.raises(ValueError, match="HDF5"):
        tcli.main(["features", "--store_format", "h5", "--resnet101_file",
                   str(tmp_path / "absent.pth"), "--device", "cpu"])
    assert tcli.build_parser().parse_args(["features"]).store_format == \
        "native"


def test_features_stage_asks_for_the_card(tmp_path):
    pth = str(tmp_path / "resnet101.pth")
    torch.save({}, pth)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcli.main(["features", "--resnet101_file", pth])
