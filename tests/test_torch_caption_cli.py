"""The port's caption command against the JAX package's on the CPU in f32:
the same checkpoints (written by the JAX package's ``checkpoint.save`` at
small decode widths, the ResNet-101 at full depth), the same JPEG and PNG,
auto and forced sentiment, and a GIF and a BMP. The records must be identical apart from the
score (within 1e-4), and the dumped attention maps within 1e-5."""
import json

import numpy as np
import pytest

import jax

from insenticap_model_tpu.cli import caption as jcaption
from insenticap_model_tpu.config import Settings
from insenticap_model_tpu.models import captioner as jcap
from insenticap_model_tpu.models import concept_detector as jcpt
from insenticap_model_tpu.models import sentiment_detector as jsd
from insenticap_model_tpu.training import checkpoint as jck

from insenticap_model_tpu_torch.cli import caption as tcaption

from torch_parity import encoder_params

CATS = ["positive", "negative", "neutral"]
WORDS = ["<PAD>", "<UNK>", "<SOS>", "<EOS>", "dog", "cat", "happy", "sad",
         "runs", "sits", "grass", "sunny"]
CONCEPTS = ["dog", "cat", "runs", "sits", "grass"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    Image = pytest.importorskip("PIL.Image")
    d = tmp_path_factory.mktemp("caption")
    settings = Settings(word_emb_dim=16, fc_feat_dim=2048,
                        att_feat_dim=2048, feat_emb_dim=16, rnn_hid_dim=16,
                        att_hid_dim=16, concept_mid_dim=24)
    comp = {"captioner": jcap.init_params(jax.random.PRNGKey(0), len(WORDS),
                                          3, settings),
            "senti_detector": jsd.init_params(jax.random.PRNGKey(1), 3,
                                              settings)}
    jck.save(str(d / "rl.ckpt"), comp, None, {
        "epoch": 0, "settings": settings.to_dict(), "idx2word": WORDS,
        "sentiment_categories": CATS, "max_seq_len": 8})
    jck.save(str(d / "cpt.ckpt"),
             jcpt.init_params(jax.random.PRNGKey(2), len(CONCEPTS),
                              settings), None,
             {"epoch": 0, "settings": settings.to_dict(),
              "idx2concept": CONCEPTS})
    jck.save(str(d / "resnet.ckpt"), encoder_params(seed=0)[0], None,
             {"epoch": -1})
    (d / "senti.json").write_text(json.dumps(
        {"dog": [["happy", 0.5]], "cat": [["sad", 0.4]],
         "grass": [["sunny", 0.3], ["happy", 0.1]]}))
    g = np.random.default_rng(0)
    y, x = np.mgrid[0:64, 0:64]
    img = np.clip(np.stack([x * 4, y * 4, (x + y) * 2], -1)
                  + g.normal(0, 20, (64, 64, 3)), 0, 255).astype(np.uint8)
    Image.fromarray(img).save(d / "a.jpg", quality=90)
    Image.fromarray(img[::-1]).save(d / "b.png")
    Image.fromarray(img[:, ::-1]).quantize(128).save(d / "c.gif")
    Image.fromarray(img.transpose(1, 0, 2)).save(d / "d.bmp")
    return d


@pytest.mark.parametrize("sentiment", ["auto", "positive"])
def test_caption_run_matches_jax(tree, sentiment, capsys):
    d = tree
    args = ["-i", str(d / "a.jpg"), str(d / "b.png"),
            "--rl_model", str(d / "rl.ckpt"),
            "--concept_model", str(d / "cpt.ckpt"),
            "--resnet101_ckpt", str(d / "resnet.ckpt"),
            "--sentiment_detector_json", str(d / "senti.json"),
            "--sentiment", sentiment, "--max_seq_len", "6",
            "--beam_size", "2", "--num_concepts", "3",
            "--num_sentiments", "4"]
    want = jcaption.run(jcaption.build_parser().parse_args(
        args + ["--dump_attention", str(d / f"jax_{sentiment}")]))
    got = tcaption.run(tcaption.build_parser().parse_args(
        args + ["--dump_attention", str(d / f"port_{sentiment}"),
                "--device", "cpu"]))
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert lines[-2:] == got
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k not in ("score", "attention")
                } == {k: v for k, v in w.items()
                      if k not in ("score", "attention")}
        assert abs(g["score"] - w["score"]) <= 1e-4
        if sentiment != "auto":
            assert g["sentiment"] == sentiment
        ga = np.load(g["attention"], allow_pickle=False)
        wa = np.load(w["attention"], allow_pickle=False)
        assert sorted(ga.files) == sorted(wa.files)
        n_words = len(g["caption"].split())
        assert ga["cont"].shape == (n_words, 14, 14)
        np.testing.assert_array_equal(ga["tokens"], wa["tokens"])
        np.testing.assert_array_equal(ga["words"], wa["words"])
        for k in ga.files:
            if k not in ("tokens", "words"):
                np.testing.assert_allclose(ga[k], wa[k], atol=1e-5, rtol=0)
        np.testing.assert_allclose(ga["cont"].sum((-1, -2)), 1.0, atol=1e-5)


def test_caption_run_reads_gif_and_bmp_as_jax(tree):
    """A GIF and a 24-bit BMP, which the port's decoders refused before
    (stopping the command at the first): the records equal the JAX
    package's, whose PIL reads both."""
    d = tree
    args = ["-i", str(d / "c.gif"), str(d / "d.bmp"),
            "--rl_model", str(d / "rl.ckpt"),
            "--concept_model", str(d / "cpt.ckpt"),
            "--resnet101_ckpt", str(d / "resnet.ckpt"),
            "--sentiment_detector_json", str(d / "senti.json"),
            "--max_seq_len", "6", "--beam_size", "2", "--num_concepts", "3",
            "--num_sentiments", "4"]
    want = jcaption.run(jcaption.build_parser().parse_args(args))
    got = tcaption.run(tcaption.build_parser().parse_args(
        args + ["--device", "cpu"]))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "score"} == \
            {k: v for k, v in w.items() if k != "score"}
        assert abs(g["score"] - w["score"]) <= 1e-4


def test_caption_run_reads_lossless_webp_as_jax(tree, tmp_path):
    """Lossless WebPs (a simple RGBA file, whose RGB under alpha is kept,
    and a VP8X file with an ICC profile), which the port's decoders
    refused before: the records equal the JAX package's."""
    from PIL import Image
    d = tree
    img = np.asarray(Image.open(d / "b.png"))
    Image.fromarray(np.dstack([img, img[:, :, :1]])).save(
        tmp_path / "e.webp", lossless=True, exact=True)
    Image.fromarray(img[:, ::-1]).save(tmp_path / "f.webp", lossless=True,
                                       icc_profile=b"icc")
    args = ["-i", str(tmp_path / "e.webp"), str(tmp_path / "f.webp"),
            "--rl_model", str(d / "rl.ckpt"),
            "--concept_model", str(d / "cpt.ckpt"),
            "--resnet101_ckpt", str(d / "resnet.ckpt"),
            "--sentiment_detector_json", str(d / "senti.json"),
            "--max_seq_len", "6", "--beam_size", "2", "--num_concepts", "3",
            "--num_sentiments", "4"]
    want = jcaption.run(jcaption.build_parser().parse_args(args))
    got = tcaption.run(tcaption.build_parser().parse_args(
        args + ["--device", "cpu"]))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "score"} == \
            {k: v for k, v in w.items() if k != "score"}
        assert abs(g["score"] - w["score"]) <= 1e-4


def test_caption_run_reads_lossy_webp_as_jax(tree, tmp_path):
    """A lossy RGBA WebP (VP8X, ALPH, VP8; PIL's default quality), which
    the port's decoders refused before: the record equals the JAX
    package's."""
    from PIL import Image
    d = tree
    img = np.asarray(Image.open(d / "b.png"))
    Image.fromarray(np.dstack([img, img[:, :, 1:2]])).save(
        tmp_path / "g.webp")
    assert (tmp_path / "g.webp").read_bytes()[12:16] == b"VP8X"
    args = ["-i", str(tmp_path / "g.webp"), "--rl_model", str(d / "rl.ckpt"),
            "--concept_model", str(d / "cpt.ckpt"),
            "--resnet101_ckpt", str(d / "resnet.ckpt"),
            "--sentiment_detector_json", str(d / "senti.json"),
            "--max_seq_len", "6", "--beam_size", "2", "--num_concepts", "3",
            "--num_sentiments", "4"]
    want = jcaption.run(jcaption.build_parser().parse_args(args))
    got = tcaption.run(tcaption.build_parser().parse_args(
        args + ["--device", "cpu"]))
    assert len(got) == len(want) == 1
    assert {k: v for k, v in got[0].items() if k != "score"} == \
        {k: v for k, v in want[0].items() if k != "score"}
    assert abs(got[0]["score"] - want[0]["score"]) <= 1e-4


def test_caption_run_reads_tiff_as_jax(tree, tmp_path):
    """TIFFs, which the port's decoders refused before: an RGBA under
    Deflate with predictor 2 and orientation 6 (PIL turns it), a
    big-endian PackBits file in planar tiles, an uncompressed grey one,
    PIL's LZW with predictor 2 and PIL's YCbCr JPEG: the records equal
    the JAX package's."""
    from PIL import Image
    from torch_images import write_tiff
    d = tree
    img = np.asarray(Image.open(d / "b.png"))
    (tmp_path / "h.tif").write_bytes(write_tiff(
        np.dstack([img, img[:, :, 1:2]]), 8, extra_samples=(2,),
        compression=8, predictor=2, orientation=6))
    (tmp_path / "i.tiff").write_bytes(write_tiff(
        img[::-1], 8, order=">", planar=2, tile=(16, 16),
        compression=32773))
    Image.fromarray(img).convert("L").save(tmp_path / "j.tif")
    Image.fromarray(img[:, ::-1]).save(tmp_path / "k.tif",
                                       compression="tiff_lzw",
                                       tiffinfo={317: 2})
    Image.fromarray(img[::-1, ::-1]).convert("YCbCr").save(
        tmp_path / "l.tif", compression="jpeg", quality=80)
    args = ["-i", *(str(tmp_path / n) for n in ("h.tif", "i.tiff",
                                                "j.tif", "k.tif", "l.tif")),
            "--rl_model", str(d / "rl.ckpt"),
            "--concept_model", str(d / "cpt.ckpt"),
            "--resnet101_ckpt", str(d / "resnet.ckpt"),
            "--sentiment_detector_json", str(d / "senti.json"),
            "--max_seq_len", "6", "--beam_size", "2", "--num_concepts", "3",
            "--num_sentiments", "4"]
    want = jcaption.run(jcaption.build_parser().parse_args(args))
    got = tcaption.run(tcaption.build_parser().parse_args(
        args + ["--device", "cpu"]))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "score"} == \
            {k: v for k, v in w.items() if k != "score"}
        assert abs(g["score"] - w["score"]) <= 1e-4


def test_caption_refuses_cuda_without_a_card(tree):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is taken")
    d = tree
    a = tcaption.build_parser().parse_args([
        "-i", str(d / "a.jpg"), "--rl_model", str(d / "rl.ckpt"),
        "--concept_model", str(d / "cpt.ckpt"),
        "--resnet101_ckpt", str(d / "resnet.ckpt"),
        "--sentiment_detector_json", str(d / "senti.json")])
    assert a.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcaption.run(a)


def test_caption_reads_images_without_pil(tree, monkeypatch):
    """The port's caption path decodes with its own decoders: the same
    arrays as PIL's for both fixtures, with PIL made unimportable."""
    import sys
    from insenticap_model_tpu import preprocessing as jpre
    from insenticap_model_tpu_torch import preprocessing as tpre
    want = [jpre.load_image(str(tree / n)) for n in ("a.jpg", "b.png")]
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    for n, w in zip(("a.jpg", "b.png"), want):
        np.testing.assert_array_equal(tpre.load_image(str(tree / n)), w)
    with pytest.raises(ImportError):
        jpre.load_image(str(tree / "a.jpg"))
