"""The port's checkpoint reader on the CPU: its msgpack decoder against the
msgpack package's encoder for every format it covers, checkpoints written
by the JAX package's ``checkpoint.save`` loaded bit for bit like
``convert.from_jax_numpy`` of the same tree (f32 and bf16, both detector
variants), the committed trained checkpoint loaded bit for bit like the
JAX package's own ``checkpoint.load``, a full ResNet-101 and a concept
checkpoint likewise, the shape check, and ``make_batcher_from_checkpoint``."""
import dataclasses
import os
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from insenticap_model_tpu import inference as jinf
from insenticap_model_tpu.cli import common as jcommon
from insenticap_model_tpu.config import Settings as JSettings
from insenticap_model_tpu.models import captioner as jcap
from insenticap_model_tpu.models import concept_detector as jcpt
from insenticap_model_tpu.models import encoder as jenc
from insenticap_model_tpu.models import sent_senti_cls as jss
from insenticap_model_tpu.models import sentiment_detector as jsd
from insenticap_model_tpu.training import checkpoint as jck
from insenticap_model_tpu.utils.dtypes import cast_bf16

from insenticap_model_tpu_torch import convert
from insenticap_model_tpu_torch.cli import common as tcommon
from insenticap_model_tpu_torch.serving_daemon import (
    make_batcher_from_checkpoint)
from insenticap_model_tpu_torch.training import checkpoint as tck
from insenticap_model_tpu_torch.utils import msgpack as tmsgpack

from torch_parity import (JIDS, features, n, port_settings,
                          resnet_state_dict)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED = os.path.join(REPO, "assets", "bench_trained.ckpt")
CATS = ["positive", "negative", "neutral"]


def _identical(a, b, path=""):
    """Same structure, dtypes, shapes and bits."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), (path, a.keys())
        for k in b:
            _identical(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _identical(x, y, f"{path}/{i}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        bits = (lambda x: x.view(torch.int16)) if a.dtype == torch.bfloat16 \
            else (lambda x: x)
        assert torch.equal(bits(a), bits(b)), path


# ---------------------------------------------------------------------------
# the msgpack decoder
# ---------------------------------------------------------------------------

def test_decoder_matches_msgpack_for_every_format():
    msgpack = pytest.importorskip("msgpack")
    values = [None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536,
              2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129,
              -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63, 0.1, -2.5e300,
              "", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 65536,
              "é中", b"", b"x" * 255, b"y" * 256, b"z" * 65536,
              [], list(range(15)), list(range(16)), list(range(65536)),
              {}, {str(i): i for i in range(15)},
              {str(i): [i, {"k": None}] for i in range(16)},
              {str(i): i for i in range(65536)}, {1: "int key"}]
    for v in values:
        blob = msgpack.packb(v, use_bin_type=True)
        assert tmsgpack.unpackb(blob) == v, repr(v)[:60]
    # float32 is widened exactly
    assert tmsgpack.unpackb(msgpack.packb(1.25, use_single_float=True)) \
        == 1.25


def _ext_array(msgpack, shape, dtype, data):
    return msgpack.ExtType(1, msgpack.packb((shape, dtype, data),
                                            use_bin_type=True))


def test_decoder_reads_arrays_at_every_ext_size():
    """fixext 8 and 16, ext 8/16/32: ext type 1 is flax's ndarray."""
    msgpack = pytest.importorskip("msgpack")
    cases = [
        ([0], "u1", b""),                                 # fixext 8
        ([4, 1], "uint8", bytes(range(4))),               # fixext 16
        ([3, 2], "float32",
         np.arange(6, dtype=np.float32).tobytes()),       # ext 8
        ([40, 3], "int64",
         np.arange(120, dtype=np.int64).tobytes()),       # ext 16
        ([300, 30], "float64",
         np.linspace(0, 1, 9000).tobytes()),              # ext 32
    ]
    firsts = set()
    for shape, dtype, data in cases:
        blob = msgpack.packb({"a": _ext_array(msgpack, shape, dtype, data)},
                             use_bin_type=True)
        firsts.add(blob[3])
        got = tmsgpack.unpackb(blob)["a"]
        want = np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape)
        assert list(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want)
    assert firsts == {0xD7, 0xD8, 0xC7, 0xC8, 0xC9}


def test_decoder_refuses_other_ext_types_and_bad_buffers():
    msgpack = pytest.importorskip("msgpack")
    for size in (1, 2, 4, 8, 16, 17, 300):            # fixext and ext
        blob = msgpack.packb(msgpack.ExtType(5, b"\0" * size))
        with pytest.raises(ValueError, match="ext type 5"):
            tmsgpack.unpackb(blob)
    good = msgpack.packb({"a": [1, 2, 3]})
    with pytest.raises(ValueError, match="truncated"):
        tmsgpack.unpackb(good[:-1])
    with pytest.raises(ValueError, match="trailing"):
        tmsgpack.unpackb(good + b"\0")
    with pytest.raises(ValueError, match="0xc1"):
        tmsgpack.unpackb(b"\xc1")


def test_decoder_reads_flax_bf16_and_chunked_arrays(monkeypatch):
    from flax import serialization
    g = np.random.default_rng(0)
    tree = {"bf": jnp.asarray(g.normal(size=(5, 7)), jnp.bfloat16),
            "f": g.normal(size=(6, 5)).astype(np.float32),
            "i": np.arange(7, dtype=np.int32), "l": [1.5, "x"]}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 32)  # 8 f32 each
    blob = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    got = tmsgpack.unpackb(blob)
    assert got["bf"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["bf"].float().numpy(), np.asarray(tree["bf"], np.float32))
    np.testing.assert_array_equal(got["f"].numpy(), tree["f"])
    np.testing.assert_array_equal(got["i"].numpy(), tree["i"])
    assert got["l"] == [1.5, "x"]


# ---------------------------------------------------------------------------
# checkpoints written by the JAX package
# ---------------------------------------------------------------------------

def _composite(settings, vocab_size, full=False):
    s = dataclasses.replace(settings, num_kernels_per_sentiment=2) if full \
        else settings
    sd = jsd.module_for(s)
    return s, {"captioner": jcap.init_params(jax.random.PRNGKey(0),
                                             vocab_size, 3, s),
               "senti_detector": sd.init_params(jax.random.PRNGKey(1), 3, s)}


def _meta(s, vocab):
    return {"epoch": 1, "settings": s.to_dict(), "idx2word": vocab.idx2word,
            "sentiment_categories": CATS}


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_jax_written_checkpoint_loads_bit_identical(tmp_path, settings,
                                                    vocab, full, bf16):
    s, params = _composite(settings, len(vocab), full)
    # the RL composite's third part, the sentence classifier
    params["sent_senti_cls"] = jss.init_params(jax.random.PRNGKey(2),
                                               len(vocab), 3, s)
    if bf16:
        params = cast_bf16(params)
    # a part the port has no model for is left out, as a JAX template
    # restore leaves it out
    extra = {"other_model": {"head": {"w": np.ones((3, 2), np.float32)}}}
    path = str(tmp_path / "model.ckpt")
    jck.save(path, {**params, **extra}, None, _meta(s, vocab))
    got, meta = tck.load(path, device="cpu")
    assert meta == jck.load_metadata(path)
    want = convert.from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    _identical(got, want)
    if bf16:
        assert got["captioner"]["classifier"]["weight"].dtype == \
            torch.bfloat16
        got32, _ = tck.load(path, device="cpu", dtype=torch.float32)
        assert got32["captioner"]["classifier"]["weight"].dtype == \
            torch.float32


def test_bare_model_trees_load(tmp_path, settings, vocab):
    s, params = _composite(settings, len(vocab))
    for part in ("captioner", "senti_detector"):
        path = str(tmp_path / f"{part}.ckpt")
        jck.save(path, params[part], None, _meta(s, vocab))
        got, _ = tck.load(path, device="cpu")
        _identical(got, convert.from_jax_numpy(
            jax.tree_util.tree_map(np.asarray, params[part]), device="cpu"))


def test_trained_checkpoint_loads_like_jax():
    s = JSettings()
    template = {"captioner": cast_bf16(
        jcap.init_params(jax.random.PRNGKey(0), 10_000, 3, s))}
    want, _, jmeta = jck.load(TRAINED, template)
    got, meta = tck.load(TRAINED, device="cpu")
    assert meta == jmeta
    _identical(got, convert.from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, want), device="cpu"))
    assert got["captioner"]["word_embed"]["weight"].dtype == torch.bfloat16


def test_a_wrong_shape_raises(tmp_path, settings, vocab):
    s, params = _composite(settings, len(vocab))
    path = str(tmp_path / "bad.ckpt")
    meta = _meta(s, vocab)
    meta["idx2word"] = vocab.idx2word[:-1]          # vocab one word short
    jck.save(path, params, None, meta)
    with pytest.raises(tck.CheckpointError, match="shape"):
        tck.load(path, device="cpu")
    conv = dict(params["senti_detector"])
    conv["convs"] = conv["convs"][:1]                # a conv missing
    jck.save(path, {"senti_detector": conv}, None, _meta(s, vocab))
    with pytest.raises(tck.CheckpointError, match="list"):
        tck.load(path, device="cpu")
    with open(path, "wb") as f:                      # not a checkpoint
        f.write(struct.pack("<Q", 2) + b"{}" + b"\xc1")
    with pytest.raises(tck.CheckpointError):
        tck.load(path, device="cpu")


def test_jax_written_resnet101_checkpoint_loads_bit_identical(tmp_path):
    """A full ResNet-101 tree as ``convert_checkpoint.py resnet101``
    writes it (BatchNorm nodes {scale, bias, mean, var}), read like the JAX
    package's own ``checkpoint.load``; a wrong conv shape raises."""
    params = jenc.convert_torch_state_dict(resnet_state_dict(2))
    path = str(tmp_path / "resnet101.ckpt")
    meta = {"kind": "resnet101", "epoch": -1}
    jck.save(path, params, None, meta)
    got, gmeta = tck.load(path, device="cpu")
    assert gmeta == meta
    want, _, _ = jck.load(path, params)
    _identical(got, convert.from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, want), device="cpu"))
    assert set(got["layers"][1][0]["bn1"]) == {"scale", "bias", "mean",
                                               "var"}
    assert got["layers"][3][2]["conv2"]["weight"].shape == (3, 3, 512, 512)
    bad = jax.tree_util.tree_map(lambda x: x, params)
    bad["layers"][0][0]["conv2"] = {"w": np.zeros((3, 3, 64, 32),
                                                  np.float32)}
    jck.save(path, bad, None, meta)
    with pytest.raises(tck.CheckpointError, match="shape"):
        tck.load(path, device="cpu")


@pytest.mark.parametrize("bf16", [False, True])
def test_jax_written_concept_checkpoint_loads_bit_identical(tmp_path,
                                                            settings, bf16):
    """A concept checkpoint as train_cpt.py writes it; the concept count
    comes from idx2concept. load_concept_model gives the same params."""
    idx2concept = [f"c{i}" for i in range(40)]
    params = jcpt.init_params(jax.random.PRNGKey(5), 40, settings)
    if bf16:
        params = cast_bf16(params)
    path = str(tmp_path / "concept.ckpt")
    meta = {"epoch": 3, "settings": settings.to_dict(),
            "idx2concept": idx2concept}
    jck.save(path, params, None, meta)
    got, _ = tck.load(path, device="cpu")
    want, _, _ = jck.load(path, params)
    _identical(got, convert.from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, want), device="cpu"))
    tparams, ti2c, _ = tcommon.load_concept_model(path, device="cpu")
    assert ti2c == idx2concept
    _identical(tparams, got)
    if not bf16:
        jparams, ji2c = jcommon.load_concept_model(path)
        assert ji2c == idx2concept
        _identical(tparams, convert.from_jax_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), device="cpu"))
    # one concept short in the metadata: fc3 has the wrong shape
    jck.save(path, params, None, {**meta, "idx2concept": idx2concept[:-1]})
    with pytest.raises(tck.CheckpointError, match="shape"):
        tck.load(path, device="cpu")
    jck.save(path, params, None, {**meta, "idx2concept": None})
    with pytest.raises(tck.CheckpointError, match="idx2concept"):
        tck.load(path, device="cpu")


def test_validate_metadata(settings, vocab):
    ps = port_settings(settings)
    meta = _meta(settings, vocab)
    tck.validate_metadata(meta, settings=ps, idx2word=vocab.idx2word,
                          sentiment_categories=CATS)
    with pytest.raises(tck.CheckpointError, match="settings"):
        tck.validate_metadata(meta, settings=dataclasses.replace(
            ps, rnn_hid_dim=8))
    with pytest.raises(tck.CheckpointError, match="idx2word"):
        tck.validate_metadata(meta, settings=ps, idx2word=["<PAD>"])


def test_make_batcher_from_checkpoint(tmp_path, settings, vocab):
    """A JAX-written RL composite with idx2word serves through the port's
    batcher on the CPU; rows equal the JAX package's serving step."""
    s, params = _composite(settings, len(vocab))
    path = str(tmp_path / "rl.ckpt")
    jck.save(path, params, None, _meta(s, vocab))
    fc, att, sentis = features(s, 3, 90)
    b, tvocab, cats, ts = make_batcher_from_checkpoint(
        path, max_seq_len=8, num_sentiments=5, bucket_sizes=(4,),
        max_wait_s=0.2, device="cpu")
    with b:
        rows = [b.submit(fc[i], att[i], sentis[i]) for i in range(3)]
    assert tvocab.idx2word == vocab.idx2word and cats == CATS
    assert ts == port_settings(s)
    jseqs, jscores, jlab = jinf.detect_and_decode(
        jinf.ServingParams(params["captioner"], params["senti_detector"]),
        jnp.asarray(fc), jnp.asarray(att), jnp.asarray(sentis), settings=s,
        ids=JIDS, beam_size=3, max_seq_len=8)
    for i, (seqs, scores, label) in enumerate(rows):
        assert label == int(jlab[i])
        np.testing.assert_array_equal(seqs, n(jseqs)[i])
        np.testing.assert_allclose(scores, n(jscores)[i], rtol=1e-4,
                                   atol=1e-4)
    jck.save(path, params, None, {**_meta(s, vocab), "idx2word": None})
    with pytest.raises(tck.CheckpointError, match="idx2word"):
        make_batcher_from_checkpoint(path, device="cpu")
