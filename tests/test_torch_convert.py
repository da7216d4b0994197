"""The port's readers of the reference's PyTorch checkpoints against the
JAX package's on the CPU: each ``convert.*_from_torch`` against
``from_jax_numpy`` of the JAX function on the same reference-named state
dict (built from seeded JAX parameters in the reference's layouts,
``torch_parity.reference_state_dict``), and ``cli/convert_checkpoint`` for
all six kinds against the JAX CLI on the same ``.pth``.

Tolerances: none. The trees are held equal leaf for leaf (same structure,
dtype and values), and the written files byte for byte.
"""
import os

import numpy as np
import pytest
import torch

import jax

from insenticap_model_tpu import convert as jconvert
from insenticap_model_tpu.cli import convert_checkpoint as jconvert_ckpt
from insenticap_model_tpu.config import Settings as JSettings
from insenticap_model_tpu.models import captioner as jcap
from insenticap_model_tpu.models import concept_detector as jcpt
from insenticap_model_tpu.models import sent_senti_cls as jss
from insenticap_model_tpu.models import sentiment_detector as jsd
from insenticap_model_tpu.models import sentiment_detector_full as jsdf
from insenticap_model_tpu_torch import convert as tconvert
from insenticap_model_tpu_torch.cli import convert_checkpoint as tconvert_ckpt
from insenticap_model_tpu_torch.training import checkpoint as tck
from torch_parity import (V, reference_state_dict, resnet_state_dict,
                          to_port)

CATS = ["positive", "negative", "neutral"]
N_CONCEPTS = 10


def _jax_tree(kind, settings):
    key = jax.random.PRNGKey(7)
    if kind == "captioner":
        return jcap.init_params(key, V, 3, settings)
    if kind == "concept":
        return jcpt.init_params(key, N_CONCEPTS, settings)
    if kind == "sentiment":
        return jsd.init_params(key, 3, settings)
    if kind == "sentiment_full":
        return jsdf.init_params(key, 3, JSettings(**{
            **settings.to_dict(), "text_cnn_filters": (3, 4, 5),
            "num_kernels_per_sentiment": 2}))
    if kind == "sent_senti_cls":
        return jss.init_params(key, V, 3, settings)
    return {"captioner": _jax_tree("captioner", settings),
            "senti_detector": _jax_tree("sentiment", settings),
            "sent_senti_cls": _jax_tree("sent_senti_cls", settings)}


FNS = {"captioner": "captioner_from_torch",
       "concept": "concept_detector_from_torch",
       "sentiment": "sentiment_detector_from_torch",
       "sentiment_full": "sentiment_detector_full_from_torch",
       "sent_senti_cls": "sent_senti_cls_from_torch",
       "detector": "detector_from_torch"}


def _leaves(tree, path=()):
    """(path, leaf) in sorted key order (jax.tree_util sorts dict keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, path + (i,))]
    return [(path, tree)]


def _assert_same_tree(got, want):
    ga, wa = _leaves(got), _leaves(want)
    assert [p for p, _ in ga] == [p for p, _ in wa]
    for (path, a), (_, b) in zip(ga, wa):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.device.type == "cpu" and torch.equal(a, b), path


@pytest.mark.parametrize("kind", list(FNS))
def test_from_torch_equals_jax(kind, settings):
    jtree = _jax_tree(kind, settings)
    sd = reference_state_dict(kind, jtree)
    want = tconvert.from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, getattr(jconvert, FNS[kind])(sd)),
        device="cpu")
    got = getattr(tconvert, FNS[kind])(sd, device="cpu")
    _assert_same_tree(got, want)
    _assert_same_tree(got, to_port(jtree))     # the layouts round-trip
    # an owning copy: the state dict's storage is not shared
    first = _leaves(got)[0][1]
    assert all(first.data_ptr() != v.data_ptr() for v in sd.values())


def _ref_settings(s):
    """The reference's settings dict, its misspelled concept_mid_him
    included (reference opts.py:79-96)."""
    d = {k: v for k, v in s.to_dict().items() if k not in (
        "concept_mid_dim", "text_cnn_filters", "num_kernels_per_sentiment",
        "sentiment_feat_dim", "text_cnn_out_dim")}
    return {**d, "concept_mid_him": s.concept_mid_dim}


@pytest.mark.parametrize("kind", ["captioner", "concept", "sentiment",
                                  "sent_senti_cls", "detector", "resnet101"])
def test_convert_checkpoint_writes_the_jax_file(kind, settings, tmp_path):
    pth = str(tmp_path / "in.pth")
    if kind == "resnet101":
        blob = {k: torch.from_numpy(v) for k, v in
                resnet_state_dict(3).items()}
    else:
        sd = reference_state_dict(kind, _jax_tree(kind, settings))
        words = ["<PAD>", "<UNK>", "<SOS>", "<EOS>"] + [
            f"w{i}" for i in range(V - 4)]
        blob = {"model": sd, "settings": _ref_settings(settings),
                "idx2word": words, "sentiment_categories": CATS,
                "dataset_name": "coco", "corpus_type": "part",
                "max_seq_len": 8, "epoch": 3}
        if kind == "concept":
            blob["idx2concept"] = [f"c{i}" for i in range(N_CONCEPTS)]
        if kind == "sentiment":         # a bare state dict: epoch -1
            blob = sd
    torch.save(blob, pth)
    want, got = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    jconvert_ckpt.run(kind, pth, want)
    tconvert_ckpt.main([kind, pth, got, "--device", "cpu"])
    with open(want, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()
    meta = tck.load_metadata(got)
    assert meta["kind"] == kind
    assert meta["epoch"] == (3 if kind not in ("sentiment", "resnet101")
                             else -1)
    if kind == "detector":              # the port reads its file back
        params, _ = tck.load(got, device="cpu")
        _assert_same_tree(params, tconvert.detector_from_torch(
            blob["model"], device="cpu"))
        assert meta["settings"]["concept_mid_him"] == \
            settings.concept_mid_dim


def test_convert_checkpoint_asks_for_the_card(tmp_path):
    """With no --device the CLI converts onto the card, and stops where
    CUDA is absent; a kind it does not know stops at the parser."""
    pth = str(tmp_path / "in.pth")
    torch.save({"output.0.weight": torch.zeros(2, 2)}, pth)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tconvert_ckpt.main(["concept", pth, str(tmp_path / "o.ckpt")])
    with pytest.raises(SystemExit):
        tconvert_ckpt.main(["encoder", pth, str(tmp_path / "o.ckpt")])
    assert not os.path.exists(tmp_path / "o.ckpt")
