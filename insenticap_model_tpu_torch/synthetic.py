"""Deterministic synthetic corpus in the reference's artefact schemas.

The port's copy of ``insenticap_model_tpu/synthetic.py``: for the same
seed and sizes ``build_tree`` writes the same JSON artefacts (captions,
concepts, sentiment labels and the sentiment corpus; reference
preprocess.py:52-213 schemas) and the same feature values, drawn in the
same order. The feature stores are the native record format (``.isc``,
float32) in place of HDF5: the card's machine has no h5py, and the JAX
package's CLIs take a ``.isc`` store before a ``.h5`` one at the same
stem, so both packages train on the same tree.

``write_det_concepts`` stands in for the concept stage (``detect_concepts``
writes ``img_det_concepts.json`` from a trained concept detector): each
image's detected concepts are its own concept words. ``write_rl_inputs``
adds what the RL stage reads besides: detected concepts for the sentiment
images too, and the detected sentiment words that the preprocessing
derives from the concepts (``img_det_sentiments.json``, with the
``sentiment_words.json`` table they come from).
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from .data.feature_store import write_native_store

WORDS = ["cat", "dog", "man", "tree", "happy", "sad", "red", "blue",
         "runs", "sits", "big", "small", "nice", "ugly", "good", "bad"]
CONCEPTS = WORDS[:8]
N_IMG = {"train": 12, "val": 6, "test": 6}
N_SENTI_IMG = {"train": 8, "val": 4, "test": 4}
CATS = ["positive", "negative", "neutral"]


def build_tree(root: str, settings, *, seed: int = 0,
               n_img: Dict[str, int] = N_IMG,
               n_senti_img: Dict[str, int] = N_SENTI_IMG) -> None:
    """Fabricate the ./data tree under ``root`` (created if needed).
    Only ``settings.fc_feat_dim``/``att_feat_dim`` are read (the stores'
    record shapes)."""
    g = np.random.default_rng(seed)
    root = os.path.abspath(root)
    cap_dir = os.path.join(root, "data/captions/coco/part")
    feats_coco = os.path.join(root, "data/features/coco")
    feats_senti = os.path.join(root, "data/features/sentiment")
    for d in (cap_dir, feats_coco, feats_senti):
        os.makedirs(d, exist_ok=True)

    def wjson(rel, obj):
        with open(os.path.join(root, rel), "w") as f:
            json.dump(obj, f)

    idx2word = ["<PAD>", "<UNK>", "<SOS>", "<EOS>"] + WORDS
    wjson("data/captions/coco/part/idx2word.json", idx2word)
    wjson("data/captions/coco/idx2concept.json", CONCEPTS)

    def rand_caption():
        L = int(g.integers(3, 7))
        return [WORDS[int(j)] for j in g.integers(0, len(WORDS), L)]

    img_captions, img_concepts = {}, {}
    all_fns = []
    for split, n in n_img.items():
        img_captions[split] = {}
        img_concepts[split] = {}
        for i in range(n):
            fn = f"{split}_img{i}.jpg"
            all_fns.append(fn)
            img_captions[split][fn] = [rand_caption() for _ in range(3)]
            # sorted: set order depends on PYTHONHASHSEED
            img_concepts[split][fn] = sorted(
                {WORDS[int(j)] for j in g.integers(0, 8, 4)})
    wjson("data/captions/coco/img_captions.json", img_captions)
    wjson("data/captions/coco/img_concepts.json", img_concepts)

    senti_fns = []
    senti_cls = {}
    img_senti_labels = {}
    for split, n in n_senti_img.items():
        img_senti_labels[split] = []
        for i in range(n):
            fn = f"senti_{split}_img{i}.jpg"
            senti_fns.append(fn)
            senti_cls[fn] = i % 3
            img_senti_labels[split].append([fn, CATS[i % 3]])
    wjson("data/captions/img_senti_labels.json", img_senti_labels)

    # [cap_words, cpt_words, senti_words] triples; >= 160 neutral so that
    # the seq2seq loader (bs=80, drop_last) yields batches
    senti_captions = {}
    for senti, n in (("positive", 30), ("negative", 30), ("neutral", 160)):
        senti_captions[senti] = [
            [rand_caption(), [WORDS[int(g.integers(0, 8))]],
             [WORDS[4 + int(g.integers(0, 4))]]] for _ in range(n)]
    wjson("data/captions/coco/part/senti_captions.json", senti_captions)

    fc_shape = (settings.fc_feat_dim,)
    att_shape = (14, 14, settings.att_feat_dim)
    # the JAX package draws fc then att, image by image
    fc, att = {}, {}
    for fn in all_fns:
        fc[fn] = g.normal(size=fc_shape).astype(np.float32)
        att[fn] = g.normal(size=att_shape).astype(np.float32)
    _write_pair(feats_coco, "coco", fc, att, fc_shape, att_shape)
    # sentiment images carry a class-informative channel shift on top of
    # the noise, so that a detector trained on them generalises
    fc, att = {}, {}
    for fn in senti_fns:
        shift = np.zeros((settings.att_feat_dim,), np.float32)
        third = settings.att_feat_dim // 3
        shift[senti_cls[fn] * third:(senti_cls[fn] + 1) * third] = 2.0
        fc[fn] = g.normal(size=fc_shape).astype(np.float32)
        att[fn] = g.normal(size=att_shape).astype(np.float32) + shift
    _write_pair(feats_senti, "feats", fc, att, fc_shape, att_shape)


def _write_pair(d, stem, fc, att, fc_shape, att_shape):
    write_native_store(os.path.join(d, f"{stem}_fc.isc"), fc.items(),
                       fc_shape, dtype="float32")
    write_native_store(os.path.join(d, f"{stem}_att.isc"), att.items(),
                       att_shape, dtype="float32")


def write_det_concepts(root: str) -> None:
    """``img_det_concepts.json`` for every captioned image: its own concept
    words (the stand-in for the concept stage's detections)."""
    cap = os.path.join(os.path.abspath(root), "data/captions/coco")
    with open(os.path.join(cap, "img_concepts.json")) as f:
        img_concepts = json.load(f)
    det = {fn: words for split in img_concepts.values()
           for fn, words in split.items()}
    with open(os.path.join(cap, "img_det_concepts.json"), "w") as f:
        json.dump(det, f)


def write_rl_inputs(root: str) -> None:
    """The RL stage's inputs beyond ``write_det_concepts``:
    ``img_det_concepts.json`` for the captioned and the sentiment images
    (the latter two concept words each, by position), and
    ``img_det_sentiments.json`` (two sentiment words an image) with the
    ``sentiment_words.json`` table."""
    root = os.path.abspath(root)
    cap = os.path.join(root, "data/captions/coco")
    with open(os.path.join(cap, "img_concepts.json")) as f:
        img_concepts = json.load(f)
    with open(os.path.join(root, "data/captions/img_senti_labels.json")) as f:
        senti_imgs = [fn for split in json.load(f).values()
                      for fn, _ in split]
    det = {fn: words for split in img_concepts.values()
           for fn, words in split.items()}
    for i, fn in enumerate(senti_imgs):
        det[fn] = [CONCEPTS[i % 4], CONCEPTS[4 + i % 4]]
    with open(os.path.join(cap, "img_det_concepts.json"), "w") as f:
        json.dump(det, f)
    with open(os.path.join(cap, "part", "img_det_sentiments.json"),
              "w") as f:
        json.dump({fn: ["happy", "sad"] for fn in det}, f)
    corpus = os.path.join(root, "data/corpus/part")
    os.makedirs(corpus, exist_ok=True)
    with open(os.path.join(corpus, "sentiment_words.json"), "w") as f:
        json.dump({"positive": {"happy": 1.0}, "negative": {"sad": 1.0}}, f)
