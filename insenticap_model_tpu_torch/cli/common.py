"""The inference-side subset of ``insenticap_model_tpu/cli/common.py``
(:58-83): the concept checkpoint bootstrap and the detected-concepts ->
sentiment-word ids step, shared by the captioning and serving entry points.
"""
from __future__ import annotations

import numpy as np


def load_concept_model(path: str, *, device="cuda"):
    """Concept checkpoint written by the JAX package -> (params on
    ``device``, idx2concept)."""
    from ..training import checkpoint as ckpt
    params, meta = ckpt.load(path, device=device)
    return params, meta["idx2concept"]


def senti_word_ids(concepts, senti_table, vocab,
                   num_sentiments: int) -> np.ndarray:
    """Detected concepts -> ranked sentiment-word id row [num_sentiments]
    int32, PAD-padded (the per-image det_sentiments pipeline, reference
    preprocess.py:280-302, as caption and serve use it)."""
    from ..preprocessing import _rank_sentis
    words = _rank_sentis(concepts, senti_table)[:num_sentiments]
    row = np.full((num_sentiments,), vocab.pad_id, np.int32)
    ids = vocab.encode_filter(words)
    row[:len(ids)] = ids
    return row
