"""Fixed-shape batch assembly: the port's copy of
``insenticap_model_tpu/data/collate.py`` (numpy only).

The reference's collate closures (dataloader.py:9-149) sort each batch by
caption length and pad to the batch max. Here every mode pads to static
shapes (max_seq_len + 1 caption slots, num_concepts, num_sentiments) and
carries `lengths` for masking; the semantics the losses see are identical
(SURVEY.md §7, §8.3: lengths are len-1 because loss aligns captions[:,1:]
with predictions on captions[:,:-1]).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def pad_caption(cap: Sequence[int], max_len_p1: int, pad_id: int):
    """cap: [sos] + ids + [eos]. Returns (padded [max_len_p1], length-1),
    truncating like the reference (dataloader.py:22-27)."""
    L = min(len(cap), max_len_p1)
    out = np.full(max_len_p1, pad_id, np.int32)
    out[:L] = np.asarray(cap[:L], np.int32)
    return out, L - 1


def pad_list(ids: Sequence[int], n: int, pad_id: int):
    out = np.full(n, pad_id, np.int32)
    L = min(len(ids), n)
    out[:L] = np.asarray(ids[:L], np.int32)
    return out


def caption_batch(items, max_seq_len: int, num_concepts: int, pad_id: int,
                  fc_store, att_store) -> Dict[str, np.ndarray]:
    """items: list of (fn, cap_ids, cpt_ids) — one caption per row, images
    repeated per caption (the reference flattens 5 caps/image,
    dataloader.py:11-18)."""
    fns = [fn for fn, _, _ in items]
    caps, lengths, cpts = [], [], []
    for _, cap, cpt in items:
        c, L = pad_caption(cap, max_seq_len + 1, pad_id)
        caps.append(c)
        lengths.append(L)
        cpts.append(pad_list(cpt, num_concepts, pad_id))
    return {
        "fns": fns,
        "fc": fc_store.batch(fns),
        "att": att_store.batch(fns),
        "caps": np.stack(caps),
        "lengths": np.asarray(lengths, np.int32),
        "cpts": np.stack(cpts),
    }


def scs_batch(items, max_seq_len: int, num_concepts: int, num_sentiments: int,
              pad_id: int) -> Dict[str, np.ndarray]:
    """Sentiment-corpus batch (reference scs_collate_fn, dataloader.py:36-58).
    items: list of (cap_ids, cpt_ids, senti_word_ids, senti_label)."""
    caps, lengths, cpts, sentis, labels = [], [], [], [], []
    for cap, cpt, sw, lab in items:
        c, L = pad_caption(cap, max_seq_len + 1, pad_id)
        caps.append(c)
        lengths.append(L)
        cpts.append(pad_list(cpt, num_concepts, pad_id))
        sentis.append(pad_list(sw, num_sentiments, pad_id))
        labels.append(lab)
    return {
        "caps": np.stack(caps),
        "lengths": np.asarray(lengths, np.int32),
        "cpts": np.stack(cpts),
        "sentis": np.stack(sentis),
        "senti_labels": np.asarray(labels, np.int32),
    }


def rl_fact_batch(items, max_seq_len: int, num_concepts: int,
                  num_sentiments: int, pad_id: int, fc_store, att_store,
                  rng: np.random.Generator,
                  fn2row=None) -> Dict[str, np.ndarray]:
    """RL factual batch (reference rl_fact_collate_fn, dataloader.py:60-91):
    keeps the full ground-truth caption dict for CIDEr and samples one
    caption per image for the XE auxiliary loss."""
    fns = [fn for fn, _, _, _ in items]
    ground_truth = {fn: [c[:max_seq_len + 1] for c in caps]
                    for fn, caps, _, _ in items}
    caps, lengths, cpts, sentis = [], [], [], []
    for fn, all_caps, cpt, sw in items:
        cap = all_caps[rng.integers(0, len(all_caps))]
        c, L = pad_caption(cap, max_seq_len + 1, pad_id)
        caps.append(c)
        lengths.append(L)
        cpts.append(pad_list(cpt, num_concepts, pad_id))
        sentis.append(pad_list(sw, num_sentiments, pad_id))
    batch = {
        "fns": fns,
        "fc": fc_store.batch(fns),
        "att": att_store.batch(fns),
        "caps": np.stack(caps),
        "lengths": np.asarray(lengths, np.int32),
        "cpts": np.stack(cpts),
        "sentis": np.stack(sentis),
        "ground_truth": ground_truth,
    }
    if fn2row is not None:
        batch["img_rows"] = np.asarray([fn2row[fn] for fn in fns], np.int32)
    return batch


def rl_senti_batch(items, num_concepts: int, num_sentiments: int, pad_id: int,
                   fc_store, att_store) -> Dict[str, np.ndarray]:
    """RL sentiment-image batch (reference rl_senti_collate_fn,
    dataloader.py:93-109). items: (fn, cpt_ids, senti_word_ids, label)."""
    fns = [fn for fn, _, _, _ in items]
    return {
        "fns": fns,
        "fc": fc_store.batch(fns),
        "att": att_store.batch(fns),
        "cpts": np.stack([pad_list(c, num_concepts, pad_id)
                          for _, c, _, _ in items]),
        "sentis": np.stack([pad_list(s, num_sentiments, pad_id)
                            for _, _, s, _ in items]),
        "senti_labels": np.asarray([lab for _, _, _, lab in items], np.int32),
    }


def concept_batch(items, num_total_concepts: int, fc_store):
    """(fn, concept_idx_list) -> one-hot targets (reference ConceptDataset,
    dataloader.py:230-245)."""
    fns = [fn for fn, _ in items]
    cpts = np.zeros((len(items), num_total_concepts), np.float32)
    for i, (_, idxs) in enumerate(items):
        cpts[i, np.asarray(idxs, int)] = 1.0
    return {"fns": fns, "fc": fc_store.batch(fns), "cpts": cpts}


def senti_image_batch(items, att_store):
    fns = [fn for fn, _ in items]
    return {"fns": fns, "att": att_store.batch(fns),
            "labels": np.asarray([lab for _, lab in items], np.int32)}


def senti_sents_batch(items, max_seq_len: int, pad_id: int):
    """(label, sentence_ids) — sentences are ids + [eos], no SOS; lengths are
    NOT decremented (reference senti_sents_collate_fn, dataloader.py:123-134
    uses max_seq_len without +1)."""
    caps, lengths, labels = [], [], []
    for lab, sent in items:
        L = min(len(sent), max_seq_len)
        c = np.full(max_seq_len, pad_id, np.int32)
        c[:L] = np.asarray(sent[:L], np.int32)
        caps.append(c)
        lengths.append(L)
        labels.append(lab)
    return {"caps": np.stack(caps),
            "lengths": np.asarray(lengths, np.int32),
            "labels": np.asarray(labels, np.int32)}
