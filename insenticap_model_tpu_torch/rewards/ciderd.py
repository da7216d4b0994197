"""CIDEr-D scorer, host (pure Python and float64): the port's copy of
``insenticap_model_tpu/rewards/ciderd.py``, line for line, with the
reference fork of ruotianluo/cider's algorithm (self_critical/cider/
pyciderevalcap/ciderD/ciderD_scorer.py:13-197): tf-idf n-gram vectors for
n=1..4 over id sequences, clipped cosine similarity, Gaussian length
penalty sigma=6, corpus document frequencies computed once, ref_len =
log(#corpus images).

The reference round-trips token ids through strings ("1 2 3 <eos>"); this
stays on integer tuples, value-identical since every string token is a
distinct id. The device scorer (``ops/ciderd_device.py``) builds its
tables from a ``CiderD`` instance's document_frequency and ref_len, and
this class is its oracle.

Quirk preserved: the "length" of the Gaussian penalty is the BIGRAM count
(the reference accumulates ``length`` only at n-gram order 2,
ciderD_scorer.py:142-143).
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

NGRAM_N = 4
SIGMA = 6.0


def seq_from_ids(arr: Sequence[int], sos: int, eos: int) -> Tuple[int, ...]:
    """Reference _array_to_str semantics (self_critical/utils.py:11-21):
    strip a leading SOS, stop at the first EOS, then append EOS."""
    arr = list(arr)
    if arr and arr[0] == sos:
        arr = arr[1:]
    out = []
    for tok in arr:
        if tok == eos:
            break
        out.append(int(tok))
    out.append(int(eos))
    return tuple(out)


def ngram_counts(seq: Sequence[int], n: int = NGRAM_N) -> Dict[Tuple, int]:
    counts: Dict[Tuple, int] = defaultdict(int)
    L = len(seq)
    for k in range(1, n + 1):
        for i in range(L - k + 1):
            counts[tuple(seq[i:i + k])] += 1
    return counts


class CiderD:
    """Corpus-df CIDEr-D. ``refs``: list over corpus images of lists of
    reference id-sequences (already passed through seq_from_ids)."""

    def __init__(self, refs: List[List[Tuple[int, ...]]], n: int = NGRAM_N,
                 sigma: float = SIGMA):
        self.n = n
        self.sigma = sigma
        self.document_frequency: Dict[Tuple, float] = defaultdict(float)
        crefs = [[ngram_counts(r, n) for r in image_refs]
                 for image_refs in refs]
        for image in crefs:
            for ngram in set(ng for ref in image for ng in ref):
                self.document_frequency[ngram] += 1
        self.ref_len = float(np.log(float(len(refs))))

    def _counts2vec(self, cnts: Dict[Tuple, int]):
        vec = [defaultdict(float) for _ in range(self.n)]
        norm = [0.0] * self.n
        length = 0
        for ngram, tf in cnts.items():
            df = np.log(max(1.0, self.document_frequency[ngram]))
            k = len(ngram) - 1
            vec[k][ngram] = float(tf) * (self.ref_len - df)
            norm[k] += vec[k][ngram] ** 2
            if k == 1:
                length += tf
        return vec, [math.sqrt(x) for x in norm], length

    def _sim(self, vh, vr, nh, nr, lh, lr):
        delta = float(lh - lr)
        val = np.zeros(self.n)
        for k in range(self.n):
            for ngram, cnt in vh[k].items():
                val[k] += min(cnt, vr[k][ngram]) * vr[k][ngram]
            if nh[k] != 0 and nr[k] != 0:
                val[k] /= nh[k] * nr[k]
            val[k] *= math.exp(-(delta ** 2) / (2 * self.sigma ** 2))
        return val

    def score_one(self, hyp: Tuple[int, ...],
                  refs: List[Tuple[int, ...]]) -> float:
        vh, nh, lh = self._counts2vec(ngram_counts(hyp, self.n))
        total = np.zeros(self.n)
        for ref in refs:
            vr, nr, lr = self._counts2vec(ngram_counts(ref, self.n))
            total += self._sim(vh, vr, nh, nr, lh, lr)
        return float(np.mean(total) / len(refs) * 10.0)

    def compute_score(self, gts: Dict, res: List[Dict]):
        """Reference-shaped API (ciderD.py:16-51): gts maps image_id to ref
        sequences, res is an ordered list of {'image_id', 'caption': [seq]}.
        Returns (mean, per-sentence scores np.ndarray in res order)."""
        scores = np.array([
            self.score_one(tuple(item["caption"][0]),
                           [tuple(r) for r in gts[item["image_id"]]])
            for item in res])
        return float(scores.mean()), scores


def build_scorer(split_captions: Dict[str, Dict[str, List[List[int]]]],
                 sos: int, eos: int) -> CiderD:
    """Reference get_ciderd_scorer (self_critical/utils.py:38-53): merge all
    splits' caption dicts, convert each caption via seq_from_ids."""
    captions: Dict[str, List[List[int]]] = {}
    for caps in split_captions.values():
        captions.update(caps)
    refs = [[seq_from_ids(c, sos, eos) for c in caps]
            for caps in captions.values()]
    return CiderD(refs)
