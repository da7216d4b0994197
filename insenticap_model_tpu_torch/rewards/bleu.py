"""BLEU-1..4: the port's copy of ``insenticap_model_tpu/rewards/bleu.py``,
line for line.

Algorithm parity with the coco-caption scorer the reference vendors
(self_critical/bleu/bleu_scorer.py:26-266): clipped modified n-gram
precision with max-counts over refs, 'closest' effective reference length,
the tiny/small smoothing constants, and per-sentence + corpus scores with
the exp(1 - 1/ratio) brevity penalty applied only when ratio < 1.

Operates on token sequences (tuples) like rewards/ciderd.py. Corpus BLEU
feeds the §6 table (``cli/eval_metrics.py``).
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

SMALL = 1e-9
TINY = 1e-15
N = 4


def _precook(seq: Sequence[int], n: int = N):
    counts: Dict[Tuple, int] = defaultdict(int)
    L = len(seq)
    for k in range(1, n + 1):
        for i in range(L - k + 1):
            counts[tuple(seq[i:i + k])] += 1
    return L, counts


def _cook_refs(refs: List[Sequence[int]], n: int = N):
    reflens = []
    maxcounts: Dict[Tuple, int] = {}
    for ref in refs:
        rl, counts = _precook(ref, n)
        reflens.append(rl)
        for ng, c in counts.items():
            maxcounts[ng] = max(maxcounts.get(ng, 0), c)
    return reflens, maxcounts


def _cook_test(test: Sequence[int], reflens, refmaxcounts, n: int = N):
    testlen, counts = _precook(test, n)
    reflen = min((abs(l - testlen), l) for l in reflens)[1]  # 'closest'
    guess = [max(0, testlen - k + 1) for k in range(1, n + 1)]
    correct = [0] * n
    for ng, c in counts.items():
        correct[len(ng) - 1] += min(refmaxcounts.get(ng, 0), c)
    return {"testlen": testlen, "reflen": reflen, "guess": guess,
            "correct": correct}


def compute_bleu(gts: Dict, res: List[Dict], n: int = N):
    """Reference-shaped API (bleu/bleu.py:17-62). Returns
    (corpus_bleus list[n], per_sentence list of n lists)."""
    comps_list = []
    for item in res:
        refs = [tuple(r) for r in gts[item["image_id"]]]
        reflens, maxcounts = _cook_refs(refs, n)
        comps_list.append(_cook_test(tuple(item["caption"][0]),
                                     reflens, maxcounts, n))

    bleu_list: List[List[float]] = [[] for _ in range(n)]
    total = {"testlen": 0, "reflen": 0,
             "guess": [0] * n, "correct": [0] * n}
    for comps in comps_list:
        total["testlen"] += comps["testlen"]
        total["reflen"] += comps["reflen"]
        for key in ("guess", "correct"):
            for k in range(n):
                total[key][k] += comps[key][k]
        bleu = 1.0
        for k in range(n):
            bleu *= (comps["correct"][k] + TINY) / (comps["guess"][k] + SMALL)
            bleu_list[k].append(bleu ** (1.0 / (k + 1)))
        ratio = (comps["testlen"] + TINY) / (comps["reflen"] + SMALL)
        if ratio < 1:
            for k in range(n):
                bleu_list[k][-1] *= math.exp(1 - 1 / ratio)

    bleus = []
    bleu = 1.0
    for k in range(n):
        bleu *= (total["correct"][k] + TINY) / (total["guess"][k] + SMALL)
        bleus.append(bleu ** (1.0 / (k + 1)))
    ratio = (total["testlen"] + TINY) / (total["reflen"] + SMALL)
    if ratio < 1:
        bleus = [b * math.exp(1 - 1 / ratio) for b in bleus]
    return bleus, bleu_list


class Bleu:
    """SCST-compatible wrapper: compute_score returns (bleus, per-sentence
    array list) like the reference Bleu class; get_self_critical_reward takes
    scores[3] (BLEU-4) (self_critical/utils.py:75-77)."""

    def __init__(self, n: int = N):
        self.n = n

    def compute_score(self, gts: Dict, res: List[Dict]):
        bleus, bleu_list = compute_bleu(gts, res, self.n)
        return bleus, [np.array(b) for b in bleu_list]
