"""SCST rewards on the host (reference self_critical/utils.py:56-166): the
port's copy of ``insenticap_model_tpu/rewards/rewards.py``.

These are the numpy twins of the device rewards: the RL step computes
CIDEr-D on the device (``ops/ciderd_device.py``), the classifier reward
inside the step (``training/steps.py``) and the optional LM reward on the
device (``ops/lm_device.py``, whose tables ``ArpaTrigramLM`` reads). The
JAX package's BLEU-4 scorer (``rewards/bleu.py``) serves only its
``eval_metrics`` CLI and is not ported yet, so ``get_self_critical_reward``
takes a ``CiderD`` scorer only.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .ciderd import CiderD, seq_from_ids


def get_self_critical_reward(sample_captions: np.ndarray,
                             greedy_captions: np.ndarray,
                             fns: Sequence[str],
                             ground_truth: Dict[str, List[Sequence[int]]],
                             sos: int, eos: int, scorer) -> np.ndarray:
    """score(sample) - score(greedy), broadcast over all timesteps
    (reference self_critical/utils.py:56-83)."""
    bs = len(fns)
    assert sample_captions.shape[0] == greedy_captions.shape[0] == bs
    gts, res = {}, []
    for i, fn in enumerate(fns):
        res.append({"image_id": fn,
                    "caption": [seq_from_ids(sample_captions[i], sos, eos)]})
    for i, fn in enumerate(fns):
        res.append({"image_id": fn,
                    "caption": [seq_from_ids(greedy_captions[i], sos, eos)]})
        gts[fn] = [seq_from_ids(c, sos, eos) for c in ground_truth[fn]]
    if not isinstance(scorer, CiderD):
        raise TypeError(f"unsupported scorer: {type(scorer)} (the port "
                        "scores SCST rewards with CiderD)")
    _, scores = scorer.compute_score(gts, res)
    adv = scores[:bs] - scores[bs:]
    return np.repeat(adv[:, None], sample_captions.shape[1], axis=1)


def cls_reward_from_outputs(pred_labels: np.ndarray,
                            att_weights: np.ndarray,
                            senti_labels: np.ndarray,
                            max_len: int) -> np.ndarray:
    """Per-token cls reward = 1{pred == target} * excitation weights, padded
    to max_len (reference get_cls_reward, self_critical/utils.py:120-151).
    No baseline is subtracted (SURVEY.md §8.9)."""
    correct = (pred_labels == senti_labels).astype(att_weights.dtype)
    scores = correct[:, None] * att_weights
    pad = max_len - scores.shape[1]
    if pad > 0:
        scores = np.pad(scores, ((0, 0), (0, pad)))
    return scores[:, :max_len]


def get_senti_words_reward(sample_captions: np.ndarray,
                           senti_labels: np.ndarray,
                           sentiment_words: Dict[int, Dict[int, float]]):
    """Table-lookup reward for generated sentiment words (reference
    self_critical/utils.py:154-166; unused there, kept for completeness)."""
    rewards = np.zeros(sample_captions.shape, float)
    accur: Dict[int, set] = {}
    for i in range(sample_captions.shape[0]):
        sid = int(senti_labels[i])
        table = sentiment_words.get(sid, {})
        for j, w in enumerate(sample_captions[i]):
            w = int(w)
            if w in table:
                rewards[i, j] = table[w]
                accur.setdefault(sid, set()).add(w)
    return rewards, accur


def get_lm_reward(sample_captions: np.ndarray, greedy_captions: np.ndarray,
                  senti_labels: np.ndarray, sos: int, eos: int,
                  lms) -> np.ndarray:
    """sign(lm(greedy) - lm(sample)) broadcast over timesteps (reference
    self_critical/utils.py:86-100). ``lms[senti_id]`` must expose
    ``score(seq) -> float`` on id tuples, e.g. ``ArpaTrigramLM`` over the
    id-form ARPA files of the preprocessing's LM stage."""
    bs = sample_captions.shape[0]
    scores = []
    for i in range(bs):
        lm = lms[int(senti_labels[i])]
        s = seq_from_ids(sample_captions[i], sos, eos)
        g = seq_from_ids(greedy_captions[i], sos, eos)
        scores.append(np.sign(lm.score(g) - lm.score(s)))
    return np.repeat(np.array(scores)[:, None], sample_captions.shape[1],
                     axis=1)


class ArpaTrigramLM:
    """Host ARPA trigram scorer with kenlm's scoring convention, which the
    reference's (disabled) LM reward relies on (self_critical/utils.py:
    86-100): ``score(seq)`` wraps the sequence in <s> ... </s> and returns
    the total log10 probability, with standard ARPA backoff. Reads the
    id-form .sri/.arpa files of the preprocessing's LM stage.

    OOV policy: a token without a unigram entry takes the ARPA's <unk>
    entry where there is one (kenlm's behaviour), else a fixed floor of
    -99 (isclm's ARPAs carry no <unk>). The device twin
    (``ops/lm_device.py``) matches this class.
    """

    BOS = "<s>"
    EOS = "</s>"
    OOV_LP = -99.0

    def __init__(self, path: str):
        self.lp = [dict() for _ in range(3)]   # order-1..3: tuple -> lp
        self.bo = [dict() for _ in range(2)]   # order-1..2: tuple -> backoff
        order = 0
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line.startswith("\\") and "-grams:" in line:
                    order = int(line[1:line.index("-")])
                    continue
                if not line or line.startswith("\\") or "=" in line:
                    if line == "\\end\\":
                        break
                    continue
                parts = line.split()
                lp = float(parts[0])
                ng = tuple(parts[1:1 + order])
                self.lp[order - 1][ng] = lp
                if len(parts) > 1 + order and order < 3:
                    self.bo[order - 1][ng] = float(parts[1 + order])

    def _p1(self, w: str) -> float:
        if (w,) in self.lp[0]:
            return self.lp[0][(w,)]
        if ("<unk>",) in self.lp[0]:
            return self.lp[0][("<unk>",)]
        return self.OOV_LP

    def _p2(self, c1: str, w: str) -> float:
        if (c1, w) in self.lp[1]:
            return self.lp[1][(c1, w)]
        return self.bo[0].get((c1,), 0.0) + self._p1(w)

    def _p3(self, c2: str, c1: str, w: str) -> float:
        if (c2, c1, w) in self.lp[2]:
            return self.lp[2][(c2, c1, w)]
        return self.bo[1].get((c2, c1), 0.0) + self._p2(c1, w)

    def score(self, seq: Sequence[int]) -> float:
        """Total log10 prob of <s> seq </s> (kenlm's .score convention; seq
        is the id tuple from seq_from_ids: words + explicit EOS id)."""
        toks = [self.BOS] + [str(int(t)) for t in seq] + [self.EOS]
        total = 0.0
        for j in range(1, len(toks)):
            if j == 1:
                total += self._p2(toks[0], toks[1])
            else:
                total += self._p3(toks[j - 2], toks[j - 1], toks[j])
        return total
