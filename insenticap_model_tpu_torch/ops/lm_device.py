"""The per-sentiment ARPA trigram LM reward on the device.

Counterpart of ``insenticap_model_tpu/ops/lm_device.py``. The reference
keeps a (disabled) kenlm LM reward wired to the RL stage: per-sentiment
id-form ARPA models (train_rl.py:212-216) scored on the host a sentence
at a time (self_critical/utils.py:86-100). Here the ARPA tables become
device tensors (dense unigrams a sentiment, and tables sorted by the first
of two hashes for the bigrams and trigrams, the hashing of
``ops/ciderd_device.py``), and the full backoff scoring is batched tensor
ops. The RL step takes it behind ``--rl_lm_flag`` (off by default, as in
the JAX package).

The scoring convention is ``rewards.rewards.ArpaTrigramLM``'s (kenlm's):
the total log10 probability of ``<s> seq </s>``, seq the rollout's words
and the explicit EOS id; an OOV token takes the ARPA's <unk> entry where
there is one, else -99.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..rewards.rewards import ArpaTrigramLM
from .ciderd_device import (M1, M2, PROBE, S1, S2, _U32, _lookup,
                            canonicalize, mul_u32)

OOV_LP = -99.0


class LMTables(NamedTuple):
    """Per-sentiment trigram LMs on the device. The token space is [0,
    V+1]: the vocabulary's ids, then EOS* = V (</s>) and SOS* = V+1
    (<s>). Hashes are uint32 values in int64 tensors."""
    uni_lp: torch.Tensor   # [S, V+2] float32 (OOV-filled)
    uni_bo: torch.Tensor   # [S, V+2] float32
    bi_h1: torch.Tensor    # [B] int64, sorted
    bi_h2: torch.Tensor    # [B] int64
    bi_lp: torch.Tensor    # [B] float32
    bi_bo: torch.Tensor    # [B] float32
    tri_h1: torch.Tensor   # [T] int64, sorted
    tri_h2: torch.Tensor   # [T] int64
    tri_lp: torch.Tensor   # [T] float32
    vocab_size: int        # V


def _host_hash(parts) -> tuple:
    h1 = np.uint32(S1)
    h2 = np.uint32(S2)
    with np.errstate(over="ignore"):
        for p in parts:
            t = np.uint32(p + 1)
            h1 = (h1 ^ t) * M1
            h2 = (h2 ^ t) * M2
    return int(h1), int(h2)


def _sorted_table(entries, n_vals: int):
    """entries [(h1, h2, *vals)] -> sorted uint32 / float32 arrays, with
    ciderd_device's probe-window and dual-hash uniqueness checks."""
    if not entries:
        entries = [(0, 0) + (0.0,) * n_vals]
    entries.sort()
    h1s = np.array([e[0] for e in entries], np.uint32)
    h2s = np.array([e[1] for e in entries], np.uint32)
    vals = [np.array([e[2 + i] for e in entries], np.float32)
            for i in range(n_vals)]
    if len(h1s) > 1:
        change = np.flatnonzero(np.diff(h1s) != 0)
        bounds = np.concatenate([[-1], change, [len(h1s) - 1]])
        if int(np.diff(bounds).max()) > PROBE:
            raise RuntimeError("LM table duplicate-key run exceeds probe")
    pair = h1s.astype(np.uint64) << np.uint64(32) | h2s.astype(np.uint64)
    if len(pair) != len(np.unique(pair)):
        raise RuntimeError("dual-hash collision in LM table")
    return h1s, h2s, vals


def build_lm_tables(arpa_paths: Sequence[str], vocab_size: int,
                    device="cpu") -> LMTables:
    """arpa_paths[senti_id] -> an id-form ARPA file (the LM stage writes
    {senti}_id.sri), read on the host and placed on ``device``. Token
    strings are integer ids plus <s>, </s> and perhaps <unk>."""
    V = vocab_size
    EOS_STAR, SOS_STAR = V, V + 1
    S = len(arpa_paths)

    def tok_id(t: str) -> int:
        if t == ArpaTrigramLM.BOS:
            return SOS_STAR
        if t == ArpaTrigramLM.EOS:
            return EOS_STAR
        if t == "<unk>":
            return -1
        i = int(t)
        if not 0 <= i < V:
            raise ValueError(f"LM token id {i} outside vocab {V}")
        return i

    uni_lp = np.full((S, V + 2), OOV_LP, np.float32)
    uni_bo = np.zeros((S, V + 2), np.float32)
    bi, tri = [], []
    for s, path in enumerate(arpa_paths):
        lm = ArpaTrigramLM(path)
        unk_lp = lm.lp[0].get(("<unk>",))
        if unk_lp is not None:
            uni_lp[s, :] = unk_lp  # kenlm-style OOV fill
        for (w,), lp in lm.lp[0].items():
            i = tok_id(w)
            if i >= 0:
                uni_lp[s, i] = lp
        for (w,), bo in lm.bo[0].items():
            i = tok_id(w)
            if i >= 0:
                uni_bo[s, i] = bo
        for (a, b), lp in lm.lp[1].items():
            ia, ib = tok_id(a), tok_id(b)
            if ia < 0 or ib < 0:
                continue
            bo = lm.bo[1].get((a, b), 0.0)
            bi.append(_host_hash((s, ia, ib)) + (lp, bo))
        for (a, b, c), lp in lm.lp[2].items():
            ia, ib, ic = tok_id(a), tok_id(b), tok_id(c)
            if ia < 0 or ib < 0 or ic < 0:
                continue
            tri.append(_host_hash((s, ia, ib, ic)) + (lp,))

    bh1, bh2, (blp, bbo) = _sorted_table(bi, 2)
    th1, th2, (tlp,) = _sorted_table(tri, 1)
    dev = torch.device(device)

    def put(a):
        return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                                else a).to(dev)
    return LMTables(
        uni_lp=put(uni_lp), uni_bo=put(uni_bo),
        bi_h1=put(bh1), bi_h2=put(bh2), bi_lp=put(blp), bi_bo=put(bbo),
        tri_h1=put(th1), tri_h2=put(th2), tri_lp=put(tlp), vocab_size=V)


def _dev_hash(parts):
    """The dual hash over stacked integer parts (tensors of one shape) ->
    (h1, h2) int64 tensors of uint32 values."""
    h1 = torch.full(parts[0].shape, int(S1), dtype=torch.int64,
                    device=parts[0].device)
    h2 = torch.full_like(h1, int(S2))
    for p in parts:
        t = (p.long() + 1) & _U32
        h1 = mul_u32(h1 ^ t, M1)
        h2 = mul_u32(h2 ^ t, M2)
    return h1, h2


def score_batch(tables: LMTables, seqs, senti_labels, eos: int):
    """The total log10 probability of <s> seq </s> a row (seq the rollout's
    words and the explicit EOS id, as ``canonicalize`` cuts them): seqs
    [bs, T] raw rollout ids, senti_labels [bs]. Returns [bs] float32."""
    V = tables.vocab_size
    bs, T = seqs.shape
    Tc = T + 1  # the canonical width (room for the appended EOS id)
    dev = seqs.device
    c, L = canonicalize(seqs, eos, Tc)
    idx = torch.arange(Tc + 2, device=dev)
    # e = [<s>, c_0 .. c_{Tc-1}, pad]; </s> overwrites position L+1
    e = torch.cat([torch.full((bs, 1), V + 1, dtype=torch.int64,
                              device=dev),
                   torch.clamp(c, min=0),
                   torch.zeros((bs, 1), dtype=torch.int64, device=dev)],
                  dim=1)
    e = torch.where(idx == (L + 1)[:, None], V, e)
    w = e[:, 1:]                       # the predicted token, positions >= 1
    c1 = e[:, :-1]
    c2 = torch.cat([torch.zeros((bs, 1), dtype=torch.int64, device=dev),
                    e[:, :-2]], dim=1)
    s = senti_labels.long()[:, None]
    sv = s.expand_as(w)

    lp1 = tables.uni_lp[s, w]
    bo1 = tables.uni_bo[s, c1]
    bh1, bh2 = _dev_hash((sv, c1, w))
    hit2, (lp2, _) = _lookup(tables.bi_h1, tables.bi_h2,
                             (tables.bi_lp, tables.bi_bo), bh1, bh2)
    ch1, ch2 = _dev_hash((sv, c2, c1))
    hitc, (_, bo2) = _lookup(tables.bi_h1, tables.bi_h2,
                             (tables.bi_lp, tables.bi_bo), ch1, ch2)
    th1, th2 = _dev_hash((sv, c2, c1, w))
    hit3, (lp3,) = _lookup(tables.tri_h1, tables.tri_h2,
                           (tables.tri_lp,), th1, th2)

    p2 = torch.where(hit2, lp2, bo1 + lp1)
    p3 = torch.where(hit3, lp3, torch.where(hitc, bo2, 0.0) + p2)
    j = torch.arange(1, Tc + 2, device=dev)
    p = torch.where(j == 1, p2, p3)
    valid = j <= (L + 1)[:, None]
    return torch.where(valid, p, 0.0).sum(-1)


def lm_reward(tables: LMTables, sample_seq, greedy_seq, senti_labels,
              eos: int):
    """sign(lm(greedy) - lm(sample)) broadcast over the time steps (the
    reference get_lm_reward, self_critical/utils.py:86-100), on the
    device."""
    bs, T = sample_seq.shape
    ss = score_batch(tables, sample_seq, senti_labels, eos)
    sg = score_batch(tables, greedy_seq, senti_labels, eos)
    return torch.sign(sg - ss)[:, None].expand(bs, T).contiguous()
