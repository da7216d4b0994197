"""CIDEr-D on the device: the SCST reward with no copy to the host.

Counterpart of ``insenticap_model_tpu/ops/ciderd_device.py``. The
reference copies both rollouts to the host, turns ids into strings and
scores them in pure Python (self_critical/utils.py:56-83,
ciderD_scorer.py:120-197). Here the scorer is batched tensor ops on the
rollouts' device:

  * n-grams (n = 1..4) become two 32-bit multiplicative hashes of shifted
    id arrays: no strings, no dicts;
  * the corpus document frequencies sit on the device as a table sorted
    by the first hash (built once on the host from ``rewards/ciderd.py``'s
    scorer); a lookup is ``torch.searchsorted`` plus a linear probe of
    ``PROBE`` slots over equal first keys;
  * term frequencies within a caption come from all-pairs hash equality
    ([rows, N, T, T], T <= 17), and the match against the references from
    [rows, R, N, T, T];
  * each image's reference statistics (hashes, validity, norms, bigram
    counts) are precomputed in the tables and gathered by image row.

Hashes are unsigned 32-bit values held in int64 tensors: the XOR and the
multiply are those of uint32 (the multiply split in two 16-bit halves, so
no product leaves int64's range), the values equal the JAX package's
value for value, and int64 keeps uint32's sort order, which
``torch.searchsorted`` needs (it takes no uint32). The numerics are the
host scorer's (the same tf-idf, clipped cosine, the reference's
bigram-count length quirk, the Gaussian penalty sigma = 6), within f32
rounding.

Both rollouts score in one call over [2 bs] rows, the JAX package's
default form (its ``ISC_CIDERD_MERGED=0`` A/B switch to two calls gives
the same rows and is not copied).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from ..rewards.ciderd import CiderD, seq_from_ids

NGRAM_N = 4
SIGMA = 6.0

# dual 32-bit multiplicative hashing (odd constants)
M1 = np.uint32(0x9E3779B1)
M2 = np.uint32(0x85EBCA77)
S1 = np.uint32(0x165667B1)
S2 = np.uint32(0x27D4EB2F)
PROBE = 8  # linear-probe window for duplicate first keys
_U32 = 0xFFFFFFFF


class CiderTables(NamedTuple):
    """Scorer state on the device. The references' n-gram statistics are
    precomputed on the host (references never change)."""
    df_h1: torch.Tensor      # [D] int64 (uint32 values), sorted
    df_h2: torch.Tensor      # [D] int64 (uint32 values)
    df_val: torch.Tensor     # [D] float32 document frequencies
    ref_len: torch.Tensor    # scalar float32: log(#corpus images)
    gts_len: torch.Tensor    # [num_images, R] int32 (0 = absent ref)
    gts_count: torch.Tensor  # [num_images] int32 actual ref counts
    ref_h1: torch.Tensor     # [num_images, R, N, T] int64 n-gram hashes
    ref_h2: torch.Tensor     # [num_images, R, N, T] int64
    ref_valid: torch.Tensor  # [num_images, R, N, T] bool
    ref_norm: torch.Tensor   # [num_images, R, N] float32 tf-idf norms
    ref_blen: torch.Tensor   # [num_images, R] float32 bigram counts

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self)


def _host_hash_pair(ngram) -> tuple:
    h1 = np.uint32(S1)
    h2 = np.uint32(S2)
    with np.errstate(over="ignore"):
        for tok in ngram:
            t = np.uint32(tok + 1)
            h1 = (h1 ^ t) * M1
            h2 = (h2 ^ t) * M2
    return int(h1), int(h2)


def build_tables(scorer: CiderD, gts: Dict[str, list], image_order: list,
                 max_seq_len: int, sos: int, eos: int,
                 device="cpu") -> tuple:
    """The device tables from the host scorer and the tokenized ground
    truth, built in numpy and placed on ``device``.

    gts: {fn: [caption ids (with sos/eos), ...]}; captions are cut to
    max_seq_len + 1 ids, as the reference's rl_fact collate does
    (dataloader.py:64), before canonicalization. image_order: the fns in
    row order. Returns (tables, fn2row)."""
    items = []
    for ngram, df in scorer.document_frequency.items():
        h1, h2 = _host_hash_pair(ngram)
        items.append((h1, h2, df))
    items.sort()
    h1s = np.array([a for a, _, _ in items], np.uint32)
    h2s = np.array([b for _, b, _ in items], np.uint32)
    dfs = np.array([c for _, _, c in items], np.float32)
    # runs of equal first keys must fit the probe window
    if len(h1s) > 1:
        change = np.flatnonzero(np.diff(h1s) != 0)
        bounds = np.concatenate([[-1], change, [len(h1s) - 1]])
        max_run = int(np.diff(bounds).max())
        if max_run > PROBE:
            raise RuntimeError(
                f"df table duplicate-key run {max_run} exceeds probe window")
    # an exact duplicate (h1, h2) pair would silently merge dfs
    pair = h1s.astype(np.uint64) << np.uint64(32) | h2s.astype(np.uint64)
    if len(pair) != len(np.unique(pair)):
        raise RuntimeError("dual-hash collision in corpus df table")

    T = max_seq_len + 1
    R = max(len(caps) for caps in gts.values())
    n = len(image_order)
    gts_len = np.zeros((n, R), np.int32)
    gts_count = np.zeros((n,), np.int32)
    ref_h1 = np.zeros((n, R, NGRAM_N, T), np.uint32)
    ref_h2 = np.zeros((n, R, NGRAM_N, T), np.uint32)
    ref_valid = np.zeros((n, R, NGRAM_N, T), np.bool_)
    ref_norm = np.zeros((n, R, NGRAM_N), np.float32)
    ref_blen = np.zeros((n, R), np.float32)
    log_ref_len = float(scorer.ref_len)
    df_dict = scorer.document_frequency
    for row, fn in enumerate(image_order):
        caps = gts[fn]
        gts_count[row] = len(caps)
        for r, cap in enumerate(caps[:R]):
            seq = seq_from_ids(list(cap)[:max_seq_len + 1], sos, eos)
            L = min(len(seq), T)
            gts_len[row, r] = L
            h1, h2, valid, norm, blen = _host_ref_stats(
                seq[:L], L, T, df_dict, log_ref_len)
            ref_h1[row, r] = h1
            ref_h2[row, r] = h2
            ref_valid[row, r] = valid
            ref_norm[row, r] = norm
            ref_blen[row, r] = blen

    dev = torch.device(device)

    def put(a):
        return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                                else a).to(dev)
    tables = CiderTables(
        df_h1=put(h1s), df_h2=put(h2s), df_val=put(dfs),
        ref_len=torch.tensor(scorer.ref_len, dtype=torch.float32,
                             device=dev),
        gts_len=put(gts_len), gts_count=put(gts_count),
        ref_h1=put(ref_h1), ref_h2=put(ref_h2), ref_valid=put(ref_valid),
        ref_norm=put(ref_norm), ref_blen=put(ref_blen))
    fn2row = {fn: i for i, fn in enumerate(image_order)}
    return tables, fn2row


def _host_ref_stats(seq, L: int, T: int, df_dict, log_ref_len: float):
    """A reference's n-gram statistics, computed once on the host with the
    device's uint32 hash arithmetic and f32 norm accumulation order
    (position-major sum of squares a order)."""
    ids = np.full((T,), -1, np.int64)
    ids[:L] = seq
    tok = (ids + 1).astype(np.uint32)
    pos = np.arange(T)
    h1 = np.full((T,), S1, np.uint32)
    h2 = np.full((T,), S2, np.uint32)
    h1s, h2s, valids, norms = [], [], [], []
    with np.errstate(over="ignore"):
        for k in range(NGRAM_N):
            shifted = np.roll(tok, -k)
            h1 = (h1 ^ shifted) * M1
            h2 = (h2 ^ shifted) * M2
            h1s.append(h1.copy())
            h2s.append(h2.copy())
            valids.append(pos + k < L)
    h1a, h2a = np.stack(h1s), np.stack(h2s)
    valid = np.stack(valids)
    same = ((h1a[:, :, None] == h1a[:, None, :])
            & (h2a[:, :, None] == h2a[:, None, :])
            & valid[:, None, :] & valid[:, :, None])
    tf = same.sum(-1).astype(np.float32)                # [N, T]
    tri = np.tril(np.ones((T, T), np.bool_), -1)
    first = valid & ~(same & tri[None]).any(-1)
    for k in range(NGRAM_N):
        w2_sum = np.float32(0.0)
        for i in np.flatnonzero(first[k]):
            gram = tuple(int(x) for x in ids[i:i + k + 1])
            df = np.float32(df_dict.get(gram, 0.0))
            idf = np.float32(log_ref_len) - np.float32(
                np.log(max(np.float32(1.0), df)))
            w = tf[k, i] * idf
            w2_sum = np.float32(w2_sum + np.float32(w * w))
        norms.append(np.sqrt(w2_sum))
    blen = np.float32(valid[1].sum())
    return h1a, h2a, valid, np.array(norms, np.float32), blen


# ---------------------------------------------------------------------------
# Device-side scoring
# ---------------------------------------------------------------------------

def mul_u32(h, m: int):
    """(h * m) mod 2^32 for int64 tensors h of uint32 values: two 16-bit
    halves of m, so that no intermediate leaves int64's range."""
    m = int(m)
    lo = h * (m & 0xFFFF)
    hi = ((h * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def canonicalize(seq, eos: int, T_out: int):
    """[rows, T] rollout ids (0 after EOS, EOS perhaps absent) -> ([rows,
    T_out] int64 ids with a trailing EOS and -1 past it, lengths [rows]).
    ``rewards.ciderd.seq_from_ids`` for rollouts (no leading SOS)."""
    rows, T = seq.shape
    t_in = torch.arange(T, device=seq.device)
    # the first EOS, or T where there is none
    L_body = torch.where(seq == eos, t_in, T).amin(dim=1)
    t = torch.arange(T_out, device=seq.device)
    padded = torch.full((rows, T_out), -1, dtype=torch.int64,
                        device=seq.device)
    n = min(T, T_out)
    padded[:, :n] = seq[:, :n].long()
    out = torch.where(t < L_body[:, None], padded, -1)
    out = torch.where(t == L_body[:, None], eos, out)
    return out, L_body + 1


def _ngram_hashes(ids, L):
    """ids [rows, T] (-1 past L) -> h1, h2 [rows, N, T] int64 (uint32
    values; position i holds the hash of ids[i:i+k+1]) and valid [rows, N,
    T] bool."""
    T = ids.shape[-1]
    tok = (ids.long() + 1) & _U32
    pos = torch.arange(T, device=ids.device)
    h1 = torch.full_like(tok, int(S1))
    h2 = torch.full_like(tok, int(S2))
    h1s, h2s, valids = [], [], []
    for k in range(NGRAM_N):
        shifted = torch.roll(tok, -k, dims=-1)
        h1 = mul_u32(h1 ^ shifted, M1)
        h2 = mul_u32(h2 ^ shifted, M2)
        h1s.append(h1)
        h2s.append(h2)
        valids.append(pos + k < L[:, None])
    return (torch.stack(h1s, dim=1), torch.stack(h2s, dim=1),
            torch.stack(valids, dim=1))


def _lookup(keys1, keys2, vals, h1, h2):
    """searchsorted (side left) + a probe of PROBE slots, clamped at the
    table's end -> (hit mask, one value tensor a ``vals`` entry, 0 where
    there is no hit)."""
    D = keys1.shape[0]
    pos = torch.searchsorted(keys1, h1.reshape(-1)).reshape(h1.shape)
    hit = torch.zeros(h1.shape, dtype=torch.bool, device=h1.device)
    outs = [torch.zeros(h1.shape, dtype=torch.float32, device=h1.device)
            for _ in vals]
    for d in range(PROBE):
        p = torch.clamp(pos + d, max=D - 1)
        m = (keys1[p] == h1) & (keys2[p] == h2)
        hit = hit | m
        outs = [torch.where(m, v[p], o) for v, o in zip(vals, outs)]
    return hit, outs


def _df_lookup(tables: CiderTables, h1, h2):
    """Document frequencies of the hashed n-grams (0 where unseen)."""
    return _lookup(tables.df_h1, tables.df_h2, (tables.df_val,), h1, h2)[1][0]


def _vec_stats(tables: CiderTables, ids, L):
    """tf-idf statistics of canonical sequences ids [rows, T]: a dict of
    [rows, N, T] tensors (h1, h2, valid, first-occurrence mask, tf, idf, w
    = tf * idf at first occurrences), norm [rows, N] and blen [rows] (the
    bigram count, the reference's length quirk)."""
    h1, h2, valid = _ngram_hashes(ids, L)
    same = ((h1[..., :, None] == h1[..., None, :])
            & (h2[..., :, None] == h2[..., None, :])
            & valid[..., None, :] & valid[..., :, None])
    tf = same.sum(-1).float()                            # [rows, N, T]
    T = ids.shape[-1]
    tri = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                device=ids.device), -1)  # j < i
    first = valid & ~(same & tri).any(-1)
    df = _df_lookup(tables, h1, h2)
    idf = tables.ref_len - torch.log(torch.clamp(df, min=1.0))
    w = torch.where(first, tf * idf, 0.0)
    norm = torch.sqrt((w * w).sum(-1))                   # [rows, N]
    blen = valid[:, 1].sum(-1).float()
    return {"h1": h1, "h2": h2, "valid": valid, "first": first, "tf": tf,
            "idf": idf, "w": w, "norm": norm, "blen": blen}


def _sim(hyp, ref):
    """Clipped cosine a order with the Gaussian length penalty
    (ciderD_scorer.py:147-173). hyp: ``_vec_stats`` of [rows]; ref: the
    references' h1, h2, valid [rows, R, N, T], norm [rows, R, N], blen
    [rows, R]. Returns [rows, R, N]."""
    def h(k):
        return hyp[k][:, None, :, :, None]               # [rows,1,N,T,1]

    def r(k):
        return ref[k][:, :, :, None, :]                  # [rows,R,N,1,T]
    match = ((h("h1") == r("h1")) & (h("h2") == r("h2"))
             & h("valid") & r("valid"))
    ref_tf = match.sum(-1).float()                       # [rows, R, N, T]
    idf = hyp["idf"][:, None]
    ref_w = ref_tf * idf                                 # same global idf
    hyp_w = (hyp["tf"] * hyp["idf"])[:, None]
    prod = torch.minimum(hyp_w, ref_w) * ref_w
    val = torch.where(hyp["first"][:, None], prod, 0.0).sum(-1)
    denom = hyp["norm"][:, None] * ref["norm"]
    val = torch.where(denom != 0,
                      val / torch.where(denom != 0, denom, 1.0), val)
    delta = hyp["blen"][:, None] - ref["blen"]           # [rows, R]
    return val * torch.exp(-(delta ** 2) / (2 * SIGMA ** 2))[..., None]


def cider_d(tables: CiderTables, hyp_ids, hyp_len, img_rows):
    """Scores [rows] of canonical hypotheses hyp_ids [rows, T], hyp_len
    [rows], against the references of the images img_rows [rows] (x10,
    the mean over orders, averaged over the actual references). Only the
    hypotheses' statistics are computed; the references' are read from
    the tables."""
    rows = img_rows.long()
    hyp = _vec_stats(tables, hyp_ids, hyp_len)
    ref = {"h1": tables.ref_h1[rows], "h2": tables.ref_h2[rows],
           "valid": tables.ref_valid[rows], "norm": tables.ref_norm[rows],
           "blen": tables.ref_blen[rows]}
    s = _sim(hyp, ref).mean(-1)                          # [rows, R]
    total = torch.where(tables.gts_len[rows] > 0, s, 0.0).sum(-1)
    return total / tables.gts_count[rows].float() * 10.0


def self_critical_reward(tables: CiderTables, sample_seq, greedy_seq,
                         img_rows, eos: int):
    """The SCST advantage score(sample) - score(greedy), broadcast over the
    time steps (reference self_critical/utils.py:56-83); both rollouts
    scored in one call over [2 bs] rows, as the reference scores them in
    one compute_score call (utils.py:68-74)."""
    bs, T = sample_seq.shape
    both = torch.cat([sample_seq, greedy_seq], dim=0)
    ids, lens = canonicalize(both, eos, T + 1)
    scores = cider_d(tables, ids, lens, torch.cat([img_rows, img_rows]))
    adv = scores[:bs] - scores[bs:]
    return adv[:, None].expand(bs, T).contiguous()
