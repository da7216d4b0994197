"""Sentence sentiment classifier (reference models/sent_senti_cls.py:6-72).

Counterpart of ``insenticap_model_tpu/models/sent_senti_cls.py`` (:23-99):
embedding (+ReLU+dropout) -> unidirectional LSTM -> a squeeze-excitation
gate whose per-token scalar weights pool the sentence representation (and
later weight the RL stage's per-token rewards). The reference's pack/pad
collapses to a fixed-T loop and a length mask, applied to the LSTM outputs
and again to the excitation: a unidirectional LSTM's outputs at t < len do
not depend on later inputs, so the values are the same. The per-token
weight is the mean of the excitation over the hidden width (the
reference's AdaptiveAvgPool1d(1) over channels, :30, :50).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .. import nn
from ..utils.dtypes import resolve_device


def init_params(gen: torch.Generator, vocab_size: int, num_senti_cats: int,
                settings, *, device="cuda", dtype=torch.float32) -> Dict:
    H = settings.rnn_hid_dim
    kw = {"dtype": dtype, "device": resolve_device(device)}
    return {
        "word_embed": nn.embedding_init(gen, vocab_size,
                                        settings.word_emb_dim, **kw),
        "lstm": nn.lstm_cell_init(gen, settings.word_emb_dim, H, **kw),
        "excitation1": nn.linear_init(gen, H, H, **kw),
        "excitation2": nn.linear_init(gen, H, H, **kw),
        "cls1": nn.linear_init(gen, H, H, **kw),
        "cls2": nn.linear_init(gen, H, num_senti_cats, **kw),
    }


def forward(params, seqs, lengths, *, settings,
            gen: Optional[torch.Generator] = None,
            deterministic: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """seqs [bs, T] ids without the leading SOS (callers pass
    captions[:, 1:], reference decoder.py:134), lengths [bs]. Returns
    (logits [bs, S], att_weights [bs, T]); dropout draws from ``gen``
    unless deterministic."""
    p = settings.dropout_p
    bs, T = seqs.shape
    x = torch.relu(nn.embed(params["word_embed"], seqs, pad_id=0))
    x = nn.dropout(gen, x, p, deterministic)                      # [bs, T, We]

    h = torch.zeros((bs, settings.rnn_hid_dim), dtype=x.dtype,
                    device=x.device)
    hc = (h, h)
    outs = []
    for t in range(T):
        hc = nn.lstm_cell(params["lstm"], x[:, t], hc)
        outs.append(hc[0])
    out = torch.stack(outs, dim=1)                                # [bs, T, H]
    mask = (torch.arange(T, device=seqs.device)[None, :]
            < lengths[:, None]).to(out.dtype)
    out = out * mask[..., None]           # pack/pad zeroing (reference :40-42)
    out = nn.dropout(gen, out, p, deterministic)

    ex = torch.relu(nn.linear(params["excitation1"], out))
    ex = torch.sigmoid(nn.linear(params["excitation2"], ex))     # [bs, T, H]
    ex = ex * mask[..., None]             # second pack/pad (reference :47-49)
    weights = ex.mean(dim=-1)             # AdaptiveAvgPool1d(1) -> [bs, T]

    sent_feats = torch.einsum("bt,bth->bh", weights, out)        # [bs, H]
    h1 = torch.relu(nn.linear(params["cls1"], sent_feats))
    if not deterministic:
        h1 = nn.dropout(gen, h1, p, deterministic)
    logits = nn.linear(params["cls2"], h1)                       # [bs, S]
    return logits, weights


def sample(params, seqs, lengths, *, settings):
    """argmax labels (int32) and attention weights (reference :58-68)."""
    logits, weights = forward(params, seqs, lengths, settings=settings)
    return logits.argmax(dim=-1).to(torch.int32), weights


def xent_nll_rows(params, seqs, lengths, labels, *, settings,
                  gen: Optional[torch.Generator] = None,
                  deterministic: bool = True):
    """Per-row cross entropy; deterministic by default (the masked eval
    aggregation's building block)."""
    logits, _ = forward(params, seqs, lengths, settings=settings, gen=gen,
                        deterministic=deterministic)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0]


def xent_loss(params, seqs, lengths, labels, *, settings, gen,
              deterministic: bool):
    return xent_nll_rows(params, seqs, lengths, labels, settings=settings,
                         gen=gen, deterministic=deterministic).mean()
