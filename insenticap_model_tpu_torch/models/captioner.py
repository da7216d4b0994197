"""Sentiment-controllable attention-LSTM captioner: the serving part.

Counterpart of ``insenticap_model_tpu/models/captioner.py`` (reference
models/captioner.py:121-424): the Up-Down-style two-LSTM decode cell with
content / sentiment-word / gated-fusion attention. Serving runs the cell in
eval mode, so nothing here draws dropout; the teacher-forced and RL
training forwards and the criteria come with the training slice.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from .. import nn
from ..utils.dtypes import resolve_device


def init_params(gen: torch.Generator, vocab_size: int, num_senti_cats: int,
                settings, *, device="cuda", dtype=torch.float32) -> Dict:
    """Parameters with the reference module shapes (captioner.py:132-161)
    and torch-default initialisers drawn from ``gen``."""
    s = settings
    kw = {"dtype": dtype, "device": resolve_device(device)}
    lin = lambda i, o: nn.linear_init(gen, i, o, **kw)  # noqa: E731
    return {
        "word_embed": nn.embedding_init(gen, vocab_size, s.word_emb_dim,
                                        **kw),
        "senti_label_embed": nn.embedding_init(gen, num_senti_cats,
                                               s.word_emb_dim, **kw),
        "fc_embed": lin(s.fc_feat_dim, s.feat_emb_dim),
        "cpt2fc": lin(s.word_emb_dim, s.feat_emb_dim),
        "att_embed": lin(s.att_feat_dim, s.feat_emb_dim),
        "att2att": lin(s.feat_emb_dim, s.att_hid_dim),
        "senti2att": lin(s.word_emb_dim, s.att_hid_dim),
        "att_lstm": nn.lstm_cell_init(
            gen, s.rnn_hid_dim + s.feat_emb_dim + s.word_emb_dim,
            s.rnn_hid_dim, **kw),
        "lang_lstm": nn.lstm_cell_init(
            gen, s.rnn_hid_dim + s.feat_emb_dim, s.rnn_hid_dim, **kw),
        "classifier": lin(s.rnn_hid_dim, vocab_size),
        "attention": {
            "cont": {"h2att": lin(s.rnn_hid_dim, s.att_hid_dim),
                     "att_alpha": lin(s.att_hid_dim, 1)},
            "senti": {"h2word": lin(s.rnn_hid_dim, s.att_hid_dim),
                      "label2word": lin(s.word_emb_dim, s.att_hid_dim),
                      "word_alpha": lin(s.att_hid_dim, 1)},
            "fuse": {"h2att": lin(s.rnn_hid_dim, s.att_hid_dim),
                     "cont2att": lin(s.feat_emb_dim, s.att_hid_dim),
                     "senti2att": lin(s.feat_emb_dim, s.att_hid_dim),
                     "att_alpha": lin(s.att_hid_dim, 1)},
        },
    }


class TokenIds(NamedTuple):
    pad: int
    unk: int
    sos: int
    eos: int
    neutral: int  # index of 'neutral' in the sentiment categories


class DecodeState(NamedTuple):
    """Carried LSTM state: [rows, H] each."""
    h_att: torch.Tensor
    c_att: torch.Tensor
    h_lang: torch.Tensor
    c_lang: torch.Tensor


class DecodeContext(NamedTuple):
    """Per-sequence invariants, embedded once before the decode loop
    (reference captioner.py:198-216, 294-317)."""
    fc: torch.Tensor                             # [bs, Fe]
    att: Optional[torch.Tensor]                  # [bs, N, Fe]
    p_att: Optional[torch.Tensor]                # [bs, N, Ah]
    senti_word: Optional[torch.Tensor]           # [bs, M+1, We]
    p_senti_word: Optional[torch.Tensor]         # [bs, M+1, Ah]
    senti_label: Optional[torch.Tensor]          # [bs, We]


def _relu_linear(p, x):
    return torch.relu(nn.linear(p, x))


def embed_word(params, ids):
    """ReLU'd word embedding with hard-zero pad rows (pad id 0 by
    vocabulary construction; reference captioner.py:133-135)."""
    return torch.relu(nn.embed(params["word_embed"], ids, pad_id=0))


def build_visual_context(params, fc_feats, att_feats, *, senti_words=None,
                         senti_labels=None, pad_id: int = 0
                         ) -> DecodeContext:
    """Embed visual features (+ optional sentiment words/labels) once, in
    eval mode (the JAX package's ``deterministic=True``)."""
    fc = _relu_linear(params["fc_embed"], fc_feats)               # [bs, Fe]
    bs = att_feats.shape[0]
    att = att_feats.reshape(bs, -1, att_feats.shape[-1])          # [bs, N, Fa]
    att = _relu_linear(params["att_embed"], att)                  # [bs, N, Fe]
    # att2att is Linear+ReLU in the reference (captioner.py:149-150)
    p_att = _relu_linear(params["att2att"], att)                  # [bs, N, Ah]

    senti_word = p_senti_word = senti_label = None
    if senti_words is not None:
        # a PAD column gives the sentiment attention a null slot
        # (reference captioner.py:307-309)
        pad_col = torch.full((bs, 1), pad_id, dtype=senti_words.dtype,
                             device=senti_words.device)
        sw = torch.cat([pad_col, senti_words], dim=1)             # [bs, M+1]
        senti_word = embed_word(params, sw)
        p_senti_word = _relu_linear(params["senti2att"], senti_word)
    if senti_labels is not None:
        senti_label = torch.relu(nn.embed(params["senti_label_embed"],
                                          senti_labels))
    return DecodeContext(fc, att, p_att, senti_word, p_senti_word,
                         senti_label)


# ---------------------------------------------------------------------------
# Attention (reference captioner.py:12-118)
# ---------------------------------------------------------------------------

def content_attention(p, h, att, p_att):
    """Additive attention over visual regions (captioner.py:12-35)."""
    h_att = nn.linear(p["h2att"], h)                              # [bs, Ah]
    e = torch.tanh(p_att + h_att[:, None, :])                     # [bs, N, Ah]
    e = nn.linear(p["att_alpha"], e)[..., 0]                      # [bs, N]
    w = torch.softmax(e, dim=-1)
    res = torch.einsum("bn,bnf->bf", w, att)
    return res, w


def senti_attention(p, h, senti_word, p_senti_word, senti_label):
    """Additive attention over sentiment-word embeddings with the label
    folded into the query (captioner.py:38-62)."""
    h_word = nn.linear(p["h2word"], h)
    lab = nn.linear(p["label2word"], senti_label)
    e = torch.tanh(p_senti_word + h_word[:, None, :] + lab[:, None, :])
    e = nn.linear(p["word_alpha"], e)[..., 0]                     # [bs, M+1]
    w = torch.softmax(e, dim=-1)
    res = torch.einsum("bn,bnf->bf", w, senti_word)
    return res, w


def gated_fusion(f, h, cont_res, senti_res):
    """The rl-mode sigmoid gate w*cont + (1-w)*senti (captioner.py:105-118);
    returns (fused, gate)."""
    gate = (nn.linear(f["cont2att"], cont_res)
            + nn.linear(f["senti2att"], senti_res)
            + nn.linear(f["h2att"], h))
    gate = torch.sigmoid(nn.linear(f["att_alpha"], torch.tanh(gate)))
    return gate * cont_res + (1.0 - gate) * senti_res, gate


def fused_attention(p_attn, h, ctx: DecodeContext, mode: str):
    """Mode switch (captioner.py:96-118): (att_result, weights dict)."""
    weights: Dict[str, Any] = {}
    if mode == "seq2seq":
        res, w = senti_attention(p_attn["senti"], h, ctx.senti_word,
                                 ctx.p_senti_word, ctx.senti_label)
        weights["senti"] = w
        return res, weights
    cont_res, wc = content_attention(p_attn["cont"], h, ctx.att, ctx.p_att)
    weights["cont"] = wc
    if mode == "xe":
        return cont_res, weights
    senti_res, ws = senti_attention(p_attn["senti"], h, ctx.senti_word,
                                    ctx.p_senti_word, ctx.senti_label)
    weights["senti"] = ws
    res, gate = gated_fusion(p_attn["fuse"], h, cont_res, senti_res)
    weights["fuse"] = gate
    return res, weights


# ---------------------------------------------------------------------------
# The decode step (reference forward_step, captioner.py:168-186)
# ---------------------------------------------------------------------------

def att_lstm_step(params, ctx: DecodeContext, state: DecodeState, it):
    """Embed token (+ sentiment label) -> attention LSTM: (h_att, c_att)."""
    xt = embed_word(params, it)                                   # [bs, We]
    if ctx.senti_label is not None:
        xt = xt + ctx.senti_label
    a_in = torch.cat([state.h_lang, ctx.fc, xt], dim=1)
    return nn.lstm_cell(params["att_lstm"], a_in, (state.h_att, state.c_att))


def decode_cell(params, ctx: DecodeContext, state: DecodeState, it, *,
                mode: str):
    """The eval-mode decode step up to the vocabulary projection: embed
    token -> att LSTM -> attention -> lang LSTM. Returns (out, new_state,
    weights)."""
    h_att, c_att = att_lstm_step(params, ctx, state, it)
    att_res, weights = fused_attention(params["attention"], h_att, ctx, mode)
    l_in = torch.cat([att_res, h_att], dim=1)
    h_lang, c_lang = nn.lstm_cell(params["lang_lstm"], l_in,
                                  (state.h_lang, state.c_lang))
    return h_lang, DecodeState(h_att, c_att, h_lang, c_lang), weights


def decode_step(params, ctx: DecodeContext, state: DecodeState, it, *,
                mode: str):
    """One eval-mode decoder timestep: decode_cell -> classifier ->
    log-softmax. Returns (logprobs, new_state, weights)."""
    out, new_state, weights = decode_cell(params, ctx, state, it, mode=mode)
    logprobs = nn.log_softmax(nn.linear(params["classifier"], out))
    return logprobs, new_state, weights
