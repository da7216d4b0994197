"""Sentiment-controllable attention-LSTM captioner.

Counterpart of ``insenticap_model_tpu/models/captioner.py`` (reference
models/captioner.py:121-424): the Up-Down-style two-LSTM decode cell with
content / sentiment-word / gated-fusion attention, the teacher-forced
(``forward_xe``, ``forward_seq2seq``) and rollout (``forward_rl``) training
forwards, and the criteria. Where the JAX package runs a ``lax.scan`` the
port runs a Python loop over the fixed ``max_seq_len`` steps.

Randomness (dropout masks, scheduled sampling, multinomial rollouts)
draws from one ``torch.Generator`` on the tensors' device, passed as
``gen``: the JAX package splits keys instead, so the two agree in
distribution, not draw for draw. Every draw is one a row of the global
batch (``parallel.mesh.rank_rows``), so that a data-parallel rank's rows
get the draws they get in one process; the rollouts' tokens come from an
inverse CDF at one uniform a row (``_categorical``).
``deterministic=True`` (the default of the eval-mode entries serving
uses) draws nothing and returns the inputs of every dropout site
unchanged.

Inside ``parallel.vocab.sharded(shard)`` (the train and eval steps of a
captioner sharded over a ``[dp, tp]`` mesh's model axis) the params hold
this rank's rows of the word embedding and the classifier, and the
vocabulary's operations (the word lookups, the classifier's input and
log-softmax, ``_categorical``, the rollouts' argmax and picked log-probs,
``xe_criterion_sums``' pick) are ``parallel/vocab.py``'s, over the model
group; the logprobs are then this rank's columns. Outside it they run
the one-process code.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from .. import nn
from ..parallel import mesh, vocab
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
    shard = vocab.current()
    if shard is None:
        return torch.relu(nn.embed(params["word_embed"], ids, pad_id=0))
    x = vocab.embed(params["word_embed"]["weight"], ids, shard)
    return torch.relu(x * (ids != 0).unsqueeze(-1).to(x.dtype))


def init_state(batch: int, hid_dim: int, dtype=torch.float32,
               device="cpu") -> DecodeState:
    z = torch.zeros((batch, hid_dim), dtype=dtype, device=device)
    return DecodeState(z, z, z, z)


def concept_fc(params, cpt_words):
    """Concept words -> mean word embedding -> fc space (reference
    captioner.py:201-203); the pre-dropout cpt_feats of the
    domain-alignment loss."""
    cpt = embed_word(params, cpt_words).mean(dim=1)               # [bs, We]
    return _relu_linear(params["cpt2fc"], cpt)                    # [bs, Fe]


def _senti_word_column(params, senti_words, pad_id):
    """A PAD column prepended gives the sentiment attention a null slot
    (reference captioner.py:307-309); -> ReLU'd embeddings [bs, M+1, We]."""
    pad_col = torch.full((senti_words.shape[0], 1), pad_id,
                         dtype=senti_words.dtype, device=senti_words.device)
    return embed_word(params, torch.cat([pad_col, senti_words], dim=1))


def _label_embed(params, senti_labels):
    return torch.relu(nn.embed(params["senti_label_embed"], senti_labels))


def build_visual_context_train(params, fc_feats, att_feats, dropout_p: float,
                               gen, deterministic: bool, *, senti_words=None,
                               senti_labels=None, pad_id: int = 0):
    """Embed visual features (+ optional sentiment words/labels) once.
    Returns (ctx, aux) with aux's pre-dropout ``fc_emb`` for the
    domain-alignment MSE (reference captioner.py:199, decoder.py:89). One
    mask a site a forward, not a step (reference captioner.py:198-214),
    drawn in the JAX package's order: fc, att, sentiment words, label."""
    fc_emb = _relu_linear(params["fc_embed"], fc_feats)           # [bs, Fe]
    fc = nn.dropout(gen, fc_emb, dropout_p, deterministic)
    bs = att_feats.shape[0]
    att = att_feats.reshape(bs, -1, att_feats.shape[-1])          # [bs, N, Fa]
    att = _relu_linear(params["att_embed"], att)                  # [bs, N, Fe]
    att = nn.dropout(gen, att, dropout_p, deterministic)
    # att2att is Linear+ReLU in the reference (captioner.py:149-150)
    p_att = _relu_linear(params["att2att"], att)                  # [bs, N, Ah]

    senti_word = p_senti_word = senti_label = None
    if senti_words is not None:
        senti_word = nn.dropout(gen, _senti_word_column(params, senti_words,
                                                        pad_id),
                                dropout_p, deterministic)
        p_senti_word = _relu_linear(params["senti2att"], senti_word)
    if senti_labels is not None:
        senti_label = nn.dropout(gen, _label_embed(params, senti_labels),
                                 dropout_p, deterministic)
    ctx = DecodeContext(fc, att, p_att, senti_word, p_senti_word,
                        senti_label)
    return ctx, {"fc_emb": fc_emb}


def build_visual_context(params, fc_feats, att_feats, *, senti_words=None,
                         senti_labels=None, pad_id: int = 0
                         ) -> DecodeContext:
    """The eval-mode context (the JAX package's ``deterministic=True``)."""
    return build_visual_context_train(
        params, fc_feats, att_feats, 0.0, None, True,
        senti_words=senti_words, senti_labels=senti_labels,
        pad_id=pad_id)[0]


def build_seq2seq_context(params, cpt_words, senti_words, senti_labels,
                          dropout_p: float, gen, deterministic: bool,
                          pad_id: int = 0) -> DecodeContext:
    """Text-only context: cpt_feats stand in for the fc features; no
    visual attention (reference captioner.py:247-263)."""
    fc = nn.dropout(gen, concept_fc(params, cpt_words), dropout_p,
                    deterministic)
    senti_word = nn.dropout(gen, _senti_word_column(params, senti_words,
                                                    pad_id),
                            dropout_p, deterministic)
    p_senti_word = _relu_linear(params["senti2att"], senti_word)
    senti_label = nn.dropout(gen, _label_embed(params, senti_labels),
                             dropout_p, deterministic)
    return DecodeContext(fc, None, None, senti_word, p_senti_word,
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
                mode: str, dropout_p: float = 0.0, gen=None,
                deterministic: bool = True):
    """The decode step up to the vocabulary projection: embed token ->
    att LSTM -> attention -> lang LSTM -> dropout (eval mode by default).
    Returns (out, new_state, weights)."""
    h_att, c_att = att_lstm_step(params, ctx, state, it)
    att_res, weights = fused_attention(params["attention"], h_att, ctx, mode)
    l_in = torch.cat([att_res, h_att], dim=1)
    h_lang, c_lang = nn.lstm_cell(params["lang_lstm"], l_in,
                                  (state.h_lang, state.c_lang))
    out = nn.dropout(gen, h_lang, dropout_p, deterministic)
    return out, DecodeState(h_att, c_att, h_lang, c_lang), weights


def decode_step(params, ctx: DecodeContext, state: DecodeState, it, *,
                mode: str, dropout_p: float = 0.0, gen=None,
                deterministic: bool = True):
    """One decoder timestep: decode_cell -> classifier -> log-softmax.
    Returns (logprobs, new_state, weights)."""
    out, new_state, weights = decode_cell(
        params, ctx, state, it, mode=mode, dropout_p=dropout_p, gen=gen,
        deterministic=deterministic)
    return log_probs(params, out), new_state, weights


def log_probs(params, out):
    """The classifier and the log-softmax over the vocabulary: out [rows,
    H] -> [rows, V] (a shard's columns inside ``vocab.sharded``)."""
    shard = vocab.current()
    if shard is None:
        return nn.log_softmax(nn.linear(params["classifier"], out))
    return vocab.log_softmax(nn.linear(
        params["classifier"], vocab.copy_to_model(out, shard)), shard)


def _uniform_rows(gen, rows: int, device):
    """One uniform in [0, 1) a row, drawn for the global batch under data
    parallelism and this rank's rows kept (``mesh.rank_rows``)."""
    return mesh.rank_rows(
        lambda n: torch.rand((n,), generator=gen, device=device), rows)


def _categorical(gen, logprobs):
    """One draw a row from the distribution exp(logprobs) -> [rows]: the
    inverse CDF at one uniform a row, the first index whose cumulative
    probability exceeds u times the row's total (a zero-probability index
    is never taken). A rank draws the global batch's uniforms, so its rows
    get the tokens they get in one process. The CDF is summed in float64:
    a sum in another order (a vocabulary sharded over a model axis,
    ``parallel.vocab.categorical``) then parts from it by far less than
    any token's mass, and takes the same tokens."""
    u = _uniform_rows(gen, logprobs.shape[0], logprobs.device)
    shard = vocab.current()
    if shard is not None:
        return vocab.categorical(logprobs, u, shard)
    cdf = logprobs.double().exp().cumsum(dim=-1)
    idx = torch.searchsorted(cdf, (u.double() * cdf[:, -1])[:, None],
                             right=True)
    return idx[:, 0].clamp_max(cdf.shape[-1] - 1)


def _pick(logprobs, ids):
    """``logprobs[..., ids]`` (ids with logprobs' leading axes)."""
    shard = vocab.current()
    if shard is not None:
        return vocab.pick(logprobs, ids, shard)
    return logprobs.gather(-1, ids.long().unsqueeze(-1)).squeeze(-1)


def _greedy(logprobs):
    """(the first maximal index a row, its log-prob)."""
    shard = vocab.current()
    if shard is not None:
        return vocab.argmax(logprobs, shard)
    return logprobs.argmax(dim=-1), logprobs.amax(dim=-1)


# ---------------------------------------------------------------------------
# Teacher-forced forwards (xe / seq2seq) with scheduled sampling
# (reference captioner.py:194-288)
# ---------------------------------------------------------------------------

def _teacher_forced_scan(params, ctx: DecodeContext, captions, *, mode: str,
                         dropout_p: float, gen, ss_prob: float,
                         deterministic: bool, hid_dim: int):
    """captions [bs, T+1] padded ids SOS...EOS -> logprobs [bs, T, V] of
    the steps predicting captions[:, 1:]. Scheduled sampling (reference
    captioner.py:218-228): at t >= 1, with probability ss_prob a row, the
    input is a draw from the previous step's distribution instead of the
    ground truth."""
    bs, tp1 = captions.shape
    state = init_state(bs, hid_dim, ctx.fc.dtype, ctx.fc.device)
    outs = []
    for t in range(tp1 - 1):
        it = captions[:, t]
        if not deterministic and t >= 1 and ss_prob > 0:
            use = _uniform_rows(gen, bs, captions.device) < ss_prob
            it = torch.where(use, _categorical(gen, outs[-1].detach()),
                             it.long())
        logprobs, state, _ = decode_step(
            params, ctx, state, it, mode=mode, dropout_p=dropout_p, gen=gen,
            deterministic=deterministic)
        outs.append(logprobs)
    return torch.stack(outs, dim=1)


def forward_xe(params, fc_feats, att_feats, cpt_words, captions,
               senti_labels, *, settings, gen=None, ss_prob: float = 0.0,
               deterministic: bool = False):
    """XE teacher forcing (reference forward_xe, captioner.py:194-240).
    Returns (logprobs [bs, T, V], aux) with aux = {fc_emb, cpt_feats} for
    the domain-alignment loss MSE(cpt_feats, fc_emb.detach()) (reference
    train_xe.py:163)."""
    p = settings.dropout_p
    ctx, caux = build_visual_context_train(params, fc_feats, att_feats, p,
                                           gen, deterministic)
    # the label embedding is added to the word embedding in xe mode too
    lab = nn.dropout(gen, _label_embed(params, senti_labels), p,
                     deterministic)
    ctx = ctx._replace(senti_label=lab)
    cpt_feats = concept_fc(params, cpt_words)
    logprobs = _teacher_forced_scan(
        params, ctx, captions, mode="xe", dropout_p=p, gen=gen,
        ss_prob=ss_prob, deterministic=deterministic,
        hid_dim=settings.rnn_hid_dim)
    return logprobs, {"fc_emb": caux["fc_emb"], "cpt_feats": cpt_feats}


def forward_seq2seq(params, senti_captions, cpt_words, senti_words,
                    senti_labels, *, settings, gen=None,
                    ss_prob: float = 0.0, deterministic: bool = False):
    """Text-only seq2seq mode (reference forward_seq2seq,
    captioner.py:242-288)."""
    ctx = build_seq2seq_context(params, cpt_words, senti_words, senti_labels,
                                settings.dropout_p, gen, deterministic)
    return _teacher_forced_scan(
        params, ctx, senti_captions, mode="seq2seq",
        dropout_p=settings.dropout_p, gen=gen, ss_prob=ss_prob,
        deterministic=deterministic, hid_dim=settings.rnn_hid_dim)


def forward_rl(params, fc_feats, att_feats, cpt_words, senti_words,
               senti_labels, *, settings, ids: TokenIds, max_seq_len: int,
               sample_max: bool, gen=None, deterministic: bool = False):
    """Greedy (``sample_max``) or multinomial rollout of max_seq_len steps
    (reference forward_rl, captioner.py:290-349), with the reference's
    masks: seq_masks[:, t] is the row's ``unfinished`` before step t, a
    finished row emits pad (0), and a row finishes on emitting EOS; the
    reference's all-EOS early break only skips all-masked steps.
    Returns (seq [bs, T] int32, seq_logprobs [bs, T], seq_masks [bs, T],
    aux)."""
    p = settings.dropout_p
    ctx, caux = build_visual_context_train(
        params, fc_feats, att_feats, p, gen, deterministic,
        senti_words=senti_words, senti_labels=senti_labels, pad_id=ids.pad)
    cpt_feats = concept_fc(params, cpt_words)
    bs = fc_feats.shape[0]
    dev = fc_feats.device
    state = init_state(bs, settings.rnn_hid_dim, ctx.fc.dtype, dev)
    it = torch.full((bs,), ids.sos, dtype=torch.long, device=dev)
    unfinished = torch.ones((bs,), dtype=torch.bool, device=dev)
    seq, seq_lp, masks = [], [], []
    for _ in range(max_seq_len):
        logprobs, state, _ = decode_step(
            params, ctx, state, it, mode="rl", dropout_p=p, gen=gen,
            deterministic=deterministic)
        if sample_max:
            nxt, samp_lp = _greedy(logprobs)
        else:
            nxt = _categorical(gen, logprobs.detach())
            samp_lp = _pick(logprobs, nxt)
        masks.append(unfinished)
        nxt = torch.where(unfinished, nxt, torch.zeros_like(nxt))
        unfinished = unfinished & (nxt != ids.eos)
        seq.append(nxt)
        seq_lp.append(samp_lp)
        it = nxt
    seq_lp = torch.stack(seq_lp, dim=1)
    aux = {"fc_emb": caux["fc_emb"], "cpt_feats": cpt_feats}
    return (torch.stack(seq, dim=1).to(torch.int32), seq_lp,
            torch.stack(masks, dim=1).to(seq_lp.dtype), aux)


# ---------------------------------------------------------------------------
# Losses (reference XECriterion captioner.py:427-440, RewardCriterion
# self_critical/utils.py:169-177)
# ---------------------------------------------------------------------------

def length_mask(lengths, max_len: int, dtype=torch.float32):
    """mask[i, t] = t < lengths[i]."""
    t = torch.arange(max_len, device=lengths.device)[None, :]
    return (t < lengths[:, None]).to(dtype)


def xe_criterion_sums(logprobs, targets, lengths):
    """(masked NLL sum, unmasked token count): the sum form of
    xe_criterion, for batch-boundary-invariant eval aggregation (rows
    left out of an eval get length 0 and add nothing)."""
    mask = length_mask(lengths, targets.shape[1], logprobs.dtype)
    nll = -_pick(logprobs, targets)
    return (nll * mask).sum(), mask.sum()


def xe_criterion(logprobs, targets, lengths):
    """Length-masked NLL over the unmasked tokens. logprobs [bs, T, V],
    targets [bs, T], lengths [bs]."""
    s, c = xe_criterion_sums(logprobs, targets, lengths)
    return s / c


def reward_criterion_sums(seq_logprobs, seq_masks, rewards):
    """(sum of -logprob * mask * reward, mask sum)."""
    return (-seq_logprobs * seq_masks * rewards).sum(), seq_masks.sum()


def reward_criterion(seq_logprobs, seq_masks, rewards):
    """-logprob * mask * reward over the mask sum."""
    s, c = reward_criterion_sums(seq_logprobs, seq_masks, rewards)
    return s / c


def domain_alignment_sums(cpt_feats, fc_emb, row_mask):
    """(masked per-row MSE sum, row count) over the rows of row_mask."""
    per_row = ((cpt_feats - fc_emb.detach()) ** 2).mean(dim=-1)
    return (per_row * row_mask).sum(), row_mask.sum()


def domain_alignment_loss(cpt_feats, fc_emb):
    """MSE(cpt_feats, fc_emb.detach()) (reference train_xe.py:163,
    decoder.py:89: the fc side is detached)."""
    return ((cpt_feats - fc_emb.detach()) ** 2).mean()
