"""Batched beam search for the captioner.

Counterpart of ``insenticap_model_tpu/ops/beam.py::beam_search_batched``
(:111-307), with its semantics kept exactly:

  * candidates run flat as ``[bs*B]`` rows (row = image*B + beam);
  * ranking is the plain sum of log-probs, no length normalisation;
  * a candidate that emitted EOS persists once, in slot 0 of its
    expansion, with its score frozen;
  * PAD/SOS/UNK are banned when pad != eos, and the last word when
    ``decoding_constraint`` is on (reference captioner.py:394-399);
  * logits and the log-softmax normaliser are f32 even with bf16 params;
  * top-k is ``B`` argmax passes, the first index winning a tie
    (``torch.argmax`` returns the first maximal index; ``torch.topk``
    leaves the tie order unspecified, so it is not used); this vocab-wide
    tail is ``ops/fused_topk.classifier_topk_plain``;
  * the loop stops early once every candidate has ended, then a backtrack
    rebuilds the sequences from the per-step (word, parent) records.

On a CUDA batch the decode cell takes the beam-shared attention kernel
(``ops/fused_attention.py``; ``ISC_ATT_KERNEL`` picks v1 or v2), which
reads each image's att/p_att once for all its beams, for any batch size,
where ``fused_attention.kernel_takes`` holds for the beam size, the widths
and the dtype. The CPU, ``return_weights``, ``use_kernels=False`` and what
the kernel does not take (a beam wider than 8) run the plain tiled-rows
cell, as the JAX package's beam sends what its kernel's gate refuses to
the plain cell (its beam.py:157-161). ``ISC_FUSED_TOPK=1``, read at each
call as the JAX package reads it at trace (its beam.py:165-207), sends the
tail through ``fused_topk.classifier_topk`` where
``fused_topk.kernel_takes(beam_size, H, dtype)`` holds (beam size, h's
width and the classifier's dtype): the CUDA kernel for a CUDA
batch, the same plain function on the CPU; it is not taken under
``return_weights`` or ``use_kernels=False``. The beam select
of the LSTM state is a gather by parent (the JAX package's one-hot
product was a TPU layout rule; both are exact).
"""
from __future__ import annotations

import os
from typing import Dict, List

import torch

from .. import nn
from ..models.captioner import (DecodeContext, DecodeState, TokenIds,
                                att_lstm_step, decode_cell, gated_fusion,
                                senti_attention)
from . import fused_attention as fa
from . import fused_topk
# NEG_INF: finite sentinel (-inf arithmetic breaks tie handling)
from .fused_topk import NEG_INF, _topk_argmax


def _tile_ctx(ctx: DecodeContext, B: int) -> DecodeContext:
    """Repeat the per-image context B times -> [bs*B, ...] rows."""
    return DecodeContext(*(None if x is None
                           else x.repeat_interleave(B, dim=0) for x in ctx))


def _decode_cell_shared_att(params, sctx: DecodeContext, att, p_att,
                            state: DecodeState, last_flat, *, mode: str,
                            B: int):
    """decode_cell with the beam-shared content attention: sctx holds the
    beam-tiled small fields while att/p_att stay per image [bs, N, ...]."""
    h_att, c_att = att_lstm_step(params, sctx, state, last_flat)
    p_attn = params["attention"]
    cont_res = fa.beam_content_attention(h_att, p_attn["cont"], att, p_att,
                                         B=B)
    if mode == "xe":
        att_res = cont_res
    else:
        senti_res, _ = senti_attention(p_attn["senti"], h_att,
                                       sctx.senti_word, sctx.p_senti_word,
                                       sctx.senti_label)
        att_res, _ = gated_fusion(p_attn["fuse"], h_att, cont_res, senti_res)
    h_lang, c_lang = nn.lstm_cell(params["lang_lstm"],
                                  torch.cat([att_res, h_att], dim=1),
                                  (state.h_lang, state.c_lang))
    return h_lang, DecodeState(h_att, c_att, h_lang, c_lang)


def beam_search_batched(params, ctx: DecodeContext, *, settings,
                        ids: TokenIds, beam_size: int, max_seq_len: int,
                        mode: str, decoding_constraint: bool = True,
                        early_exit: bool = True,
                        return_weights: bool = False,
                        use_kernels: bool = True):
    """Whole-batch beam decode. ctx: per-image DecodeContext [bs, ...] (not
    beam-tiled). Returns (seqs [bs, beam, max_seq_len] int32, scores
    [bs, beam] in ctx's dtype), sorted by score descending; sequences are
    EOS-terminated, then EOS-padded.

    early_exit: stop once every candidate of every image has emitted EOS;
    the outputs are identical either way. return_weights: also return the
    attention weights along each returned candidate's path, a dict of
    'cont' [bs, beam, T, N] (+ 'senti' [bs, beam, T, M+1] and 'fuse'
    [bs, beam, T, 1] in rl mode); it runs every step on the plain cell.
    use_kernels=False runs the plain cell and the plain tail on the card
    as well."""
    bs = ctx.fc.shape[0]
    B = beam_size
    T = max_seq_len
    dev = ctx.fc.device
    z = torch.zeros((bs * B, settings.rnn_hid_dim), dtype=ctx.fc.dtype,
                    device=dev)
    state = DecodeState(z, z, z, z)
    scores = torch.full((bs, B), NEG_INF, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    last = torch.full((bs, B), ids.sos, dtype=torch.long, device=dev)
    ban_static = [ids.pad, ids.sos, ids.unk] if ids.pad != ids.eos else []
    if return_weights:
        early_exit = False

    w_att = params["attention"]["cont"]["h2att"]["weight"]     # [Ah, H]
    use_fa = (ctx.att is not None and mode in ("xe", "rl")
              and not return_weights and use_kernels and dev.type == "cuda"
              and fa.kernel_takes(B, w_att.shape[1], w_att.shape[0],
                                  ctx.att.shape[-1], ctx.att.dtype))
    if use_fa:
        sctx = _tile_ctx(ctx._replace(att=None, p_att=None), B)
    else:
        bctx = _tile_ctx(ctx, B)
    # the vocab-wide tail: f32 logits and normaliser even with bf16
    # params; the fused kernel takes the params as they are
    w_cls, b_cls = params["classifier"]["weight"], params["classifier"]["bias"]
    fused = (os.environ.get("ISC_FUSED_TOPK") == "1" and use_kernels
             and not return_weights
             and fused_topk.kernel_takes(B, w_cls.shape[1], w_cls.dtype))
    topk = fused_topk.classifier_topk if fused else \
        fused_topk.classifier_topk_plain
    if not fused:   # cast once for the whole decode
        w_cls, b_cls = w_cls.float(), b_cls.float()
    # without the constraint no row bans its last word (the JAX package
    # passes -1, beam.py:203-204)
    no_last = None if decoding_constraint else torch.full(
        (bs * B,), -1, dtype=torch.long, device=dev)
    k_idx = torch.arange(B, device=dev)

    words_buf = torch.full((T, bs, B), ids.eos, dtype=torch.long, device=dev)
    parent_buf = k_idx.expand(T, bs, B).clone()
    wts_steps: List[Dict[str, torch.Tensor]] = []

    for t in range(T):
        if early_exit and t > 0 and bool((last == ids.eos).all()):
            break
        if use_fa:
            out, new_state = _decode_cell_shared_att(
                params, sctx, ctx.att, ctx.p_att, state, last.reshape(-1),
                mode=mode, B=B)
            wts = {}
        else:
            out, new_state, wts = decode_cell(params, bctx, state,
                                              last.reshape(-1), mode=mode)
        topv2, topi2 = topk(                                  # [bs*B, B]
            out, w_cls, b_cls,
            last.reshape(-1) if decoding_constraint else no_last,
            k=B, banned=ban_static)

        ended = (last == ids.eos) if t > 0 else torch.zeros_like(
            last, dtype=torch.bool)
        topv = topv2.reshape(bs, B, B)
        topi = topi2.reshape(bs, B, B)
        # live candidates expand; ended candidates persist once (slot 0)
        frozen = torch.where(k_idx == 0, scores[..., None],
                             torch.full_like(topv, NEG_INF))
        cand_scores = torch.where(ended[..., None], frozen,
                                  scores[..., None] + topv)   # [bs, B, B]
        cand_words = torch.where(ended[..., None],
                                 torch.full_like(topi, ids.eos), topi)
        new_scores, flat_idx = _topk_argmax(cand_scores.reshape(bs, B * B),
                                            B)                # [bs, B]
        parent = flat_idx // B
        words = cand_words.reshape(bs, B * B).gather(1, flat_idx)

        rows = parent[..., None]

        def sel(f):
            fb = f.reshape(bs, B, -1)
            return fb.gather(1, rows.expand(-1, -1, fb.shape[-1])).reshape(
                bs * B, -1)
        state = DecodeState(*(sel(f) for f in new_state))
        if return_weights:
            # per pre-selection row; the backtrack resolves each path
            wts_steps.append({k: v.reshape(bs, B, *v.shape[1:])
                              for k, v in wts.items()})
        words_buf[t] = words
        parent_buf[t] = parent
        scores, last = new_scores, words

    # backtrack from the final beam order; the weights of the token emitted
    # at step t by the candidate in slot k were computed at its parent row
    beam_idx = k_idx.expand(bs, B)
    seq_cols = [None] * T
    sel_wts: List[Dict[str, torch.Tensor]] = [None] * len(wts_steps)
    for t in reversed(range(T)):
        seq_cols[t] = words_buf[t].gather(1, beam_idx)
        prev = parent_buf[t].gather(1, beam_idx)
        if return_weights:
            sel_wts[t] = {
                k: a.gather(1, prev.reshape(bs, B, *([1] * (a.dim() - 2)))
                            .expand(-1, -1, *a.shape[2:]))
                for k, a in wts_steps[t].items()}
        beam_idx = prev
    seqs = torch.stack(seq_cols, dim=-1).to(torch.int32)      # [bs, B, T]
    scores = scores.to(ctx.fc.dtype)
    if not return_weights:
        return seqs, scores
    weights = {k: torch.stack([s[k] for s in sel_wts], dim=2)
               for k in sel_wts[0]}
    return seqs, scores, weights
