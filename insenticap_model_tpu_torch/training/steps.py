"""Train and eval steps: the XE stage, the RL stage and the three head
stages.

Counterpart of ``insenticap_model_tpu/training/steps.py``, with the
reference trainers' loss semantics:

  XE stage      train_xe.py:144-196: XE on the captions, the
                domain-alignment MSE between the concept and image
                embeddings, and the text-only seq2seq XE on a
                sentiment-corpus batch, with the captions' sentiment
                labels given by the frozen sentence classifier (pseudo
                labels, under ``torch.no_grad``)
  RL stage      models/decoder.py:52-180: SCST (a multinomial rollout
                against the greedy baseline, rewarded by CIDEr-D on the
                device and the frozen classifier's per-token reward),
                with the domain-alignment, XE and seq2seq auxiliary
                losses
  concept       train_cpt.py: the multi-label BCE
  sentiment     train_senti.py: cross entropy (either detector head,
                ``sentiment_detector.module_for``)
  sentence-cls  train_sent_senti_cls_rnn.py: cross entropy

Under data parallelism (``parallel.mesh``, one process a rank, each with
its rows of the global batch) every training loss is a rank's local sum
over the global count (the counts all-reduced before the backward pass),
the gradients are summed over the ranks before the optimizer's clamp and
Adam, and the returned losses are the global batch's: the ranks' step is
the one-process step on the global batch (an average of per-rank means
would not be, wherever the ranks' token or row counts differ). With one
rank each collective is the identity. The eval steps run no collective
(every rank evaluates the whole split).

On a ``[dp, tp]`` mesh those sums run over the rank's data group, and a
captioner stage's steps read the rank's shard of the vocabulary from the
optimizer (``opt.shard``, set by ``optim.shard_captioner``; None where
nothing is sharded): its forward passes run inside
``parallel.vocab.sharded(opt.shard)``, so that the
captioner's word lookups, classifier, log-softmax, draws and picks
(train and eval steps alike) are ``parallel/vocab.py``'s over the model
group. Every rank of a model group then computes the same losses, the
whole gradient of every replicated leaf and its shard's of the two vocab
leaves, which the clamp and Adam update element by element.

A train step is plain PyTorch with autograd (the JAX package's training
steps reach no Pallas kernel either; in the RL step only the frozen
detector's bf16 forward does, under ``torch.no_grad``); the gradient
clamp and Adam are ``optim.Adam``. A head stage's train step runs forward
and backward under ``nn.exact_numerics``, so that the detector's f32
convolutions and their gradients stay f32 on the card (cuDNN's default is
TF32). Eval steps run under ``torch.no_grad``: on a CUDA bf16 batch the
detector's eval forward takes the Winograd kernels, which refuse operands
that require grad.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from .. import nn
from ..models import captioner as cap
from ..models import concept_detector as cpt_det
from ..models import sent_senti_cls as ss_cls
from ..models import sentiment_detector as senti_det
from ..ops import ciderd_device, lm_device
from ..parallel import mesh, vocab
from . import optim

CLS_FLAG = 0.4        # reference decoder.py:39
SEQ_FLAG = 1.0        # reference decoder.py:40
SENTI_THRESHOLD = 0.7  # reference decoder.py:41
RL_XE_SS_PROB = 0.5   # reference decoder.py:139
RL_SEQ_SS_PROB = 0.25  # reference decoder.py:155
# the RL train step's loss terms, summed in this order (the rewards are
# reported, not differentiated)
RL_LOSS_TERMS = ("cap_loss", "da_loss", "xe_loss", "seq2seq_loss")


def _row_mask(batch, bs: int, dtype=torch.float32, device="cpu"):
    """1.0 for true rows, 0.0 for the eval loader's padding rows (its last
    batch repeats the last item and carries ``valid``); a batch without
    ``valid`` is all true rows."""
    valid = batch.get("valid")
    if valid is None:
        return torch.ones((bs,), dtype=dtype, device=device)
    return (torch.arange(bs, device=device) < valid).to(dtype)


def _global_shares(sums: Dict[str, torch.Tensor],
                   counts: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each term's local sum over its global count (the counts summed over
    the ranks in float32, then cast to the sum's type): the shares of the
    ranks add up to the global batch's loss, and so do their gradients."""
    keys = list(sums)
    total = mesh.all_reduce_sum(torch.stack([counts[k].float()
                                             for k in keys]))
    return {k: sums[k] / total[i].to(sums[k].dtype)
            for i, k in enumerate(keys)}


def _global_values(shares: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The detached shares summed over the ranks: the global batch's
    losses."""
    keys = list(shares)
    total = mesh.all_reduce_sum(torch.stack([shares[k].detach()
                                             for k in keys]))
    return {k: total[i] for i, k in enumerate(keys)}


def _apply_gradients(opt: optim.Adam, loss: torch.Tensor) -> None:
    """Backward from a rank's share, its gradients summed over the ranks,
    then the clamp and Adam on the global gradient."""
    loss.backward()
    mesh.reduce_gradients(opt.params)
    opt.step()


@torch.no_grad()
def _pseudo_senti_labels(cls_params, caps, lengths, settings):
    """The frozen classifier's labels of the ground-truth captions
    (train_xe.py:155-158, decoder.py:133-136)."""
    logits, _ = ss_cls.forward(cls_params, caps[:, 1:], lengths,
                               settings=settings, deterministic=True)
    return logits.argmax(dim=-1)


def make_xe_steps(settings, opt: optim.Adam):
    """Returns (train_step, eval_step) for the captioner ``opt.params``
    (this rank's ``opt.shard`` of its vocabulary where it is sharded).

    batch: {fc, att, caps [bs, T+1], lengths, cpts}
    scs_batch: {caps, lengths, cpts, sentis, senti_labels}

    ``train_step(cls_params, batch, scs_batch, gen, ss_prob)`` takes one
    optimizer step and returns the detached losses of the global batch
    (the JAX package's keys); ``gen`` is the step's generator on the
    device, seeded alike on every rank.
    ``eval_step(cls_params, batch)`` returns masked (sums, counts) of the
    XE and domain-alignment terms."""
    params, shard = opt.params, opt.shard

    def _train_sums(cls_params, batch, scs_batch, gen, ss_prob: float):
        """The terms' (sums, counts) on this rank's rows: XE, domain
        alignment and seq2seq (train_xe.py:144-183)."""
        caps = batch["caps"]
        labels = _pseudo_senti_labels(cls_params, caps, batch["lengths"],
                                      settings)
        logprobs, aux = cap.forward_xe(
            params, batch["fc"], batch["att"], batch["cpts"], caps, labels,
            settings=settings, gen=gen, ss_prob=ss_prob,
            deterministic=False)
        sums, counts = {}, {}
        sums["xe_loss"], counts["xe_loss"] = cap.xe_criterion_sums(
            logprobs, caps[:, 1:], batch["lengths"])
        sums["da_loss"], counts["da_loss"] = cap.domain_alignment_sums(
            aux["cpt_feats"], aux["fc_emb"],
            _row_mask(batch, caps.shape[0], device=caps.device))
        s2s_logprobs = cap.forward_seq2seq(
            params, scs_batch["caps"], scs_batch["cpts"],
            scs_batch["sentis"], scs_batch["senti_labels"],
            settings=settings, gen=gen, ss_prob=ss_prob,
            deterministic=False)
        sums["seq2seq_loss"], counts["seq2seq_loss"] = \
            cap.xe_criterion_sums(s2s_logprobs, scs_batch["caps"][:, 1:],
                                  scs_batch["lengths"])
        return sums, counts

    def train_step(cls_params, batch, scs_batch, gen, ss_prob: float):
        opt.zero_grad()
        with vocab.sharded(shard):
            shares = _global_shares(*_train_sums(cls_params, batch,
                                                 scs_batch, gen, ss_prob))
        _apply_gradients(opt, sum(shares.values()))
        losses = _global_values(shares)
        losses["cap_loss"] = losses["xe_loss"] + losses["da_loss"]
        losses["all_loss"] = losses["cap_loss"] + losses["seq2seq_loss"]
        return losses

    @torch.no_grad()
    def eval_step(cls_params, batch):
        """Masked per-term (sums, counts): the eval loader's padding rows
        add nothing, and the caller divides the summed sums by the summed
        counts, so the val loss does not depend on how the split is
        batched (reference val loop: train_xe.py:216-217)."""
        caps = batch["caps"]
        rmask = _row_mask(batch, caps.shape[0], device=caps.device)
        lengths = batch["lengths"] * rmask.to(batch["lengths"].dtype)
        labels = _pseudo_senti_labels(cls_params, caps, batch["lengths"],
                                      settings)
        with vocab.sharded(shard):
            logprobs, aux = cap.forward_xe(
                params, batch["fc"], batch["att"], batch["cpts"], caps,
                labels, settings=settings, deterministic=True)
            xe_sum, xe_cnt = cap.xe_criterion_sums(logprobs, caps[:, 1:],
                                                   lengths)
        da_sum, da_cnt = cap.domain_alignment_sums(aux["cpt_feats"],
                                                   aux["fc_emb"], rmask)
        return ({"xe_loss": xe_sum, "da_loss": da_sum},
                {"xe_loss": xe_cnt, "da_loss": da_cnt})

    return train_step, eval_step


# ---------------------------------------------------------------------------
# RL stage (the reference Detector.forward inner loop, decoder.py:52-180)
# ---------------------------------------------------------------------------

class RLModels(NamedTuple):
    """The trainable captioner's frozen companions."""
    senti_detector: Any
    sent_senti_cls: Any


@torch.no_grad()
def _cls_reward(cls_params, sample_seq, seq_masks, senti_labels, settings):
    """The per-token classifier reward (reference get_cls_reward,
    self_critical/utils.py:120-151): 1{pred == target} x the classifier's
    excitation weights. No baseline (SURVEY.md §8.9)."""
    lens = seq_masks.sum(dim=-1).to(torch.int32)
    logits, weights = ss_cls.forward(cls_params, sample_seq, lens,
                                     settings=settings, deterministic=True)
    correct = (logits.argmax(dim=-1) == senti_labels).to(weights.dtype)
    return correct[:, None] * weights


def make_rl_steps(settings, opt: optim.Adam, ids: cap.TokenIds,
                  max_seq_len: int,
                  cider_tables: Optional[ciderd_device.CiderTables],
                  lm_tables: Optional[lm_device.LMTables] = None,
                  lm_flag: float = 0.0):
    """The RL steps of the captioner ``opt.params`` (this rank's
    ``opt.shard`` of its vocabulary where it is sharded), keyed
    (data_type, training).

    fact batch: {fc, att, caps, lengths, cpts, sentis, img_rows}
    senti batch: {fc, att, cpts, sentis, senti_labels}
    scs_batch as in XE.

    ``train_step(frozen, batch, scs_batch, gen)`` takes one optimizer step
    on the global batch and returns its detached losses and rewards (the
    JAX package's keys; each a local sum over the global count, as in
    ``make_xe_steps``); ``eval_step(frozen, batch, gen)`` returns masked
    (sums, counts) a term, so that the eval loader's padding rows add
    nothing, and draws as one process does (``mesh.whole_batch``: every
    rank evaluates the same whole batch). ``frozen`` is an ``RLModels``;
    ``gen`` the step's generator (dropout, the multinomial rollout,
    scheduled sampling), seeded alike on every rank. The
    scheduled-sampling probabilities are read here, when the steps are
    built. The rollouts run all ``max_seq_len`` steps, so every rank
    takes as many draws as one process.

    The frozen detector labels the fact and eval batches in the dtype of
    its staged params (the JAX step's rule, steps.py:185-193): bf16 takes
    the Winograd kernels on the card, f32 the direct convolution (no TF32).
    It, the greedy rollout and every reward run under ``torch.no_grad``;
    the multinomial rollout stays on the plain, differentiable decode
    cell. lm_tables / lm_flag: the optional per-sentiment trigram LM
    reward, lm_flag * sign(lm(greedy) - lm(sample)) (``ops/lm_device.py``;
    the reference's is wired but off, train_rl.py:212-216)."""
    params, shard = opt.params, opt.shard
    det = senti_det.module_for(settings)
    xe_ss, s2s_ss = RL_XE_SS_PROB, RL_SEQ_SS_PROB

    @torch.no_grad()
    def _detect(frozen: RLModels, att):
        det_params = frozen.senti_detector
        dt = det_params["convs"][0]["weight"].dtype
        with nn.exact_numerics():
            labels, _, _ = det.sample(det_params, att.to(dt),
                                      SENTI_THRESHOLD, ids.neutral)
        return labels

    def _sums(frozen: RLModels, batch, scs_batch, gen, data_type: str,
              training: bool):
        """Every term's (sum, count) on this rank's rows, masked so that
        the eval loader's padding rows add nothing: the SCST loss, the
        domain alignment, the rewards, and for the fact data the XE term;
        with ``scs_batch`` also the seq2seq term."""
        fc, att = batch["fc"], batch["att"]
        rmask = _row_mask(batch, fc.shape[0], device=fc.device)
        if data_type == "fact" or not training:
            senti_labels = _detect(frozen, att)   # decoder.py:82-84
        else:
            senti_labels = batch["senti_labels"]
        sums: Dict[str, torch.Tensor] = {}
        counts: Dict[str, torch.Tensor] = {}
        n_rows = rmask.sum()

        sample_seq, sample_lp, sample_masks, aux = cap.forward_rl(
            params, fc, att, batch["cpts"], batch["sentis"], senti_labels,
            settings=settings, ids=ids, max_seq_len=max_seq_len,
            sample_max=False, gen=gen, deterministic=not training)
        sample_masks = sample_masks * rmask[:, None]
        sums["da_loss"], counts["da_loss"] = cap.domain_alignment_sums(
            aux["cpt_feats"], aux["fc_emb"], rmask)
        with torch.no_grad():
            greedy_seq, _, _, _ = cap.forward_rl(
                params, fc, att, batch["cpts"], batch["sentis"],
                senti_labels, settings=settings, ids=ids,
                max_seq_len=max_seq_len, sample_max=True,
                deterministic=True)

        if data_type == "fact":
            fact_reward = ciderd_device.self_critical_reward(
                cider_tables, sample_seq, greedy_seq, batch["img_rows"],
                ids.eos)
            sums["fact_reward"] = (fact_reward[:, 0] * rmask).sum()
            counts["fact_reward"] = n_rows
        else:
            fact_reward = 0.0

        cls_reward = _cls_reward(frozen.sent_senti_cls, sample_seq,
                                 sample_masks, senti_labels, settings)
        n_tok_slots = n_rows * cls_reward.shape[1]
        sums["cls_reward"] = (cls_reward * rmask[:, None]).sum()
        counts["cls_reward"] = n_tok_slots

        rewards = fact_reward + CLS_FLAG * cls_reward
        if lm_tables is not None and lm_flag > 0.0:
            lmr = lm_device.lm_reward(lm_tables, sample_seq, greedy_seq,
                                      senti_labels, ids.eos)
            sums["lm_reward"] = (lmr * rmask[:, None]).sum()
            counts["lm_reward"] = n_tok_slots
            rewards = rewards + lm_flag * lmr
        sums["all_rewards"] = (rewards * rmask[:, None]).sum()
        counts["all_rewards"] = n_tok_slots
        sums["cap_loss"], counts["cap_loss"] = cap.reward_criterion_sums(
            sample_lp, sample_masks, rewards)

        if data_type == "fact":
            # XE on a ground-truth caption with pseudo labels
            # (decoder.py:131-141)
            caps = batch["caps"]
            xe_labels = _pseudo_senti_labels(frozen.sent_senti_cls, caps,
                                             batch["lengths"], settings)
            pred, _ = cap.forward_xe(
                params, fc, att, batch["cpts"], caps, xe_labels,
                settings=settings, gen=gen, ss_prob=xe_ss,
                deterministic=not training)
            lengths = batch["lengths"] * rmask.to(batch["lengths"].dtype)
            sums["xe_loss"], counts["xe_loss"] = cap.xe_criterion_sums(
                pred, caps[:, 1:], lengths)

        if scs_batch is not None:
            # seq2seq (decoder.py:143-159)
            s2s_pred = cap.forward_seq2seq(
                params, scs_batch["caps"], scs_batch["cpts"],
                scs_batch["sentis"], scs_batch["senti_labels"],
                settings=settings, gen=gen, ss_prob=s2s_ss,
                deterministic=False)
            s2s_sum, counts["seq2seq_loss"] = cap.xe_criterion_sums(
                s2s_pred, scs_batch["caps"][:, 1:], scs_batch["lengths"])
            sums["seq2seq_loss"] = SEQ_FLAG * s2s_sum
        return sums, counts

    def make_train(data_type: str):
        def train_step(frozen: RLModels, batch, scs_batch, gen):
            opt.zero_grad()
            with vocab.sharded(shard):
                shares = _global_shares(*_sums(frozen, batch, scs_batch,
                                               gen, data_type,
                                               training=True))
            _apply_gradients(opt, sum(shares[k] for k in RL_LOSS_TERMS
                                      if k in shares))
            return _global_values(shares)
        return train_step

    def make_eval(data_type: str):
        @torch.no_grad()
        def eval_step(frozen: RLModels, batch, gen):
            # every rank evaluates the same whole batch: its rollout draws
            # are one process's, not a block of a global batch's
            with mesh.whole_batch(), vocab.sharded(shard):
                return _sums(frozen, batch, None, gen, data_type,
                             training=False)
        return eval_step

    return {("fact", True): make_train("fact"),
            ("senti", True): make_train("senti"),
            ("fact", False): make_eval("fact"),
            ("senti", False): make_eval("senti")}


# ---------------------------------------------------------------------------
# Head stages
# ---------------------------------------------------------------------------

def _head_steps(opt: optim.Adam, rows_fn, eval_fn):
    """(train_step, eval_step) of a head stage on ``opt.params``.

    ``train_step(batch, gen)`` takes one optimizer step on the mean over
    the global batch's rows of ``rows_fn(params, batch, gen)``'s per-row
    losses and returns it, detached; ``eval_step(batch)`` returns (the
    masked sum of ``eval_fn``'s per-row losses, the count of true rows,
    its outputs), so that the eval loader's padding rows add nothing."""
    params = opt.params

    def train_step(batch, gen):
        opt.zero_grad()
        with nn.exact_numerics():
            rows = rows_fn(params, batch, gen)
            share = _global_shares(
                {"loss": rows.sum()},
                {"loss": torch.tensor(rows.shape[0], device=rows.device)})
            _apply_gradients(opt, share["loss"])
        return _global_values(share)["loss"]

    @torch.no_grad()
    def eval_step(batch):
        rows, out = eval_fn(params, batch)
        rmask = _row_mask(batch, rows.shape[0], rows.dtype, rows.device)
        return (rows * rmask).sum(), rmask.sum(), out

    return train_step, eval_step


def make_concept_steps(settings, opt: optim.Adam):
    """The concept detector's steps; batch {fc, cpts}. The eval outputs
    are the sigmoid scores [bs, C]."""
    def rows_fn(p, batch, gen):
        out = cpt_det.forward(p, batch["fc"], dropout_p=settings.dropout_p,
                              gen=gen, deterministic=False)
        return cpt_det.multi_label_loss_rows(out, batch["cpts"])

    def eval_fn(p, batch):
        out = cpt_det.forward(p, batch["fc"])
        return cpt_det.multi_label_loss_rows(out, batch["cpts"]), out

    return _head_steps(opt, rows_fn, eval_fn)


def make_senti_steps(settings, opt: optim.Adam):
    """The image sentiment detector's steps (the head ``settings``
    selects); batch {att, labels}. The eval outputs are the labels of
    ``sample`` at threshold 0 (every prediction counts, train_senti.py:
    99-108). The eval step runs the detector twice, as the JAX step does:
    once for the loss, once for the labels."""
    sd = senti_det.module_for(settings)

    def rows_fn(p, batch, gen):
        logits, _ = sd.forward(p, batch["att"], dropout_p=settings.dropout_p,
                               gen=gen, deterministic=False)
        return sd.nll_rows(logits, batch["labels"])

    def eval_fn(p, batch):
        rows = sd.xent_nll_rows(p, batch["att"], batch["labels"])
        labels, _, _ = sd.sample(p, batch["att"], 0.0, 0)
        return rows, labels

    return _head_steps(opt, rows_fn, eval_fn)


def make_cls_steps(settings, opt: optim.Adam):
    """The sentence classifier's steps; batch {caps, lengths, labels}.
    The eval outputs are the predicted labels."""
    def rows_fn(p, batch, gen):
        return ss_cls.xent_nll_rows(p, batch["caps"], batch["lengths"],
                                    batch["labels"], settings=settings,
                                    gen=gen, deterministic=False)

    def eval_fn(p, batch):
        rows = ss_cls.xent_nll_rows(p, batch["caps"], batch["lengths"],
                                    batch["labels"], settings=settings)
        pred, _ = ss_cls.sample(p, batch["caps"], batch["lengths"],
                                settings=settings)
        return rows, pred

    return _head_steps(opt, rows_fn, eval_fn)
