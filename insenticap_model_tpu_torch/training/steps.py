"""Train and eval steps: the XE stage and the three head stages.

Counterpart of ``insenticap_model_tpu/training/steps.py`` (:38-128 and
:340-409), with the reference trainers' loss semantics:

  XE stage      train_xe.py:144-196: XE on the captions, the
                domain-alignment MSE between the concept and image
                embeddings, and the text-only seq2seq XE on a
                sentiment-corpus batch, with the captions' sentiment
                labels given by the frozen sentence classifier (pseudo
                labels, under ``torch.no_grad``)
  concept       train_cpt.py: the multi-label BCE
  sentiment     train_senti.py: cross entropy (either detector head,
                ``sentiment_detector.module_for``)
  sentence-cls  train_sent_senti_cls_rnn.py: cross entropy

A train step is plain PyTorch with autograd (the JAX package's training
steps reach no Pallas kernel either); the gradient clamp and Adam are
``optim.Adam``. A head stage's train step runs forward and backward under
``nn.exact_numerics``, so that the detector's f32 convolutions and their
gradients stay f32 on the card (cuDNN's default is TF32). Eval steps run
under ``torch.no_grad``: on a CUDA bf16 batch the detector's eval forward
takes the Winograd kernels, which refuse operands that require grad.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import nn
from ..models import captioner as cap
from ..models import concept_detector as cpt_det
from ..models import sent_senti_cls as ss_cls
from ..models import sentiment_detector as senti_det
from . import optim


def _row_mask(batch, bs: int, dtype=torch.float32, device="cpu"):
    """1.0 for true rows, 0.0 for the eval loader's padding rows (its last
    batch repeats the last item and carries ``valid``); a batch without
    ``valid`` is all true rows."""
    valid = batch.get("valid")
    if valid is None:
        return torch.ones((bs,), dtype=dtype, device=device)
    return (torch.arange(bs, device=device) < valid).to(dtype)


@torch.no_grad()
def _pseudo_senti_labels(cls_params, caps, lengths, settings):
    """The frozen classifier's labels of the ground-truth captions
    (train_xe.py:155-158, decoder.py:133-136)."""
    logits, _ = ss_cls.forward(cls_params, caps[:, 1:], lengths,
                               settings=settings, deterministic=True)
    return logits.argmax(dim=-1)


def make_xe_steps(settings, opt: optim.Adam):
    """Returns (train_step, eval_step) for the captioner ``opt.params``.

    batch: {fc, att, caps [bs, T+1], lengths, cpts}
    scs_batch: {caps, lengths, cpts, sentis, senti_labels}

    ``train_step(cls_params, batch, scs_batch, gen, ss_prob)`` takes one
    optimizer step and returns the detached losses (the JAX package's
    keys); ``gen`` is the step's generator on the device.
    ``eval_step(cls_params, batch)`` returns masked (sums, counts) of the
    XE and domain-alignment terms."""
    params = opt.params

    def _losses(cls_params, batch, scs_batch: Optional[Dict], gen,
                ss_prob: float, deterministic: bool):
        labels = _pseudo_senti_labels(cls_params, batch["caps"],
                                      batch["lengths"], settings)
        logprobs, aux = cap.forward_xe(
            params, batch["fc"], batch["att"], batch["cpts"], batch["caps"],
            labels, settings=settings, gen=gen, ss_prob=ss_prob,
            deterministic=deterministic)
        xe_loss = cap.xe_criterion(logprobs, batch["caps"][:, 1:],
                                   batch["lengths"])
        da_loss = cap.domain_alignment_loss(aux["cpt_feats"], aux["fc_emb"])
        losses = {"xe_loss": xe_loss, "da_loss": da_loss,
                  "cap_loss": xe_loss + da_loss}
        total = xe_loss + da_loss
        if scs_batch is not None:  # training only (train_xe.py:169-183)
            s2s_logprobs = cap.forward_seq2seq(
                params, scs_batch["caps"], scs_batch["cpts"],
                scs_batch["sentis"], scs_batch["senti_labels"],
                settings=settings, gen=gen, ss_prob=ss_prob,
                deterministic=deterministic)
            s2s = cap.xe_criterion(s2s_logprobs, scs_batch["caps"][:, 1:],
                                   scs_batch["lengths"])
            losses["seq2seq_loss"] = s2s
            total = total + s2s
        losses["all_loss"] = total
        return total, losses

    def train_step(cls_params, batch, scs_batch, gen, ss_prob: float):
        opt.zero_grad()
        total, losses = _losses(cls_params, batch, scs_batch, gen, ss_prob,
                                deterministic=False)
        total.backward()
        opt.step()
        return {k: v.detach() for k, v in losses.items()}

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
        logprobs, aux = cap.forward_xe(
            params, batch["fc"], batch["att"], batch["cpts"], caps, labels,
            settings=settings, deterministic=True)
        xe_sum, xe_cnt = cap.xe_criterion_sums(logprobs, caps[:, 1:],
                                               lengths)
        da_sum, da_cnt = cap.domain_alignment_sums(aux["cpt_feats"],
                                                   aux["fc_emb"], rmask)
        return ({"xe_loss": xe_sum, "da_loss": da_sum},
                {"xe_loss": xe_cnt, "da_loss": da_cnt})

    return train_step, eval_step


# ---------------------------------------------------------------------------
# Head stages
# ---------------------------------------------------------------------------

def _head_steps(opt: optim.Adam, loss_fn, eval_fn):
    """(train_step, eval_step) of a head stage on ``opt.params``.

    ``train_step(batch, gen)`` takes one optimizer step on
    ``loss_fn(params, batch, gen)`` and returns the detached loss;
    ``eval_step(batch)`` returns (the masked sum of ``eval_fn``'s per-row
    losses, the count of true rows, its outputs), so that the eval
    loader's padding rows add nothing."""
    params = opt.params

    def train_step(batch, gen):
        opt.zero_grad()
        with nn.exact_numerics():
            loss = loss_fn(params, batch, gen)
            loss.backward()
        opt.step()
        return loss.detach()

    @torch.no_grad()
    def eval_step(batch):
        rows, out = eval_fn(params, batch)
        rmask = _row_mask(batch, rows.shape[0], rows.dtype, rows.device)
        return (rows * rmask).sum(), rmask.sum(), out

    return train_step, eval_step


def make_concept_steps(settings, opt: optim.Adam):
    """The concept detector's steps; batch {fc, cpts}. The eval outputs
    are the sigmoid scores [bs, C]."""
    def loss_fn(p, batch, gen):
        out = cpt_det.forward(p, batch["fc"], dropout_p=settings.dropout_p,
                              gen=gen, deterministic=False)
        return cpt_det.multi_label_loss(out, batch["cpts"])

    def eval_fn(p, batch):
        out = cpt_det.forward(p, batch["fc"])
        return cpt_det.multi_label_loss_rows(out, batch["cpts"]), out

    return _head_steps(opt, loss_fn, eval_fn)


def make_senti_steps(settings, opt: optim.Adam):
    """The image sentiment detector's steps (the head ``settings``
    selects); batch {att, labels}. The eval outputs are the labels of
    ``sample`` at threshold 0 (every prediction counts, train_senti.py:
    99-108). The eval step runs the detector twice, as the JAX step does:
    once for the loss, once for the labels."""
    sd = senti_det.module_for(settings)

    def loss_fn(p, batch, gen):
        return sd.xent_loss(p, batch["att"], batch["labels"],
                            dropout_p=settings.dropout_p, gen=gen,
                            deterministic=False)

    def eval_fn(p, batch):
        rows = sd.xent_nll_rows(p, batch["att"], batch["labels"])
        labels, _, _ = sd.sample(p, batch["att"], 0.0, 0)
        return rows, labels

    return _head_steps(opt, loss_fn, eval_fn)


def make_cls_steps(settings, opt: optim.Adam):
    """The sentence classifier's steps; batch {caps, lengths, labels}.
    The eval outputs are the predicted labels."""
    def loss_fn(p, batch, gen):
        return ss_cls.xent_loss(p, batch["caps"], batch["lengths"],
                                batch["labels"], settings=settings, gen=gen,
                                deterministic=False)

    def eval_fn(p, batch):
        rows = ss_cls.xent_nll_rows(p, batch["caps"], batch["lengths"],
                                    batch["labels"], settings=settings)
        pred, _ = ss_cls.sample(p, batch["caps"], batch["lengths"],
                                settings=settings)
        return rows, pred

    return _head_steps(opt, loss_fn, eval_fn)
