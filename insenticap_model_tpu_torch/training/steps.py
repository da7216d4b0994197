"""Train and eval steps: the XE stage.

Counterpart of ``insenticap_model_tpu/training/steps.py`` (:38-128), with
the reference trainer's loss semantics (train_xe.py:144-196): XE on the
captions, the domain-alignment MSE between the concept and image
embeddings, and the text-only seq2seq XE on a sentiment-corpus batch,
with the sentiment labels of the captions given by the frozen sentence
classifier (pseudo labels, under ``torch.no_grad``). The step is plain
PyTorch with autograd (the JAX package's training step reaches no Pallas
kernel either); the gradient clamp and Adam are ``optim.Adam``.

The concept, sentiment and sentence-classifier steps and the RL step are
not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models import captioner as cap
from ..models import sent_senti_cls as ss_cls
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
