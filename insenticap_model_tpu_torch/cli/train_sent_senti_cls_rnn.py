"""Sentence-sentiment-classifier training (reference
train_sent_senti_cls_rnn.py) on the card.

    python -m insenticap_model_tpu_torch.cli.train_sent_senti_cls_rnn \\
        [--compute_dtype bfloat16] [--senti_resume CKPT] [--device cpu]

Counterpart of ``insenticap_model_tpu/cli/train_sent_senti_cls_rnn.py``:
the train/val split carved from ``senti_captions.json`` (``build_datasets``:
the first 5000 neutral, 1000 positive and 1000 negative sentences of a
``random.Random(100)`` shuffle as val, at most half of each; the train
positive and negative lists repeated to the neutral list's integer
ratio), the reference's hard-coded lr 4e-4, batch 80 and 30 epochs
(:39, dataloader.py:364, :110), per-class val accuracy with lr halving
when the overall accuracy drops (:168-172), and a checkpoint, with the
optimizer state, every epoch. Sentences are ids without SOS, with EOS
appended (:88-93). Files are the JAX package's: either package resumes
from the other's.

Each step draws its dropout masks from a generator seeded from (seed,
epoch, step); ``--senti_resume`` replays the train loader's shuffles of
the epochs before it (the JAX CLI restarts its loader's stream instead).

Data-parallel under ``--mesh_shape '[n]'`` (``torchrun --nproc_per_node
n``; ``cli/train_xe.py`` says how): each rank trains on its stripe of the
train sentences, ``round_bs(80) / n`` rows a step; every rank evaluates
the whole val split; rank 0 alone writes the metrics and the checkpoints,
and the other ranks wait at a barrier.
"""
from __future__ import annotations

import copy
import os
import random

import torch

from ..config import Opts
from ..models import sent_senti_cls as ss_cls
from ..training import checkpoint as ckpt
from ..training import optim, steps
from . import common
from .opts import parse_opt

LR = 4e-4        # reference :39
BS = 80          # reference dataloader default (dataloader.py:364)
EPOCHS = 30      # reference :110
VAL_SIZES = (("neutral", 5000), ("positive", 1000), ("negative", 1000))


def build_datasets(senti_captions, vocab, sentiment_categories, seed=100):
    """(train_set, {senti: val_set}) of [label, ids] items: the
    reference's split and upsampling (:67-95), val capped at half of each
    class for corpora smaller than the reference's."""
    rng = random.Random(seed)
    caps = {s: [c[0] for c in senti_captions[s]] for s in senti_captions}
    for s in caps:
        rng.shuffle(caps[s])
    split = {"train": {}, "val": {}}
    for senti, n_val in VAL_SIZES:
        n_val = min(n_val, len(caps[senti]) // 2)
        split["val"][senti] = copy.deepcopy(caps[senti][:n_val])
        split["train"][senti] = copy.deepcopy(caps[senti][n_val:])
    for senti in ("positive", "negative"):
        ratio = int(len(split["train"]["neutral"])
                    / max(len(split["train"][senti]), 1))
        split["train"][senti] = split["train"][senti] * ratio

    label2idx = {w: i for i, w in enumerate(sentiment_categories)}
    train_set, val_set = [], {}
    for senti in sentiment_categories:
        sid = label2idx[senti]
        for cap in split["train"][senti]:
            train_set.append(
                [sid, [vocab.word_to_id(w) for w in cap] + [vocab.eos_id]])
        val_set[senti] = [
            [sid, [vocab.word_to_id(w) for w in cap] + [vocab.eos_id]]
            for cap in split["val"][senti]]
    rng.shuffle(train_set)
    return train_set, val_set


def train(opt: Opts):
    """Run the stage; returns the trained params."""
    rt = common.Runtime(opt, data_parallel=True)
    vocab = common.load_vocab(opt)
    senti_captions = common.load_json(
        common.corpus_path(opt, "senti_captions.json"))

    params = ss_cls.init_params(torch.Generator().manual_seed(opt.seed),
                                len(vocab), len(opt.sentiment_categories),
                                opt.settings, device=rt.device)
    adam, lr, epoch0 = common.start_training(
        rt, params, LR, opt.senti_resume,
        lambda meta: ckpt.validate_metadata(
            meta, settings=opt.settings, idx2word=vocab.idx2word,
            sentiment_categories=opt.sentiment_categories,
            dataset_name=opt.dataset_name, corpus_type=opt.corpus_type))
    params = adam.params

    train_set, val_set = build_datasets(senti_captions, vocab,
                                        opt.sentiment_categories)
    bs = rt.round_bs(BS)
    train_loader = common.senti_sents_loader(train_set, opt.max_seq_len,
                                             vocab.pad_id, bs, seed=opt.seed)
    train_loader.advance(epoch0)       # the shuffles before a resume
    val_loaders = {s: common.senti_sents_loader(
        v, opt.max_seq_len, vocab.pad_id, bs, shuffle=False, drop_last=False)
        for s, v in val_set.items()}

    train_step, eval_step = steps.make_cls_steps(opt.settings, adam)
    ck_dir, _ = common.stage_dirs(opt, "sent_senti_cls")
    previous_acc = None
    for epoch in range(epoch0, EPOCHS):
        print(f"--------------------epoch: {epoch}")
        train_loss = common.train_epoch(train_step, train_loader, rt, opt.seed,
                                        epoch)

        total = wrong = 0
        senti_acc = {}
        for senti, loader in val_loaders.items():
            s_tot = s_wrong = 0
            for batch in loader:
                _, _, pred = eval_step(rt.put(batch))
                valid = batch["valid"]
                pred = pred[:valid].cpu().numpy()
                s_wrong += int((pred != batch["labels"][:valid]).sum())
                s_tot += valid
            senti_acc[senti] = 100 - s_wrong / max(s_tot, 1) * 100
            total += s_tot
            wrong += s_wrong
        all_acc = 100 - wrong / max(total, 1) * 100

        if previous_acc is not None and all_acc < previous_acc:
            lr *= 0.5
            optim.set_lr(adam, lr)
        previous_acc = all_acc

        print(f"train_loss: {train_loss:.4f}, all_acc_rate: {all_acc:.4f}, "
              f"senti_acc_rate: {senti_acc}")
        common.metrics_line(os.path.join(ck_dir, "metrics.jsonl"), {
            "epoch": epoch, "train_loss": train_loss, "all_acc": all_acc,
            **{f"acc_{k}": v for k, v in senti_acc.items()}})
        ckpt.save(ckpt.checkpoint_name(ck_dir, epoch, train_loss, all_acc),
                  params, optim.to_optax_state(adam), {
                      "epoch": epoch, "lr": lr,
                      "settings": opt.settings.to_dict(),
                      "idx2word": vocab.idx2word,
                      "sentiment_categories": list(opt.sentiment_categories),
                      "dataset_name": opt.dataset_name,
                      "corpus_type": opt.corpus_type})
    return params


def main(argv=None):
    common.run_with_post_mortem(train, parse_opt(argv))


if __name__ == "__main__":
    main()
