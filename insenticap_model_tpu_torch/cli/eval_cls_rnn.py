"""Sentiment correctness (cls%) of generated captions (reference
eval_cls_rnn.py) on the card.

    python -m insenticap_model_tpu_torch.cli.eval_cls_rnn PREFIX DATA_TYPE \\
        [--checkpoint ./checkpoint] [--device cpu]

Counterpart of ``insenticap_model_tpu/cli/eval_cls_rnn.py``: classifies
the id-form result files ``<PREFIX>_<sentiment>_<DATA_TYPE>.txt`` that
``train_rl`` writes with the frozen sentence classifier (its best
checkpoint under ``--checkpoint``, a file of either package), and prints
each sentiment's and all files' share of captions classified as the
sentiment they were written for. The dataset and corpus come from the
prefix string, as in the reference (:15-20).
"""
from __future__ import annotations

import argparse

import torch

from ..config import Opts, Settings
from ..models import sent_senti_cls as ss_cls
from ..training import checkpoint as ckpt
from ..utils.dtypes import resolve_device
from ..vocab import Vocab
from . import common

MAX_SEQ_LEN = 16  # reference eval_cls_rnn.py:11


@torch.no_grad()
def compute_cls(captions_file_prefix: str, data_type: str,
                checkpoint_dir: str = "./checkpoint",
                device="cuda") -> dict:
    """{sentiment or "all": the share of its captions classified as it}."""
    dev = resolve_device(device)
    dataset_name = "flickr30k" if "flickr30k" in captions_file_prefix \
        else "coco"
    corpus_type = "full" if "full" in captions_file_prefix else "part"

    opt = Opts(dataset_name=dataset_name, corpus_type=corpus_type,
               checkpoint=checkpoint_dir)
    path = common.best_checkpoint(opt, "sent_senti_cls")
    print(f"====> loading checkpoint '{path}'")
    params, meta = ckpt.load(path, device=dev)
    if "excitation1" not in params:
        raise ckpt.CheckpointError(f"{path}: not a sentence-classifier "
                                   f"checkpoint (keys {sorted(params)})")
    settings = Settings.from_dict(meta["settings"])
    vocab = Vocab(meta["idx2word"])
    cats = meta["sentiment_categories"]

    val_sets = {"all": []}
    for senti_id, senti in enumerate(cats):
        val_sets[senti] = []
        fn = f"{captions_file_prefix}_{senti}_{data_type}.txt"
        with open(fn) as f:
            for line in f:
                ids = [int(t) for t in line.split()]
                val_sets[senti].append([senti_id, ids])
                val_sets["all"].append([senti_id, ids])

    acc = {}
    for senti, items in val_sets.items():
        loader = common.senti_sents_loader(items, MAX_SEQ_LEN, vocab.pad_id,
                                           bs=80, shuffle=False,
                                           drop_last=False)
        total = wrong = 0
        for batch in loader:
            pred, _ = ss_cls.sample(
                params, torch.from_numpy(batch["caps"]).to(dev),
                torch.from_numpy(batch["lengths"]).to(dev),
                settings=settings)
            pred = pred.cpu().numpy()
            valid = batch.get("valid", len(batch["labels"]))
            wrong += int((pred[:valid] != batch["labels"][:valid]).sum())
            total += valid
        acc[senti] = 1 - wrong / max(total, 1)
        print(f"{senti} acc_rate: {acc[senti]:.6f}")
    return acc


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("captions_file_prefix")
    p.add_argument("data_type")
    p.add_argument("--checkpoint", default="./checkpoint")
    p.add_argument("--device", default="cuda",
                   help="the port's device: cuda (default; refused where "
                        "CUDA is absent) or cpu")
    args = p.parse_args(argv)
    compute_cls(args.captions_file_prefix, args.data_type, args.checkpoint,
                args.device)


if __name__ == "__main__":
    main()
