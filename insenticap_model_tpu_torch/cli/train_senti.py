"""Image-sentiment-detector training (reference train_senti.py) on the
card.

    python -m insenticap_model_tpu_torch.cli.train_senti [--senti_bs 80] \\
        [--compute_dtype bfloat16] [--senti_resume CKPT] [--device cpu]

Counterpart of ``insenticap_model_tpu/cli/train_senti.py``, with its flags
(``cli/opts.py``) and its epoch: cross entropy on the sentiment images'
14x14 feature grids (``<feats_dir>/sentiment/feats_att``, labels from
``--img_senti_labels``; the head ``Settings`` selects), the val loss by
masked sums, the test accuracy of ``sample`` at threshold 0 (every
prediction counts, train_senti.py:99-108), lr halving on a val plateau,
and checkpoints, with the optimizer state, at epoch 0 and every epoch
after 5 (train_senti.py:120). Files are the JAX package's: either package
resumes from the other's.

The train step keeps the direct convolution (the Winograd kernels have no
backward); the eval step's two forwards a batch (the loss, then the
labels) take the Winograd kernels on a CUDA bf16 batch. Each step draws
its dropout mask from a generator seeded from (seed, epoch, step);
``--senti_resume`` replays the train loader's shuffles of the epochs
before it (the JAX CLI restarts its loader's stream instead).

Data-parallel under ``--mesh_shape '[n]'`` (``torchrun --nproc_per_node
n``; ``cli/train_xe.py`` says how): each rank trains on its stripe of the
train images, ``round_bs(senti_bs) / n`` rows a step, through the
Winograd kernels in its eval steps on the card; every rank evaluates the
whole val and test splits; rank 0 alone writes the metrics and the
checkpoints, and the other ranks wait at a barrier.
"""
from __future__ import annotations

import os

import torch

from ..config import Opts
from ..models import sentiment_detector as senti_det
from ..parallel import mesh
from ..training import checkpoint as ckpt
from ..training import optim, steps
from . import common
from .opts import parse_opt


def train(opt: Opts):
    """Run the stage; returns the trained params."""
    rt = common.Runtime(opt, data_parallel=True)
    params = senti_det.module_for(opt.settings).init_params(
        torch.Generator().manual_seed(opt.seed),
        len(opt.sentiment_categories), opt.settings, device=rt.device)
    adam, lr, epoch0 = common.start_training(
        rt, params, opt.senti_lr, opt.senti_resume,
        lambda meta: ckpt.validate_metadata(
            meta, settings=opt.settings,
            sentiment_categories=opt.sentiment_categories))
    params = adam.params

    img_senti_labels = common.load_json(opt.img_senti_labels)
    label2idx = {w: i for i, w in enumerate(opt.sentiment_categories)}
    items = {split: [(fn, label2idx[s]) for fn, s in pairs]
             for split, pairs in img_senti_labels.items()}
    att_store = common.open_store(common.sniff_store_path(
        os.path.join(opt.feats_dir, "sentiment", "feats_att.h5")))
    bs = rt.round_bs(opt.senti_bs)
    loaders = {split: common.senti_image_loader(
        att_store, items[split], bs, shuffle=(split == "train"),
        drop_last=(split == "train"), seed=opt.seed)
        for split in ("train", "val", "test")}
    loaders["train"].advance(epoch0)   # the shuffles before a resume

    train_step, eval_step = steps.make_senti_steps(opt.settings, adam)
    ck_dir = common.ensure_dir(os.path.join(opt.checkpoint, "sentiment"))
    previous_loss = None
    for epoch in range(epoch0, opt.senti_epochs):
        print(f"--------------------epoch: {epoch}")
        train_loss = common.train_epoch(train_step, loaders["train"], rt, opt.seed,
                                        epoch)
        val_loss = common.masked_mean(eval_step, loaders["val"], rt)

        corr = tot_rows = 0
        for batch in loaders["test"]:
            _, _, pred = eval_step(rt.put(batch))
            valid = batch["valid"]
            pred = pred[:valid].cpu().numpy()
            corr += int((pred == batch["labels"][:valid]).sum())
            tot_rows += valid
        corr_rate = corr / max(tot_rows, 1)

        if previous_loss is not None and val_loss > previous_loss:
            lr *= 0.5
            optim.set_lr(adam, lr)
        previous_loss = val_loss

        print(f"train_loss: {train_loss:.4f}, val_loss: {val_loss:.4f}, "
              f"corr_rate: {corr_rate:.4f}")
        common.metrics_line(os.path.join(ck_dir, "metrics.jsonl"), {
            "epoch": epoch, "train_loss": train_loss, "val_loss": val_loss,
            "corr_rate": corr_rate})
        mesh.barrier()                 # rank 0's metrics
        if epoch == 0 or epoch > 5:
            ckpt.save(
                ckpt.checkpoint_name(ck_dir, epoch, train_loss, val_loss),
                params, optim.to_optax_state(adam), {
                    "epoch": epoch, "lr": lr,
                    "settings": opt.settings.to_dict(),
                    "sentiment_categories": list(opt.sentiment_categories)})
    return params


def main(argv=None):
    common.run_with_post_mortem(train, parse_opt(argv))


if __name__ == "__main__":
    main()
