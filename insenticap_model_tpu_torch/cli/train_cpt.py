"""Concept-detector training (reference train_cpt.py) on the card.

    python -m insenticap_model_tpu_torch.cli.train_cpt [--concept_bs 80] \\
        [--compute_dtype bfloat16] [--concept_resume CKPT] [--device cpu]

Counterpart of ``insenticap_model_tpu/cli/train_cpt.py``, with its flags
(``cli/opts.py``) and its epoch: the multi-label BCE train step
(``training/steps.make_concept_steps``), the val loss by masked sums, the
test split's precision, recall and last score at ``num_concepts``,
reduced on the host as the reference does (train_cpt.py:103-128: a
batch's mean over its true rows, then the mean over batches), lr halving
on a val plateau and a checkpoint, with the optimizer state, every epoch.
Files are the JAX package's: either package resumes from the other's.

Each step draws its dropout mask from a generator seeded from (seed,
epoch, step). ``--concept_resume`` restores the parameters, the optimizer
state and the learning rate, and replays the train loader's shuffles of
the epochs before it (the JAX CLI restarts its loader's stream instead).

Data-parallel under ``--mesh_shape '[n]'`` (``torchrun --nproc_per_node
n``; ``cli/train_xe.py`` says how): each rank trains on its stripe of the
train images, ``round_bs(concept_bs) / n`` rows a step; every rank
evaluates the whole val and test splits; rank 0 alone writes the metrics
and the checkpoints, and the other ranks wait at a barrier.
"""
from __future__ import annotations

import os

import torch

from ..config import Opts
from ..models import concept_detector as cpt_det
from ..training import checkpoint as ckpt
from ..training import optim, steps
from . import common
from .opts import parse_opt


def train(opt: Opts):
    """Run the stage; returns the trained params."""
    rt = common.Runtime(opt, data_parallel=True)
    idx2concept = common.load_json(
        common.dataset_path(opt, "idx2concept.json"))
    img_concepts = common.load_json(
        common.dataset_path(opt, "img_concepts.json"))
    concept2idx = {w: i for i, w in enumerate(idx2concept)}
    ground_truth = {fn: list(cpts)
                    for fn, cpts in img_concepts["test"].items()}
    concepts_id = {
        split: {fn: [concept2idx[c] for c in cpts if c in concept2idx]
                for fn, cpts in d.items()}
        for split, d in img_concepts.items()}

    def validate(meta):
        ckpt.validate_metadata(meta, settings=opt.settings,
                               dataset_name=opt.dataset_name)
        if list(meta.get("idx2concept", idx2concept)) != list(idx2concept):
            raise ckpt.CheckpointError("idx2concept mismatch")

    params = cpt_det.init_params(torch.Generator().manual_seed(opt.seed),
                                 len(idx2concept), opt.settings,
                                 device=rt.device)
    adam, lr, epoch0 = common.start_training(rt, params, opt.concept_lr,
                                             opt.concept_resume, validate)
    params = adam.params

    fc_store = common.open_store(common.feature_paths(opt)[0])
    bs = rt.round_bs(opt.concept_bs)
    loaders = {split: common.concept_loader(
        fc_store, list(concepts_id[split].items()), len(idx2concept), bs,
        shuffle=(split == "train"), drop_last=(split == "train"),
        seed=opt.seed) for split in ("train", "val", "test")}
    loaders["train"].advance(epoch0)   # the shuffles before a resume

    train_step, eval_step = steps.make_concept_steps(opt.settings, adam)
    ck_dir = common.ensure_dir(os.path.join(opt.checkpoint, "concept",
                                            opt.dataset_name))
    previous_loss = None
    for epoch in range(epoch0, opt.concept_epochs):
        print(f"--------------------epoch: {epoch}")
        train_loss = common.train_epoch(train_step, loaders["train"], rt, opt.seed,
                                        epoch)
        val_loss = common.masked_mean(eval_step, loaders["val"], rt)

        # test: precision/recall@k on the ground-truth words
        test_loss = test_rows = 0.0
        pre = recall = last_score = 0.0
        nb = 0
        for batch in loaders["test"]:
            b = rt.put(batch)
            loss_sum, cnt, _ = eval_step(b)
            with torch.no_grad():
                _, top_idx, top_scores = cpt_det.sample(params, b["fc"],
                                                        opt.num_concepts)
            top_idx = top_idx.cpu().numpy()
            valid = batch["valid"]
            tmp_pre = tmp_rec = 0.0
            for i, fn in enumerate(batch["fns"][:valid]):
                cpts = {idx2concept[j] for j in top_idx[i]}
                grdt = set(ground_truth[fn])
                inter = len(grdt & cpts)
                tmp_pre += inter / len(cpts)
                tmp_rec += inter / len(grdt)
            test_loss += float(loss_sum)
            test_rows += float(cnt)
            pre += tmp_pre / valid
            recall += tmp_rec / valid
            last_score += float(top_scores[:valid, -1].float().mean())
            nb += 1
        nb = max(nb, 1)
        test_loss /= max(test_rows, 1)
        pre, recall, last_score = (x / nb for x in (pre, recall, last_score))

        if previous_loss is not None and val_loss > previous_loss:
            lr *= 0.5
            optim.set_lr(adam, lr)
        previous_loss = val_loss

        print(f"train_loss: {train_loss:.4f}, val_loss: {val_loss:.4f}, "
              f"test_loss: {test_loss:.4f}, precision: {pre:.4f}, "
              f"recall: {recall:.4f}, last_score: {last_score:.4f}")
        common.metrics_line(os.path.join(ck_dir, "metrics.jsonl"), {
            "epoch": epoch, "train_loss": train_loss, "val_loss": val_loss,
            "test_loss": test_loss, "precision": pre, "recall": recall})
        ckpt.save(ckpt.checkpoint_name(ck_dir, epoch, train_loss, val_loss),
                  params, optim.to_optax_state(adam), {
                      "epoch": epoch, "lr": lr,
                      "settings": opt.settings.to_dict(),
                      "idx2concept": idx2concept,
                      "dataset_name": opt.dataset_name})
    return params


def main(argv=None):
    common.run_with_post_mortem(train, parse_opt(argv))


if __name__ == "__main__":
    main()
