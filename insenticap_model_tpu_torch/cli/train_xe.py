"""Captioner XE pre-training (reference train_xe.py) on the card.

    python -m insenticap_model_tpu_torch.cli.train_xe [--xe_bs 20] \\
        [--compute_dtype bfloat16] [--xe_resume CKPT] [--device cpu] ...

Counterpart of ``insenticap_model_tpu/cli/train_xe.py``, with its flags
(``cli/opts.py``) and its epoch: the scheduled-sampling schedule
(:209-212), the train step (XE + domain alignment + seq2seq, with the
frozen sentence classifier's pseudo labels; ``training/steps.py``), the
val pass by masked sums, the beam decode of the whole test split
(:219-232; ``inference.decode_xe``, which runs the beam-shared attention
kernel on the card), lr halving on a val plateau (:234-238) and
checkpoints, with the optimizer state, at the reference's epochs
(:241-254). Files are the JAX package's: its CLI resumes from the port's
checkpoints and the port from its.

Each step draws its dropout masks and scheduled-sampling inputs from a
generator seeded from (seed, epoch, step). ``--xe_resume`` restores the
parameters, the optimizer state and the learning rate, and replays the
loaders' shuffles of the epochs before it, so that a resumed run meets
the batches and draws an uninterrupted one meets (the JAX CLI restarts
its loaders' streams instead).

Data-parallel (``torchrun --nproc_per_node n -m
insenticap_model_tpu_torch.cli.train_xe --mesh_shape '[n]'``, with
``--device cpu`` for gloo): each rank trains on its stripe of the train
captions and of the seq2seq corpus, ``round_bs(xe_bs) / n`` and
``round_bs(80) / n`` rows a step, and every rank evaluates the whole val
split. Rank 0 alone decodes the test split and writes the dump, the
metrics and the checkpoints; the other ranks wait at a barrier.

On the 2-D mesh (``--mesh_shape '[dp, tp]'``, dp * tp processes) the
batch splits over the dp data groups, and the captioner's word embedding
and classifier shard by vocabulary over the model axis
(``common.Runtime.place_captioner``), their Adam moments with them; the
steps run the vocabulary's operations over the model group
(``parallel/vocab.py``). Each epoch every rank gathers the whole
captioner (``parallel.mesh.gather_captioner``) before rank 0 decodes the
test split on it with the one-device ``inference.decode_xe``, so that the
dump is the one-process decode of the same params; every rank gathers
the shards and their moments the same way for ``checkpoint.save``, and
rank 0 writes the one-process file.
"""
from __future__ import annotations

import os

import torch

from .. import inference, nn
from ..config import Opts
from ..data.loaders import CycleIterator, device_prefetch
from ..models import captioner as cap
from ..parallel import mesh
from ..training import checkpoint as ckpt
from ..training import optim, steps
from . import common
from .opts import parse_opt

CKPT_EPOCHS = {0, 10, 15, 20, 25, 29, 30, 35, 39}  # train_xe.py:240
SCS_BS = 80                     # the seq2seq batch (the JAX CLI's)


def load_frozen_cls(opt: Opts, vocab, device):
    """The frozen sentence-sentiment classifier from its best checkpoint
    (train_xe.py:58-74)."""
    path = common.best_checkpoint(opt, "sent_senti_cls")
    print(f"====> loading checkpoint '{path}'")
    params, meta = ckpt.load(path, device=device)
    ckpt.validate_metadata(meta, settings=opt.settings,
                           idx2word=vocab.idx2word,
                           sentiment_categories=opt.sentiment_categories,
                           dataset_name=opt.dataset_name,
                           corpus_type=opt.corpus_type)
    if "excitation1" not in params:
        raise ckpt.CheckpointError(f"{path}: not a sentence-classifier "
                                   f"checkpoint (keys {sorted(params)})")
    return params


def ss_prob_at(opt: Opts, epoch: int) -> float:
    """The scheduled-sampling probability of an epoch (train_xe.py:209-212)."""
    if epoch > opt.scheduled_sampling_start >= 0:
        frac = ((epoch - opt.scheduled_sampling_start)
                // opt.scheduled_sampling_increase_every)
        return min(opt.scheduled_sampling_increase_prob * frac,
                   opt.scheduled_sampling_max_prob)
    return 0.0


def train(opt: Opts):
    """Run the stage; returns the trained captioner params (on a 2-D mesh
    this rank's shards of the vocab leaves)."""
    rt = common.Runtime(opt, data_parallel=True)
    vocab = common.load_vocab(opt)
    ids = common.token_ids(vocab, opt.sentiment_categories)
    img_captions = common.load_json(
        common.dataset_path(opt, "img_captions.json"))
    img_det_concepts = common.load_json(
        common.dataset_path(opt, "img_det_concepts.json"))
    senti_captions = common.load_json(
        common.corpus_path(opt, "senti_captions.json"))

    params = cap.init_params(torch.Generator().manual_seed(opt.seed),
                             len(vocab), len(opt.sentiment_categories),
                             opt.settings, device=rt.device)
    adam, lr, epoch0 = common.start_training(
        rt, params, opt.xe_lr, opt.xe_resume,
        lambda meta: ckpt.validate_metadata(
            meta, settings=opt.settings, idx2word=vocab.idx2word,
            sentiment_categories=opt.sentiment_categories,
            dataset_name=opt.dataset_name, corpus_type=opt.corpus_type),
        captioner=True)
    params = adam.params

    cls_params = rt.cast(load_frozen_cls(opt, vocab, rt.device))

    print("====> tokenizing artifacts")
    captions_id = common.tokenize_captions(img_captions, vocab)
    concepts_id = common.tokenize_concepts(img_det_concepts, vocab)
    scs_id = common.tokenize_senti_corpus(senti_captions, vocab,
                                          opt.sentiment_categories)

    fc_path, att_path = common.feature_paths(opt)
    fc_store = common.open_store(fc_path)
    att_store = common.open_store(att_path)
    bs = rt.round_bs(opt.xe_bs)
    train_data = common.caption_loader(fc_store, att_store,
                                       captions_id["train"], concepts_id,
                                       vocab, opt, bs, seed=opt.seed)
    val_data = common.caption_loader(fc_store, att_store, captions_id["val"],
                                     concepts_id, vocab, opt, bs,
                                     shuffle=False, drop_last=False)
    scs_data = CycleIterator(common.scs_loader(scs_id, vocab, opt,
                                               rt.round_bs(SCS_BS),
                                               seed=opt.seed))
    # the shuffles and seq2seq batches of the epochs before a resume
    train_data.advance(epoch0)
    scs_data.skip(epoch0 * len(train_data))
    test_fns = sorted(captions_id["test"])

    train_step, eval_step = steps.make_xe_steps(opt.settings, adam)
    ck_dir, result_dir = common.stage_dirs(opt, "xe")
    previous_loss = None
    for epoch in range(epoch0, opt.xe_epochs):
        print(f"--------------------epoch: {epoch}")
        ss_prob = ss_prob_at(opt, epoch)
        print(f"ss_prob: {ss_prob}")

        agg, n = {}, 0
        for i, b in enumerate(device_prefetch(train_data, rt.put)):
            scs_b = rt.put(scs_data.next())
            gen = torch.Generator(device=rt.device).manual_seed(
                common.step_seed(opt.seed, epoch, i))
            losses = train_step(cls_params, b, scs_b, gen, ss_prob)
            for k, v in losses.items():   # summed on the device, read once
                agg[k] = agg.get(k, 0.0) + v.double()
            n += 1
        train_loss = {k: float(v) / max(n, 1) for k, v in agg.items()}

        # val: masked sums over the batches divided once, so padding rows
        # add nothing and the batching does not move the result
        sums, cnts = {}, {}
        for b in device_prefetch(val_data, rt.put):
            s, c = eval_step(cls_params, b)
            for k in s:
                sums[k] = sums.get(k, 0.0) + s[k].double()
                cnts[k] = cnts.get(k, 0.0) + c[k].double()
        val_loss = {k: float(sums[k]) / max(float(cnts[k]), 1.0)
                    for k in sums}
        val_loss["cap_loss"] = val_loss["xe_loss"] + val_loss["da_loss"]
        val_loss["all_loss"] = val_loss["cap_loss"]

        whole = mesh.gather_captioner(params, adam.shard)  # every rank
        if mesh.rank() == 0:
            common.dump_results(result_dir, str(epoch),
                                decode_split(whole, fc_store, att_store,
                                             test_fns, bs, rt, opt, ids,
                                             vocab), vocab)

        if previous_loss is not None and \
                val_loss["all_loss"] > previous_loss:
            lr *= 0.5
            optim.set_lr(adam, lr)
        previous_loss = val_loss["all_loss"]

        print(f"train_loss: {train_loss}, val_loss: {val_loss}")
        common.metrics_line(os.path.join(ck_dir, "metrics.jsonl"), {
            "epoch": epoch, "ss_prob": ss_prob, "lr": lr,
            **{f"train_{k}": v for k, v in train_loss.items()},
            **{f"val_{k}": v for k, v in val_loss.items()}})
        mesh.barrier()                 # rank 0's dump and metrics
        if epoch in CKPT_EPOCHS:
            ckpt.save(
                ckpt.checkpoint_name(ck_dir, epoch, train_loss["all_loss"],
                                     val_loss["all_loss"]),
                whole, optim.to_optax_state(adam), {
                    "epoch": epoch, "lr": lr,
                    "settings": opt.settings.to_dict(),
                    "idx2word": vocab.idx2word,
                    "sentiment_categories": list(opt.sentiment_categories),
                    "dataset_name": opt.dataset_name,
                    "corpus_type": opt.corpus_type})
    return params


@torch.no_grad()
def decode_split(params, fc_store, att_store, fns, bs, rt, opt, ids, vocab):
    """Beam-decode the images ``fns`` in batches of ``bs`` (the last padded
    with its last image) on the detached params -> the dump's records
    (train_xe.py:219-232)."""
    frozen = nn.tree_map(torch.Tensor.detach, params)
    results = []
    for s in range(0, len(fns), bs):
        chunk = fns[s:s + bs]
        padded = chunk + [chunk[-1]] * (bs - len(chunk))
        b = rt.put({"fc": fc_store.batch(padded),
                    "att": att_store.batch(padded)})
        seqs, _ = inference.decode_xe(frozen, b["fc"], b["att"],
                                      settings=opt.settings, ids=ids,
                                      beam_size=opt.beam_size,
                                      max_seq_len=opt.max_seq_len)
        seqs = seqs.cpu().numpy()
        for i, fn in enumerate(chunk):
            results.append({"image_id": fn,
                            "caption": vocab.decode_to_text(seqs[i, 0]),
                            "ids": [int(t) for t in seqs[i, 0]]})
    return results


def main(argv=None):
    common.run_with_post_mortem(train, parse_opt(argv))


if __name__ == "__main__":
    main()
