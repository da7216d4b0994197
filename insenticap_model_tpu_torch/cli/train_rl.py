"""SCST RL fine-tuning (reference train_rl.py + models/decoder.py) on the
card.

    python -m insenticap_model_tpu_torch.cli.train_rl [--rl_bs 40] \\
        --rl_senti_resume DETECTOR_CKPT [--rl_resume CKPT] \\
        [--compute_dtype bfloat16] [--rl_detector_dtype bf16] \\
        [--rl_lm_flag F] [--device cpu] ...

Counterpart of ``insenticap_model_tpu/cli/train_rl.py``, with its flags
(``cli/opts.py``) and its loop: the multi-source bootstrap (the XE
captioner, the image sentiment detector of ``--rl_senti_resume`` and the
sentence classifier; :58-98) or the ``--rl_resume`` composite (:41-57),
the CIDEr-D tables built once on the host and placed on the device, then
an epoch of ``rl_senti_times`` passes over the sentiment images,
``rl_fact_times`` passes over the captioned images (each capped at 500
batches, decoder.py:65), the val pass by masked sums, the test dump of
both test splits through the serving path (``inference.make_serving_fn``:
the detector, then the beam, which runs the beam-shared attention kernel
on the card, and the Winograd kernels for a bf16 detector), the
per-sentiment result files in the reference's formats, ``metrics.jsonl``
and the composite checkpoint {captioner, senti_detector, sent_senti_cls}
with the optimizer state. Files are the JAX package's: each package
resumes from the other's checkpoints.

The train steps are ``training/steps.make_rl_steps``; step i of a pass
draws from a generator seeded from (seed + 17, epoch, phase, pass, i), so
that passes and phases never share draws. ``--rl_resume`` restores the
parameters, Adam's state and learning rate, and replays the loaders'
shuffles and caption draws of the epochs before it, so that a resumed run
meets the batches and draws an uninterrupted one meets (the JAX CLI
restarts its loaders' streams and Adam's state instead).

Data-parallel (``torchrun --nproc_per_node n -m
insenticap_model_tpu_torch.cli.train_rl --mesh_shape '[n]'``, with
``--device cpu`` for gloo): the train passes are striped. Each rank takes
its stripe of the sentiment and captioned train images and of the
seq2seq corpus, ``round_bs(rl_bs) / n`` and ``round_bs(80) / n`` rows a
step, and as many steps a pass as every other rank; the step's losses
are the global batch's. The val pass runs whole on every rank: each
evaluates every val image and draws its rollouts as one process does
(``mesh.whole_batch``). Each rank builds the CIDEr-D tables (and the LM
tables) itself from the same files, and a resume replays each rank's own
stripe. Rank 0 alone runs the test dump and writes its files, the
metrics and the checkpoints; the other ranks wait at a barrier.

On the 2-D mesh (``--mesh_shape '[dp, tp]'``) the passes split over the
dp data groups, and the captioner's word embedding and classifier (and
their Adam moments) shard by vocabulary over the model axis after the
broadcast (``common.Runtime.place_captioner``); the rollouts' draws and
argmaxes, the picked log-probs and the teacher-forced passes run
``parallel/vocab.py``'s operations over the model group, so that the
ranks of a model group take the same tokens. Every rank gathers the
whole captioner for the test dump, which rank 0 runs on the one-device
serving path, and for ``checkpoint.save``, with the moments gathered
likewise, so that rank 0 writes the one-process composite.
"""
from __future__ import annotations

import json
import os
import random
import time

import numpy as np
import torch

from .. import inference, nn
from ..config import Opts
from ..data.loaders import CycleIterator, device_prefetch
from ..models import sentiment_detector as senti_det
from ..ops import ciderd_device
from ..parallel import mesh
from ..rewards.ciderd import build_scorer
from ..training import checkpoint as ckpt
from ..training import optim, steps
from ..utils.dtypes import cast_bf16, cast_f32
from . import common
from .opts import parse_opt
from .train_xe import load_frozen_cls

MAX_BATCHES_PER_EPOCH = 500     # reference decoder.py:65
SCS_BS = 80                     # the seq2seq batch (the JAX CLI's)
PHASES = {"senti": 0, "fact": 1, "val": 2}
PARTS = ("captioner", "senti_detector", "sent_senti_cls")


def _load_part(path, opt: Opts, device, key: str, vocab=None,
               check_ds: bool = True):
    """A bare model checkpoint of either package, float32 on ``device``,
    checked against the run's settings (and vocabulary, dataset) and
    required to hold ``key`` (a top-level key of that model's tree; the
    sentence classifier's tree, which also has a ``word_embed``, is
    refused)."""
    print(f"====> loading checkpoint '{path}'")
    params, meta = ckpt.load(path, device=device, dtype=torch.float32)
    ckpt.validate_metadata(
        meta, settings=opt.settings,
        idx2word=vocab.idx2word if vocab else None,
        sentiment_categories=opt.sentiment_categories,
        dataset_name=opt.dataset_name if check_ds else None,
        corpus_type=opt.corpus_type if check_ds else None)
    if key not in params or "excitation1" in params:
        raise ckpt.CheckpointError(f"{path}: no {key} among its keys "
                                   f"{sorted(params)}")
    return params


def load_models(opt: Opts, vocab, device):
    """(captioner, detector, classifier, Adam's stored state or None, the
    first epoch): the ``--rl_resume`` composite, or the bootstrap from the
    XE, detector and classifier checkpoints (the detector from a seed where
    ``--rl_senti_resume`` is empty). Float32, on ``device``."""
    if opt.rl_resume:
        print(f"====> loading checkpoint '{opt.rl_resume}'")
        parts, opt_state, meta = ckpt.load(opt.rl_resume, device=device,
                                           dtype=torch.float32,
                                           with_opt_state=True)
        if not isinstance(parts, dict) or set(parts) != set(PARTS):
            raise ckpt.CheckpointError(
                f"{opt.rl_resume}: not an RL composite checkpoint (parts "
                f"{sorted(parts)} != {sorted(PARTS)})")
        ckpt.validate_metadata(meta, settings=opt.settings,
                               idx2word=vocab.idx2word,
                               sentiment_categories=opt.sentiment_categories,
                               dataset_name=opt.dataset_name,
                               corpus_type=opt.corpus_type)
        if meta.get("max_seq_len") != opt.max_seq_len:
            raise ckpt.CheckpointError("max_seq_len mismatch")
        return (*(parts[k] for k in PARTS), opt_state, meta["epoch"] + 1)
    params = _load_part(common.best_checkpoint(opt, "xe"), opt, device,
                        "word_embed", vocab)
    if opt.rl_senti_resume:
        senti = _load_part(opt.rl_senti_resume, opt, device, "senti_conv",
                           check_ds=False)
    else:
        senti = senti_det.module_for(opt.settings).init_params(
            torch.Generator().manual_seed(1), len(opt.sentiment_categories),
            opt.settings, device=device)
    cls = nn.tree_map(lambda t: t.float(), load_frozen_cls(opt, vocab,
                                                           device))
    return params, senti, cls, None, 0


def _replay(loader) -> int:
    """One pass of ``loader`` (its first ``MAX_BATCHES_PER_EPOCH``
    batches) without assembling a batch: its shuffle and, for the fact
    loaders, the caption draws of its collate's generator. Returns the
    pass's batch count."""
    batches = loader._index_batches()[:MAX_BATCHES_PER_EPOCH]
    rng = getattr(loader, "caption_rng", None)
    if rng is not None:
        for b in batches:
            for i in (b[0] if isinstance(b, tuple) else b):
                rng.integers(0, len(loader.items[i][1]))
    return len(batches)


def train(opt: Opts):
    """Run the stage; returns the trained captioner params (on a 2-D mesh
    this rank's shards of the vocab leaves)."""
    rt = common.Runtime(opt, data_parallel=True)
    vocab = common.load_vocab(opt)
    ids = common.token_ids(vocab, opt.sentiment_categories)
    label2idx = {w: i for i, w in enumerate(opt.sentiment_categories)}

    img_captions = common.load_json(
        common.dataset_path(opt, "img_captions.json"))
    img_det_concepts = common.load_json(
        common.dataset_path(opt, "img_det_concepts.json"))
    img_det_sentiments = common.load_json(
        common.corpus_path(opt, "img_det_sentiments.json"))
    img_senti_labels = common.load_json(opt.img_senti_labels)
    senti_captions = common.load_json(
        common.corpus_path(opt, "senti_captions.json"))

    params, senti_params, cls_params, opt_state, epoch0 = load_models(
        opt, vocab, rt.device)

    print("====> tokenizing artifacts")
    captions_id = common.tokenize_captions(img_captions, vocab)
    concepts_id = common.tokenize_concepts(img_det_concepts, vocab)
    sentiments_id = common.tokenize_sentiments(img_det_sentiments, vocab)
    scs_id = common.tokenize_senti_corpus(senti_captions, vocab,
                                          opt.sentiment_categories)
    random.Random(opt.seed).shuffle(scs_id)

    t0 = time.time()
    scorer = build_scorer(captions_id, vocab.sos_id, vocab.eos_id)
    reward_gts = {**captions_id["train"], **captions_id["val"]}
    tables, fn2row = ciderd_device.build_tables(
        scorer, reward_gts, list(reward_gts), opt.max_seq_len,
        vocab.sos_id, vocab.eos_id, device=rt.device)
    print(f"====> CIDEr-D tables: {len(fn2row)} images, "
          f"{tables.df_h1.numel()} n-grams, {tables.nbytes()} bytes on "
          f"{rt.device}, built in {time.time() - t0:.2f} s")

    fc_store, att_store = (common.open_store(p)
                           for p in common.feature_paths(opt))
    senti_base = os.path.join(opt.feats_dir, "sentiment")
    senti_fc_store, senti_att_store = (
        common.open_store(common.sniff_store_path(
            os.path.join(senti_base, f"feats_{kind}.h5")))
        for kind in ("fc", "att"))

    bs = rt.round_bs(opt.rl_bs)
    fact_train = common.rl_fact_loader(fc_store, att_store,
                                       captions_id["train"], concepts_id,
                                       sentiments_id, vocab, opt, bs,
                                       fn2row=fn2row, seed=opt.seed)
    fact_val = common.rl_fact_loader(fc_store, att_store, captions_id["val"],
                                     concepts_id, sentiments_id, vocab, opt,
                                     bs, fn2row=fn2row, shuffle=False,
                                     drop_last=False)
    senti_loaders = {split: common.rl_senti_loader(
        senti_fc_store, senti_att_store, img_senti_labels[split],
        concepts_id, sentiments_id, label2idx, vocab, opt, bs,
        shuffle=(split == "train"), drop_last=(split == "train"),
        seed=opt.seed) for split in ("train", "test")}
    test_fns = sorted(captions_id["test"])
    scs_data = CycleIterator(common.scs_loader(scs_id, vocab, opt,
                                               rt.round_bs(SCS_BS),
                                               seed=opt.seed))
    # the shuffles, caption draws and seq2seq batches of the epochs before
    # a resume
    for _ in range(epoch0):
        for _ in range(opt.rl_senti_times):
            scs_data.skip(_replay(senti_loaders["train"]))
        for _ in range(opt.rl_fact_times):
            scs_data.skip(_replay(fact_train))
        _replay(fact_val)

    # the optional LM reward (off by default; the reference keeps it wired
    # but disabled, train_rl.py:212-216): per-sentiment id-form ARPA LMs
    lm_tables = None
    if opt.rl_lm_flag > 0.0:
        from ..ops import lm_device
        lm_dir = common.corpus_path(opt, "lm")
        paths = [os.path.join(lm_dir, f"{senti}_id.sri")
                 for senti in opt.sentiment_categories]
        for p in paths:
            if not os.path.exists(p):
                raise FileNotFoundError(
                    f"--rl_lm_flag set but LM missing: {p} (run the "
                    "preprocess lm stage)")
        lm_tables = lm_device.build_lm_tables(paths, len(vocab),
                                              device=rt.device)

    params = nn.tree_map(lambda t: t.requires_grad_(True),
                         mesh.replicate(rt.cast(params)))
    adam = optim.Adam(params, opt.rl_lrs.get("cap_lr", 4e-5), opt.grad_clip)
    if opt_state is not None:
        optim.load_optax_state(adam, opt_state)
        mesh.replicate([adam.mu, adam.nu])
    rt.place_captioner(adam)          # the model axis's shards, if any
    params = adam.params
    rl = steps.make_rl_steps(opt.settings, adam, ids, opt.max_seq_len,
                             tables, lm_tables=lm_tables,
                             lm_flag=opt.rl_lm_flag)
    serving = inference.make_serving_fn(opt.settings, ids,
                                        beam_size=opt.beam_size,
                                        max_seq_len=opt.max_seq_len)
    # the frozen detector inside the step in the precision of
    # --rl_detector_dtype (cast from the float32 params, whatever the
    # compute dtype: bf16 takes the Winograd kernels on the card); the
    # test dumps and checkpoints keep the compute-dtype copy
    frozen = steps.RLModels(
        senti_detector=(cast_bf16 if opt.rl_detector_dtype == "bf16"
                        else cast_f32)(senti_params),
        sent_senti_cls=rt.cast(cls_params))
    senti_params, cls_params = rt.cast(senti_params), frozen.sent_senti_cls

    def run_split(loader, data_type, training, epoch, use_scs, pass_idx=0):
        """A pass's mean of the global batches' train losses, or the eval
        pass's summed sums over summed counts (so padding rows add
        nothing; the eval step draws as one process does)."""
        phase = PHASES[data_type if training else "val"]
        agg, n, sums, cnts = {}, 0, {}, {}
        for i, b in enumerate(device_prefetch(
                loader.iterate(MAX_BATCHES_PER_EPOCH), rt.put)):
            gen = torch.Generator(device=rt.device).manual_seed(
                common.step_seed(opt.seed + 17, epoch, phase, pass_idx, i))
            if training:
                scs_b = rt.put(scs_data.next()) if use_scs else None
                losses = rl[(data_type, True)](frozen, b, scs_b, gen)
                for k, v in losses.items():   # summed on the device
                    agg[k] = agg.get(k, 0.0) + v.double()
                n += 1
            else:
                s, c = rl[(data_type, False)](frozen, b, gen)
                for k in s:
                    sums[k] = sums.get(k, 0.0) + s[k].double()
                    cnts[k] = cnts.get(k, 0.0) + c[k].double()
        if training:
            return {k: float(v) / max(n, 1) for k, v in agg.items()}
        return {k: float(sums[k]) / max(float(cnts[k]), 1.0) for k in sums}

    ck_dir, result_dir = common.stage_dirs(opt, "rl")
    for epoch in range(epoch0, opt.rl_epochs):
        print(f"--------------------epoch: {epoch}")
        for i in range(opt.rl_senti_times):
            print(f"----------rl_senti_times: {i}")
            loss = run_split(senti_loaders["train"], "senti", True, epoch,
                             True, pass_idx=i)
            print(f"senti_train_loss: {loss}")
        for i in range(opt.rl_fact_times):
            print(f"----------rl_fact_times: {i}")
            loss = run_split(fact_train, "fact", True, epoch, True,
                             pass_idx=i)
            print(f"fact_train_loss: {loss}")

        print("----------val")
        val_loss = run_split(fact_val, "fact", False, epoch, False)
        print(f"fact_val_loss: {val_loss}")

        # test: both splits through the serving path, grouped by the
        # detected sentiment (train_rl.py:252-309), on rank 0, on the
        # whole captioner (gathered by every rank)
        whole = mesh.gather_captioner(params, adam.shard)
        if mesh.rank() == 0:
            sparams = inference.ServingParams(
                captioner=nn.tree_map(torch.Tensor.detach, whole),
                senti_detector=senti_params)
            results, det_sentis, wrong_rate = run_test_dump(
                rt, opt, vocab, serving, sparams, test_fns, bs, fc_store,
                att_store, sentiments_id, senti_loaders["test"])
            dump_rl_results(result_dir, epoch, results, det_sentis,
                            wrong_rate, vocab)
            common.metrics_line(os.path.join(ck_dir, "metrics.jsonl"), {
                "epoch": epoch, "det_sentis_wrong_rate": wrong_rate,
                **{f"val_{k}": v for k, v in val_loss.items()}})
        mesh.barrier()                 # rank 0's dump and metrics
        ckpt.save(os.path.join(ck_dir, f"model_{epoch}.ckpt"),
                  {"captioner": whole, "senti_detector": senti_params,
                   "sent_senti_cls": cls_params},
                  optim.to_optax_state(adam), {
                      "epoch": epoch, "settings": opt.settings.to_dict(),
                      "idx2word": vocab.idx2word,
                      "max_seq_len": opt.max_seq_len,
                      "sentiment_categories": list(opt.sentiment_categories),
                      "dataset_name": opt.dataset_name,
                      "corpus_type": opt.corpus_type})
    return params


@torch.no_grad()
def run_test_dump(rt, opt, vocab, serving, sparams, test_fns, bs, fc_store,
                  att_store, sentiments_id, senti_test_loader):
    """Both test splits through the serving path, grouped by the detected
    sentiment, with the detected sentiment's wrong rate on the sentiment
    split (reference train_rl.py:252-281). Returns (results, det_sentis,
    wrong_rate) as ``dump_rl_results`` takes them."""
    results = {"fact": {}, "senti": {}}
    det_sentis = {"fact": {}, "senti": {}}
    senti_n = senti_wrong = 0
    for data_type in ("fact", "senti"):
        if data_type == "fact":
            batches = fact_test_batches(test_fns, bs, fc_store, att_store,
                                        sentiments_id, vocab, opt)
        else:
            batches = iter(senti_test_loader)
        for batch in batches:
            b = rt.put({k: v for k, v in batch.items()
                        if k in ("fc", "att", "sentis")})
            seqs, _, det_labels = serving(sparams, b["fc"], b["att"],
                                          b["sentis"])
            seqs = seqs.cpu().numpy()
            det_labels = det_labels.cpu().numpy()
            valid = batch.get("valid", len(batch["fns"]))
            for i, fn in enumerate(batch["fns"][:valid]):
                senti_name = opt.sentiment_categories[det_labels[i]]
                txt = vocab.decode_to_text(seqs[i, 0])
                results[data_type].setdefault(senti_name, []).append(
                    {"image_id": fn, "caption": txt})
                det_sentis[data_type][fn] = senti_name
                if data_type == "senti":
                    senti_n += 1
                    if det_labels[i] != batch["senti_labels"][i]:
                        senti_wrong += 1
    return results, det_sentis, senti_wrong / max(senti_n, 1)


def fact_test_batches(test_fns, bs, fc_store, att_store, sentiments_id,
                      vocab, opt):
    """The captioned test images in batches of ``bs``, the last padded with
    its last image (``valid`` its true rows)."""
    from ..data import collate
    for s in range(0, len(test_fns), bs):
        chunk = test_fns[s:s + bs]
        valid = len(chunk)
        fns = chunk + [chunk[-1]] * (bs - valid)
        yield {
            "fns": fns, "valid": valid,
            "fc": fc_store.batch(fns),
            "att": att_store.batch(fns),
            "sentis": np.stack([collate.pad_list(
                sentiments_id[fn], opt.num_sentiments, vocab.pad_id)
                for fn in fns]),
        }


def dump_rl_results(result_dir, epoch, results, det_sentis, wrong_rate,
                    vocab):
    """The per-sentiment result files in the reference's formats
    (train_rl.py:283-309): .json, the id form .txt (eval_cls_rnn's and
    eval_ppl's input) and the word form _w.txt, and each split's detected
    sentiments."""
    for data_type in results:
        for senti, ress in results[data_type].items():
            with open(os.path.join(
                    result_dir,
                    f"result_{epoch}_{senti}_{data_type}.json"), "w") as f:
                json.dump(ress, f)
            id_txt, w_txt = "", ""
            for res in ress:
                caption = res["caption"]
                w_txt += caption + "\n"
                id_cap = [str(vocab.word2idx[w]) for w in caption.split()]
                id_txt += " ".join(id_cap + [str(vocab.eos_id)]) + "\n"
            with open(os.path.join(
                    result_dir,
                    f"result_{epoch}_{senti}_{data_type}.txt"), "w") as f:
                f.write(id_txt)
            with open(os.path.join(
                    result_dir,
                    f"result_{epoch}_{senti}_{data_type}_w.txt"), "w") as f:
                f.write(w_txt)
        wr = 0 if data_type == "fact" else wrong_rate
        with open(os.path.join(
                result_dir,
                f"result_{epoch}_sentis_{wr}_{data_type}.json"), "w") as f:
            json.dump(det_sentis[data_type], f)


def main(argv=None):
    common.run_with_post_mortem(train, parse_opt(argv))


if __name__ == "__main__":
    main()
