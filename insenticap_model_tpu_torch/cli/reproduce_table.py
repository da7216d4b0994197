"""The paper table in one command, on the card: from the artefacts and a
trained (or converted reference) RL composite checkpoint to the §6 results
table (reference README.md:29-36).

    python -m insenticap_model_tpu_torch.cli.reproduce_table \\
        --rl_model DETECTOR.ckpt|.pth [--dataset_name coco] \\
        [--corpus_type part] [--tag repro] [--beam_size 3] [--rl_bs 40] \\
        [--anno_file F] [--out result/repro_table.json] [--device cpu] \\
        [--mesh_shape '[n]']

Counterpart of ``insenticap_model_tpu/cli/reproduce_table.py``: load the
composite (either package's ``.ckpt``, or the reference's ``.pth``
converted in memory by ``convert.detector_from_torch``), decode both test
splits through the serving path (``cli/train_rl.run_test_dump``: the
detector, then the beam search, which runs the beam-shared attention
kernel on the card, and the Winograd kernels for a bf16 detector), write
the RL stage's result files, and score them: ``eval_metrics`` (BLEU,
METEOR*, CIDEr-D, on the host), ``eval_cls_rnn`` (cls%, the frozen
sentence classifier on the device) and ``eval_ppl`` (ppl against the
per-sentiment trigram LMs, a subprocess); then print the table and write
it as JSON. The cls and ppl columns are null where their inputs (the
classifier checkpoint or the composite's metadata, the LM files) are
absent, as in the JAX CLI. The params are cast to the run's compute
dtype (``Opts.compute_dtype``). ``--mesh_shape [n]`` decodes in this one
process on n devices of ``--device`` (``Runtime(opt, serving=True)``):
the captioner and the detector replicated, each test batch (``rl_bs``
rounded up to a multiple of n) split over the devices by the sharded
serving function, every device running the kernels on its block; the
dump, the metrics and the table are the one-device run's. (The JAX CLI
replicates over its mesh too, and keeps its Pallas calls off a sharded
decode, which the port's per-device blocks do not need.)
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from .. import convert, inference
from ..config import Opts, Settings
from ..training import checkpoint as ckpt
from ..vocab import Vocab
from . import common
from .train_rl import PARTS, dump_rl_results, run_test_dump

SENTIS = ("positive", "negative", "neutral")


def load_composite(path: str, device="cuda"):
    """(composite params on ``device``, metadata dict) from either
    package's ``.ckpt`` (written by train_rl or ``convert_checkpoint
    detector``) or the reference's raw ``.pth`` (converted in memory)."""
    if path.endswith(".pth"):
        blob = torch.load(path, map_location="cpu")
        sd = blob["model"] if "model" in blob else blob
        composite = convert.detector_from_torch(sd, device=device)
        meta = {k: blob[k] for k in
                ("settings", "idx2word", "sentiment_categories",
                 "dataset_name", "corpus_type", "max_seq_len")
                if k in blob}
        meta.setdefault("epoch", blob.get("epoch", -1))
        return composite, meta
    composite, meta = ckpt.load(path, device=device)
    if not isinstance(composite, dict) or set(composite) != set(PARTS):
        raise ckpt.CheckpointError(
            f"{path}: not an RL composite checkpoint (parts "
            f"{sorted(composite)} != {sorted(PARTS)})")
    return composite, meta


def _materialize_cls_checkpoint(opt: Opts, composite, meta,
                                out_dir: str) -> str:
    """eval_cls_rnn reads the classifier from a checkpoint tree; where the
    run has only the composite (a converted reference .pth, say), its
    frozen classifier is written out as a model-best, so that cls% can
    still be computed (the reference's eval_cls_rnn.py:22 reads a best
    path the user makes by hand)."""
    d = common.ensure_dir(os.path.join(out_dir, "sent_senti_cls",
                                       opt.dataset_name, opt.corpus_type))
    path = os.path.join(d, "model-best.ckpt")
    ckpt.save(path, composite["sent_senti_cls"], None, {
        "epoch": meta.get("epoch", -1),
        "settings": meta["settings"] if isinstance(meta["settings"], dict)
        else meta["settings"].to_dict(),
        "idx2word": meta["idx2word"],
        "sentiment_categories": list(meta["sentiment_categories"]),
        "dataset_name": opt.dataset_name, "corpus_type": opt.corpus_type})
    return out_dir


def _decode_test_splits(opt: Opts, rt, composite, meta, settings, vocab,
                        ids, label2idx):
    """Both test splits through the serving path on ``rt``'s device or
    mesh: ``run_test_dump``'s (results, det_sentis, wrong_rate)."""
    # artefacts and stores (the inputs the RL test dump reads)
    img_captions = common.load_json(
        common.dataset_path(opt, "img_captions.json"))
    img_det_concepts = common.load_json(
        common.dataset_path(opt, "img_det_concepts.json"))
    img_det_sentiments = common.load_json(
        common.corpus_path(opt, "img_det_sentiments.json"))
    img_senti_labels = common.load_json(opt.img_senti_labels)
    concepts_id = common.tokenize_concepts(img_det_concepts, vocab)
    sentiments_id = common.tokenize_sentiments(img_det_sentiments, vocab)
    captions_id = common.tokenize_captions(img_captions, vocab)
    test_fns = sorted(captions_id["test"])

    fc_store, att_store = (common.open_store(p)
                           for p in common.feature_paths(opt))
    senti_base = os.path.join(opt.feats_dir, "sentiment")
    senti_fc, senti_att = (
        common.open_store(common.sniff_store_path(
            os.path.join(senti_base, f"feats_{kind}.h5")))
        for kind in ("fc", "att"))

    bs = rt.round_bs(opt.rl_bs)
    senti_test = common.rl_senti_loader(
        senti_fc, senti_att, img_senti_labels["test"], concepts_id,
        sentiments_id, label2idx, vocab, opt, bs, shuffle=False,
        drop_last=False)

    max_seq_len = meta.get("max_seq_len", opt.max_seq_len)
    if rt.mesh is None:
        serving = inference.make_serving_fn(
            settings, ids, beam_size=opt.beam_size, max_seq_len=max_seq_len)
    else:
        serving = inference.make_sharded_serving_fn(
            rt.mesh, settings, ids, beam_size=opt.beam_size,
            max_seq_len=max_seq_len)
    sparams = rt.replicate(inference.ServingParams(
        captioner=rt.cast(composite["captioner"]),
        senti_detector=rt.cast(composite["senti_detector"])))

    print("====> decoding test splits")
    return run_test_dump(rt, opt, vocab, serving, sparams, test_fns, bs,
                         fc_store, att_store, sentiments_id, senti_test)


def reproduce(opt: Opts, rl_model: str, tag: str = "repro",
              anno_file: str = "", out: str = "") -> dict:
    common.serving_world()         # one process only: refused before the load
    composite, meta = load_composite(rl_model, device=opt.device)
    if "settings" in meta and not isinstance(meta["settings"], dict):
        meta["settings"] = meta["settings"].to_dict()
    settings = Settings.from_dict(meta["settings"]) \
        if "settings" in meta else opt.settings
    opt.settings = settings
    vocab = Vocab(meta["idx2word"]) if "idx2word" in meta \
        else common.load_vocab(opt)
    cats = list(meta.get("sentiment_categories",
                         opt.sentiment_categories))
    opt.sentiment_categories = cats
    ids = common.token_ids(vocab, cats)
    label2idx = {w: i for i, w in enumerate(cats)}

    rt = common.Runtime(opt, serving=True)
    try:
        results, det_sentis, wrong_rate = _decode_test_splits(
            opt, rt, composite, meta, settings, vocab, ids, label2idx)
    finally:
        rt.close()
    _, result_dir = common.stage_dirs(opt, "rl")
    dump_rl_results(result_dir, tag, results, det_sentis, wrong_rate, vocab)
    prefix = os.path.join(result_dir, f"result_{tag}")
    print(f"====> dumps at {prefix}_* (det-senti wrong rate "
          f"{wrong_rate:.4f})")

    table: dict = {"det_sentis_wrong_rate": wrong_rate, "splits": {}}
    from .eval_cls_rnn import compute_cls
    from .eval_metrics import compute_metrics
    from .eval_ppl import LM_PATH, compute_ppl

    # the classifier's source is the same for both splits; a bare state
    # dict without metadata makes cls null rather than stopping the run
    cls_dir = opt.checkpoint
    try:
        common.best_checkpoint(opt, "sent_senti_cls")
    except FileNotFoundError:
        # what is missing is named here, so that a fault inside the
        # write below is never reported as missing metadata
        needed = [k for k in ("settings", "idx2word",
                              "sentiment_categories") if k not in meta]
        if "sent_senti_cls" not in composite:
            needed.append("sent_senti_cls (composite)")
        if needed:
            print(f"====> cls unavailable: no ss-cls checkpoint and the "
                  f"composite lacks {needed}")
            cls_dir = None
        else:
            cls_dir = _materialize_cls_checkpoint(
                opt, composite, meta,
                os.path.join(result_dir, "_repro_ckpt"))

    for data_type in ("fact", "senti"):
        print(f"====> metrics [{data_type}]")
        quality = compute_metrics(prefix, data_type, anno_file)

        try:
            cls = None if cls_dir is None \
                else compute_cls(prefix, data_type, cls_dir,
                                 device=opt.device)
        except Exception as e:  # reported, and the column left null
            print(f"====> cls skipped [{data_type}]: {e}")
            cls = None

        lm_probe = LM_PATH % (opt.dataset_name, opt.corpus_type,
                              "neutral")
        if os.path.exists(lm_probe):
            try:
                ppl = compute_ppl(prefix, data_type)
            except Exception as e:
                print(f"====> ppl skipped [{data_type}]: {e}")
                ppl = None
        else:
            print(f"====> ppl skipped [{data_type}]: no LM at {lm_probe} "
                  "(run the preprocess lms stage)")
            ppl = None
        table["splits"][data_type] = {"quality": quality, "cls": cls,
                                      "ppl": ppl}

    _print_section6(table)
    if out:
        common.ensure_dir(os.path.dirname(os.path.abspath(out)))
        with open(out, "w") as f:
            json.dump(table, f, indent=1)
        print(f"====> wrote {out}")
    return table


def _print_section6(table: dict) -> None:
    """README.md:29-36's shape: a row a metric, a column a sentiment (the
    senti split carries positive/negative, fact carries neutral: the
    paper's SentiCap/COCO convention)."""
    for data_type, d in table["splits"].items():
        sentis = sorted(d["quality"])
        if not sentis:
            continue
        # METEOR* (never interchangeable with coco-caption METEOR, see
        # rewards/meteor.py); "METEOR" only in tables of older builds
        meteor_col = ("METEOR" if "METEOR" in d["quality"][sentis[0]]
                      else "METEOR*")
        rows = ("Bleu-1", "Bleu-3", meteor_col, "CIDEr-D", "ppl", "cls(%)")
        print(f"\n== §6 table [{data_type} split] ==")
        print("| Metric | " + " | ".join(sentis) + " |")
        print("|---" * (len(sentis) + 1) + "|")
        for m in rows:
            cells = []
            for s in sentis:
                if m == "ppl":
                    v = (d["ppl"] or {}).get(s)
                elif m == "cls(%)":
                    v = None if d["cls"] is None \
                        else d["cls"].get(s, None)
                    v = v * 100 if v is not None else None
                else:
                    v = d["quality"][s].get(m)
                cells.append("-" if v is None else f"{v:.1f}")
            print(f"| {m} | " + " | ".join(cells) + " |")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--rl_model", required=True,
                   help="composite Detector checkpoint (.ckpt or "
                        "reference .pth)")
    p.add_argument("--dataset_name", default="coco")
    p.add_argument("--corpus_type", default="part")
    p.add_argument("--tag", default="repro")
    p.add_argument("--beam_size", type=int, default=3)
    p.add_argument("--rl_bs", type=int, default=40)
    p.add_argument("--anno_file", default="")
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda",
                   help="the port's device: cuda (default; refused where "
                        "CUDA is absent) or cpu")
    p.add_argument("--mesh_shape", default="",
                   help="e.g. '[2]': decode in this process on n devices "
                        "of --device (rl_bs rounds up to a multiple of n)")
    return p


def main(argv=None):
    a = build_parser().parse_args(argv)
    opt = Opts(dataset_name=a.dataset_name, corpus_type=a.corpus_type,
               beam_size=a.beam_size, rl_bs=a.rl_bs, device=a.device,
               mesh_shape=tuple(json.loads(a.mesh_shape))
               if a.mesh_shape else ())
    reproduce(opt, a.rl_model, tag=a.tag, anno_file=a.anno_file,
              out=a.out)


if __name__ == "__main__":
    main()
