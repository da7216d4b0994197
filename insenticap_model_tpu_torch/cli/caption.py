"""Single-command serving: caption image files end to end, on the card.

Counterpart of ``insenticap_model_tpu/cli/caption.py`` (:43-174): the full
inference DAG in one process,

    raw image -> ResNet-101 (fc, att)
              -> concept detector (top-k concept words)
              -> noun -> sentiment-word table (ranked sentiment words)
              -> image sentiment detector (or a forced label)
              -> sentiment-conditioned batched beam search

    python -m insenticap_model_tpu_torch.cli.caption -i img1.jpg img2.png \\
        --rl_model rl.ckpt --concept_model concept.ckpt \\
        --resnet101_ckpt resnet101.ckpt \\
        [--sentiment auto|positive|negative|neutral] [--beam_size 3] \\
        [--dump_attention DIR] [--device cpu]

Prints one JSON line per image: {"image", "sentiment", "caption", "score"}
(+ "attention": the .npz path with ``--dump_attention``). Images keep their
own size (the exact-shape float path, ``encoder.preprocess`` +
``forward_batch``), grouped by shape into one encoder call each. Decoding is
the port's own (``preprocessing.load_image``, no PIL). ``--device`` is the
one flag the JAX command lacks: ``cuda`` by default, ``cpu`` for the plain
PyTorch versions.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .. import inference, preprocessing
from ..config import Settings
from ..models import concept_detector as cpt_det
from ..models import encoder as enc
from ..training import checkpoint as ckpt
from ..utils.dtypes import resolve_device
from ..vocab import Vocab
from . import common


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("-i", "--images", nargs="+", required=True)
    p.add_argument("--rl_model", type=str, required=True,
                   help="composite RL checkpoint (captioner + detectors)")
    p.add_argument("--concept_model", type=str, required=True)
    p.add_argument("--resnet101_ckpt", type=str, required=True,
                   help="converted encoder checkpoint "
                        "(convert_checkpoint.py resnet101 ...)")
    p.add_argument("--sentiment_detector_json", type=str,
                   default="./data/corpus/part/sentiment_detector.json")
    p.add_argument("--sentiment", type=str, default="auto",
                   choices=["auto", "positive", "negative", "neutral"])
    p.add_argument("--beam_size", type=int, default=3)
    p.add_argument("--max_seq_len", type=int, default=16)
    p.add_argument("--num_concepts", type=int, default=5)
    p.add_argument("--num_sentiments", type=int, default=10)
    p.add_argument("--dump_attention", type=str, default="",
                   help="directory: write per-image .npz with the decode-"
                        "time attention weights per generated word (14x14 "
                        "content map; senti/fuse weights in auto mode)")
    p.add_argument("--device", type=str, default="cuda",
                   help="the port's device: cuda (default; refused where "
                        "CUDA is absent) or cpu (the plain PyTorch "
                        "versions of every kernel)")
    return p


def load_models(a, device):
    """The checkpoints on ``device``: (settings, vocab, cats, captioner,
    detector, concept params, idx2concept, encoder params)."""
    meta = ckpt.load_metadata(a.rl_model)
    if meta.get("idx2word") is None:
        raise ckpt.CheckpointError(f"{a.rl_model}: no idx2word in metadata")
    loaded, meta = ckpt.load(a.rl_model, device=device)
    for part in ("captioner", "senti_detector"):
        if part not in loaded:
            raise ckpt.CheckpointError(f"{a.rl_model}: no {part} in the "
                                       "tree")
    settings = Settings.from_dict(meta["settings"])
    vocab = Vocab(meta["idx2word"])
    cats = meta["sentiment_categories"]
    cpt_params, idx2concept, _ = common.load_concept_model(
        a.concept_model, device=device)
    enc_params, _ = ckpt.load(a.resnet101_ckpt, device=device)
    return (settings, vocab, cats, loaded["captioner"],
            loaded["senti_detector"], cpt_params, idx2concept, enc_params)


def run(a) -> list:
    device = resolve_device(a.device)
    (settings, vocab, cats, cap_params, senti_params, cpt_params,
     idx2concept, enc_params) = load_models(a, device)
    ids = common.token_ids(vocab, cats)
    senti_table = common.load_json(a.sentiment_detector_json)

    dump_att = bool(a.dump_attention)
    serve = inference.make_serving_fn(settings, ids, a.beam_size,
                                      a.max_seq_len,
                                      return_weights=dump_att)
    serve_forced = inference.make_forced_serving_fn(
        settings, ids, a.beam_size, a.max_seq_len,
        return_weights=dump_att)
    if dump_att:
        os.makedirs(a.dump_attention, exist_ok=True)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    # one encoder call per distinct image shape
    feats = {}
    buckets = {}
    with torch.no_grad():
        for path in a.images:
            x = enc.preprocess(preprocessing.load_image(path))
            buckets.setdefault(x.shape, []).append((path, x))
        for shape, group in buckets.items():
            fc, att = enc.forward_batch(enc_params,
                                        dev(np.stack([x for _, x in group])))
            for i, (path, _) in enumerate(group):
                feats[path] = (fc[i:i + 1], att[i:i + 1])

        results = []
        for path in a.images:
            fc, att = feats[path]
            _, top_idx, _ = cpt_det.sample(cpt_params, fc, a.num_concepts)
            concepts = [idx2concept[k] for k in top_idx[0].tolist()]
            sentis = dev(common.senti_word_ids(
                concepts, senti_table, vocab, a.num_sentiments)[None])

            weights = None
            if a.sentiment == "auto":
                sparams = inference.ServingParams(
                    captioner=cap_params, senti_detector=senti_params)
                out = serve(sparams, fc, att, sentis)
                seqs, scores, labels = out[:3]
                weights = out[3] if dump_att else None
                label = int(labels[0])
            else:
                label = cats.index(a.sentiment)
                out = serve_forced(
                    cap_params, fc, att, sentis,
                    torch.full((1,), label, dtype=torch.int32,
                               device=device))
                seqs, scores = out[:2]
                weights = out[2] if dump_att else None
            top = seqs[0, 0].cpu().numpy()
            rec = {"image": os.path.basename(path),
                   "sentiment": cats[label],
                   "caption": vocab.decode_to_text(top),
                   "score": float(scores[0, 0])}
            if dump_att:
                # one attention map per generated word of the top candidate
                tokens = [int(t) for t in top]
                n_words = next((i for i, t in enumerate(tokens)
                                if t == vocab.eos_id), len(tokens))
                dump = {"tokens": np.asarray(tokens[:n_words], np.int32),
                        "words": np.asarray(
                            [vocab.idx2word[t] for t in tokens[:n_words]])}
                for key, arr in weights.items():
                    w = arr[0, 0, :n_words].float().cpu().numpy()
                    if key == "cont":
                        w = w.reshape(n_words, 14, 14)
                    dump[key] = w
                out_path = os.path.join(
                    a.dump_attention,
                    os.path.splitext(os.path.basename(path))[0]
                    + "_att.npz")
                np.savez(out_path, **dump)
                rec["attention"] = out_path
            results.append(rec)
            print(json.dumps(rec))
    return results


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
