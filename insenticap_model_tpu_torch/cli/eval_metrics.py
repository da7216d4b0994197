"""Caption-quality metrics table: BLEU-1..4, METEOR* and CIDEr-D per
sentiment, on the host (the port's copy of
``insenticap_model_tpu/cli/eval_metrics.py``).

Scores the RL stage's per-sentiment result files against the
anno_captions.json ground truth in the shape of the reference README's
results table (reference README.md:29-36; SURVEY.md §6), with the port's
tokenizer (``text.tokenize``) and scorers (``rewards/bleu``,
``rewards/ciderd``, ``rewards/meteor``): the same table and the same dict
as the JAX CLI. No tensor work: it runs on the host wherever it runs.

    python -m insenticap_model_tpu_torch.cli.eval_metrics PREFIX DATA_TYPE \\
        [ANNO_FILE]
    e.g. ... result/rl/coco/part/result_29 fact
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

from .. import text
from ..rewards.bleu import Bleu
from ..rewards.ciderd import CiderD
from ..rewards.meteor import Meteor

SENTIS = ["positive", "negative", "neutral"]


def _tok(s: str) -> tuple:
    return tuple(text.tokenize(s.strip().lower()))


def compute_metrics(result_prefix: str, data_type: str,
                    anno_file: str = "") -> Dict[str, Dict[str, float]]:
    dataset_name = "flickr30k" if "flickr30k" in result_prefix else "coco"
    if not anno_file:
        anno_file = os.path.join("./data/captions", dataset_name,
                                 "anno_captions.json")
    with open(anno_file) as f:
        anno = {fn: [_tok(s) for s in sents]
                for fn, sents in json.load(f).items()}

    table: Dict[str, Dict[str, float]] = {}
    # loop-invariant but lazily built: constructing Meteor parses the
    # WordNet index files, pointless when no result file exists
    meteor = None
    for senti in SENTIS:
        path = f"{result_prefix}_{senti}_{data_type}.json"
        if not os.path.exists(path):
            continue
        if meteor is None:
            meteor = Meteor()
        with open(path) as f:
            results = json.load(f)
        gts: Dict[str, List[tuple]] = {}
        res = []
        for r in results:
            fn = r["image_id"]
            if fn not in anno:
                continue
            gts[fn] = anno[fn]
            res.append({"image_id": fn, "caption": [_tok(r["caption"])]})
        if not res:
            continue

        bleu, _ = Bleu(4).compute_score(gts, res)
        cider = CiderD(refs=list(gts.values()))
        c_score, _ = cider.compute_score(gts, res)
        m_score, _ = meteor.compute_score(gts, res)
        table[senti] = {
            "Bleu-1": bleu[0] * 100, "Bleu-2": bleu[1] * 100,
            "Bleu-3": bleu[2] * 100, "Bleu-4": bleu[3] * 100,
            # always "METEOR*": paraphrase stage absent + stand-in
            # function words — not interchangeable with coco-caption
            # METEOR (meteor.mode says which stages were active)
            meteor.name: m_score * 100,
            "CIDEr-D": c_score * 100, "n": len(res),
        }

    meteor_col = meteor.name if meteor is not None else "METEOR*"
    metrics = ["Bleu-1", "Bleu-2", "Bleu-3", "Bleu-4", meteor_col,
               "CIDEr-D"]
    header = "Metric    " + "".join(f"{s:>12}" for s in table)
    print(header)
    for m in metrics:
        print(f"{m:<10}" + "".join(f"{table[s][m]:>12.1f}" for s in table))
    print("n         " + "".join(f"{int(table[s]['n']):>12}"
                                 for s in table))
    if meteor is not None:
        print(f"# METEOR* is NOT coco-caption METEOR ({meteor.mode})")
    return table


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("result_prefix")
    p.add_argument("data_type")
    p.add_argument("anno_file", nargs="?", default="")
    a = p.parse_args(argv)
    compute_metrics(a.result_prefix, a.data_type, a.anno_file)


if __name__ == "__main__":
    main()
