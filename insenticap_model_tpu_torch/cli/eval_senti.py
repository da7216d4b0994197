"""Sentiment-detector threshold sweep on the hand-labeled subset (reference
eval_senti.py) on the card.

    python -m insenticap_model_tpu_torch.cli.eval_senti \\
        --rl_senti_resume DETECTOR_CKPT [--feats_dir DIR] [--device cpu]

Counterpart of ``insenticap_model_tpu/cli/eval_senti.py``: the detector of
``--rl_senti_resume`` (a file of either package; either detector variant,
as its settings select) labels the COCO images of
``./data/labeled_data/at_most_one_disagree.json`` ({sentiment: [file
name, ...]}) from the ``.isc`` att store; then, for the thresholds 0..1 in
steps of 0.1, each sentiment's accuracy and the overall accuracy, and for
0..0.9 each predicted class's precision and counts, line for line the JAX
CLI's print-out. The detector runs in float32, where it takes the direct
convolution (as in the JAX package; ``nn.conv2d`` keeps TF32 off on the
card).
"""
from __future__ import annotations

import os
from collections import defaultdict

import numpy as np
import torch

from ..config import Opts, Settings
from ..models import sentiment_detector as senti_det
from ..training import checkpoint as ckpt
from ..utils.dtypes import resolve_device
from . import common
from .opts import parse_opt

LABELED_FILE = "./data/labeled_data/at_most_one_disagree.json"


@torch.no_grad()
def run(opt: Opts):
    dev = resolve_device(opt.device)
    labeled = common.load_json(LABELED_FILE)
    print(f"====> loading rl_senti_resume '{opt.rl_senti_resume}'")
    params, meta = ckpt.load(opt.rl_senti_resume, device=dev,
                             dtype=torch.float32)
    if "senti_conv" not in params:
        raise ckpt.CheckpointError(f"{opt.rl_senti_resume}: not a sentiment "
                                   f"detector (keys {sorted(params)})")
    settings = Settings.from_dict(meta["settings"])
    cats = meta["sentiment_categories"]
    neu_idx = cats.index("neutral")

    att_store = common.open_store(common.sniff_store_path(os.path.join(
        opt.feats_dir, "coco", "coco_att.h5")))
    module = senti_det.module_for(settings)

    evals = {}
    for senti, fns in labeled.items():
        att = torch.from_numpy(att_store.batch(fns).astype(np.float32))
        # threshold applied on the host per sweep value
        preds, _, scores = module.sample(params, att.to(dev), 0.0, neu_idx)
        evals[senti] = (preds.cpu().numpy(), scores.cpu().numpy(),
                        np.full(len(fns), cats.index(senti)))

    for t in range(11):
        thr = t / 10
        print("THRESHOLD:", thr)
        all_n = all_cor = 0
        for senti, (preds, scores, labels) in evals.items():
            p = np.where(scores < thr, neu_idx, preds)
            cor = int((p == labels).sum())
            print(f"{senti} accuracy: {cor / len(p)}")
            all_n += len(p)
            all_cor += cor
        print("all accuracy:", all_cor / all_n)

    for t in range(10):
        thr = t / 10
        print("THRESHOLD:", thr)
        num = defaultdict(int)
        cor = defaultdict(int)
        for senti, (preds, scores, labels) in evals.items():
            p = np.where(scores < thr, neu_idx, preds)
            for idx in range(len(cats)):
                num[idx] += int((p == idx).sum())
            lab = int(labels[0])
            cor[lab] += int((p == lab).sum())
        for sid in num:
            print(f"{cats[sid]} precision: {cor[sid] / (num[sid] + 1e-9)}")
        print("all precision:",
              sum(cor.values()) / max(sum(num.values()), 1))
        for sid in num:
            print(f"{cats[sid]} all num: {num[sid]}, cor num: {cor[sid]}")
    return evals


def main(argv=None):
    run(parse_opt(argv))


if __name__ == "__main__":
    main()
