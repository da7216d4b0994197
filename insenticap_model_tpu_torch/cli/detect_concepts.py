"""Concept detection over both feature stores (reference
detect_concepts.py): writes ``img_det_concepts.json``.

    python -m insenticap_model_tpu_torch.cli.detect_concepts \\
        -e CONCEPT_CKPT [--num_concepts 5] [--device cpu]

Counterpart of ``insenticap_model_tpu/cli/detect_concepts.py``: the
concept checkpoint's top ``num_concepts`` concept words for every image
of the dataset's fc store (``<feats_dir>/<ds>/<ds>_fc``) and of the
sentiment images' (``<feats_dir>/sentiment/feats_fc``), in chunks of
``BATCH`` images (the last padded by repeating its last image), written to
``<captions_dir>/<ds>/img_det_concepts.json`` ({fn: [word, ...]}), the
input of the XE and RL stages. Ties rank the lower concept index first,
as in the JAX package (``concept_detector.sample``).
"""
from __future__ import annotations

import json
import os

import torch

from ..config import Opts
from ..models import concept_detector as cpt_det
from . import common
from .opts import parse_opt

BATCH = 100  # reference detect_concepts.py:36


def load_concepts(rt: common.Runtime, path: str):
    """The concept checkpoint ``path`` -> (params in the compute dtype on
    the run's device, idx2concept, dataset name)."""
    print(f"====> loading checkpoint '{path}'")
    params, idx2concept, meta = common.load_concept_model(
        path, device=rt.device)
    dataset_name = meta.get("dataset_name", rt.opt.dataset_name)
    print(f"====> loaded checkpoint, epoch: {meta['epoch']}, "
          f"dataset_name: {dataset_name}")
    return rt.cast(params), idx2concept, dataset_name


def run(opt: Opts):
    rt = common.Runtime(opt)
    params, idx2concept, dataset_name = load_concepts(rt, opt.eval_model)
    stores = [common.open_store(common.sniff_store_path(os.path.join(
        opt.feats_dir, dataset_name, f"{dataset_name}_fc.h5"))),
        common.open_store(common.sniff_store_path(os.path.join(
            opt.feats_dir, "sentiment", "feats_fc.h5")))]

    predict = {}
    with torch.no_grad():
        for store in stores:
            fns = store.keys()
            for s in range(0, len(fns), BATCH):
                chunk = fns[s:s + BATCH]
                padded = chunk + [chunk[-1]] * (BATCH - len(chunk))
                fc = rt.put({"fc": store.batch(padded)})["fc"]
                _, top_idx, _ = cpt_det.sample(params, fc, opt.num_concepts)
                top_idx = top_idx.cpu().numpy()
                for j, fn in enumerate(chunk):
                    predict[fn] = [idx2concept[k] for k in top_idx[j]]

    out = os.path.join(opt.captions_dir, dataset_name,
                       "img_det_concepts.json")
    with open(out, "w") as f:
        json.dump(predict, f)
    print(f"====> wrote {len(predict)} entries to {out}")
    return predict


def main(argv=None):
    run(parse_opt(argv))


if __name__ == "__main__":
    main()
